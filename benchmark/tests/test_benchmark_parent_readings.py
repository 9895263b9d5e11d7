"""The harness reads what it read before the model moved behind
architectures/<model_type>.py, bit for bit.

data/parent_readings.json was recorded on the CPU by the harness as it
stood before that move (harness.spec.dims_of, harness.program.build,
reference.model.Reference, harness.work's attention / head /
token_overhead called directly): for the tiny configurations at seeds 3
and 11, the sha256 of every raw block, the embeddings, the head, each
gate and the rms profiles; the reference's logits, kv_err and work log
on two teacher-forced items, with the keys and values that the port's
plain route wrote for them; and the work counts over a grid of
arguments, with the shapes, for the tiny and the benchmark's own
configurations. Here the same readings come through the architecture
module that each configuration's model_type names."""

import dataclasses
import hashlib
import json
import types

import pytest
import torch

from harness import spec
from harness.readings import WorkLog
from support import BENCH, DATA, REPO

from effort_tpu_torch.models.transformer import forward_token, \
    make_kv_cache

PARENT = json.loads((DATA / "parent_readings.json").read_text())
MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _sha(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _config(name: str) -> tuple:
    """(configuration file, its architecture's module)."""
    path = DATA / f"{name}.json"
    if not path.is_file():
        path = BENCH / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text())
    return cfg, spec.Manifest(REPO).module("architectures",
                                           cfg["model_type"])


def _items(vocab: int) -> list:
    g = torch.Generator().manual_seed(9)
    return [torch.randint(3, vocab, (n,), generator=g).tolist()
            for n in PARENT["item_lens"]]


@pytest.mark.parametrize("name", sorted(PARENT["dims"]))
def test_shapes_and_work_counts_are_the_parents(name):
    cfg, arch = _config(name)
    d = arch.dims(cfg)
    assert dataclasses.asdict(d) == PARENT["dims"][name]
    want = PARENT["work"][name]

    def wd(w):
        return [w.bytes, w.flops]
    got = {
        "attention_step": [[p, wd(arch.attention(p, p, 1, d))]
                           for p in PARENT["grid_step"]],
        "attention_admit": [[n, wd(arch.attention(n * (n + 1) // 2, n, n,
                                                  d))]
                            for n in PARENT["grid_step"]],
        "head": [[t, wd(arch.head(d, t))] for t in PARENT["grid_t"]],
        "token_overhead": [[t, wd(arch.token_overhead(d, t))]
                           for t in PARENT["grid_t"]]}
    assert got == want


@pytest.mark.parametrize("key", sorted(PARENT["models"]))
def test_raw_weights_reference_and_work_log_are_the_parents(key):
    name, seed = key.split("/")
    cfg, arch = _config(name)
    d = arch.dims(cfg)
    b = cfg["bucket"]
    want = PARENT["models"][key]
    w, port_cfg, src = arch.build(name, d, b, int(seed), "cpu")

    raw = {n: [_sha(src.block(n, i)) for i in range(src.n_inst(n))]
           for n in MATRICES}
    raw.update(tok_embeddings=_sha(src.embeddings()), output=_sha(src.head()),
               rms_m=_sha(src.rms_m), rms_f=_sha(src.rms_f))
    if "ffn_gate" in want["raw"]:
        raw["ffn_gate"] = [_sha(src.gate(l)) for l in range(d.n_layers)]
    assert raw == want["raw"]

    seqs = _items(d.vocab)
    state = []
    with torch.no_grad():
        for seq in seqs:
            kc, vc = make_kv_cache(port_cfg, "cpu")
            for p, t in enumerate(seq):
                forward_token(w, port_cfg, t, p, kc, vc, effort=0.25,
                              impl="plain")
            owner = types.SimpleNamespace(k_cache=kc, v_cache=vc)
            state.append(tuple(x.clone() for x in arch.state_of(
                owner, None, 0, len(seq))))
    assert [_sha(*s) for s in state] == want["state"]
    assert [(tuple(x.shape), x.dtype) for x in state[0]] == [
        (tuple(s), dt) for s, dt in arch.state_shapes(d, len(seqs[0]))]

    ref = arch.Reference(src, d, probes=b["probes"],
                         base_rows=b["chunk_rows"])
    for (effort, tau), run in zip(PARENT["runs"], want["runs"]):
        log, kv_err = WorkLog(), []
        with torch.no_grad():
            lg = ref.forward(seqs, PARENT["want"], effort, tau, log, state,
                             kv_err)
        assert [_sha(x) for x in lg] == run["logits"], (effort, tau)
        assert [_sha(x) for x in kv_err] == run["kv_err"]
        assert _sha(*[t for e in log.entries for t in (e[2], e[3])]) \
            == run["work_log"]
        assert [[e[0], e[1], e[4], e[5]] for e in log.entries] \
            == run["work_log_dims"]
