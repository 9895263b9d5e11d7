"""The port's checkpoint path held against the JAX package's on
tiny_test_model: HF config -> ModelConfig, HF safetensors -> bucketized
checkpoint (convert_checkpoint on device="cpu"), loading (load_bucketized,
truncated and with or without the dense copies), calibration
(collect_act_rms), HF -> convert -> load -> Engine.generate, and the
server's --ckpt/--tokenizer.

Tolerances: every tensor of a conversion byte for byte, except the stats
(f32 means over a bucket row: the two frameworks sum in another order, so
the last bit may move; rtol 1e-6, as tests/test_torch_ops.py admits for
bucketize) and, for int4, the quantile scales (rtol 1e-6) and the codes
(at most INT4_TIES_ALLOWED a matrix differ, by one, at a rounding tie;
the count is printed). Loading JAX's conversion: every field equal.
Calibration: 1e-5 relative. Generation: the same greedy tokens.
"""

import asyncio
import dataclasses
import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.convert import calibrate as jax_calibrate
from effort_tpu.convert import convert as jax_convert
from effort_tpu.models import weights as jax_weights
from effort_tpu.models.generate import Engine as JaxEngine
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.convert import calibrate as port_calibrate
from effort_tpu_torch.convert import convert as port_convert
from effort_tpu_torch.models import weights as port_weights
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.ops.layouts import META_FIELDS, TENSOR_FIELDS
from effort_tpu_torch.runtime.safetensors_io import (MultiShardReader,
                                                     SafeTensorWriter)
from effort_tpu_torch.runtime.tokenizer import (Tokenizer,
                                                mistral_instruct_prompt)
from effort_tpu_torch.serving import server as port_server
from test_torch_bridge import jax_weights_to_numpy, torch_np
from test_torch_ops import INT4_TIES_ALLOWED
from test_torch_tokenizer import write_bpe_json

torch.set_num_threads(2)

PAD = 8
PROMPT = [1, 5, 9]
QUIET = dict(progress=lambda *a: None)


@dataclasses.dataclass(frozen=True)
class Case:
    """One conversion: HF family, bucket layout and converter options."""
    family: str
    dtype: str
    B: int
    fuse: bool = True
    calib: str = "mf"        # "" none, "m" rms_m only, "mf" both
    core: bool = False
    tied: bool = False       # no lm_head: the output head is the embedding
    bf16_src: bool = False   # the HF tensors stored as BF16

    @property
    def n_experts(self) -> int:
        return 4 if self.family == "mixtral" else 1

    @property
    def id(self) -> str:
        return "-".join([self.family, self.dtype, f"B{self.B}"]
                        + [k for k in ("fuse", "core", "tied", "bf16_src")
                           if getattr(self, k)]
                        + ([f"calib_{self.calib}"] if self.calib else []))


CASES = [
    Case("mistral", "bf16", 4, core=True),
    Case("mistral", "int8", 1, core=True, bf16_src=True),
    Case("mistral", "int8", 1, calib="", core=True),
    Case("mistral", "int4", 4, fuse=False, calib="", tied=True),
    Case("mistral", "int4", 1),
    Case("mixtral", "bf16", 4, core=True),
    Case("llama", "int8", 4, fuse=False, calib="m"),
]
BY_ID = {c.id: c for c in CASES}


def _cfgs(case: Case):
    kw = dict(n_experts=case.n_experts)
    return tiny_test_model(**kw), jax_tiny(**kw)


def _bcfgs(case: Case):
    kw = dict(bucket_size=case.B, chunk_rows=128 if case.B == 1 else 8,
              dtype=case.dtype)
    return BucketConfig(**kw), JaxBucketConfig(**kw)


def write_hf_checkpoint(d, cfg, seed: int, family: str = "mistral",
                        tied: bool = False, bf16: bool = False) -> None:
    """A random HF-format checkpoint (tensor names of HF_NAME_MAPS, HF's
    [out, in] layout) and its config.json, from a numpy seed."""
    rng = np.random.default_rng(seed)
    names = port_convert.HF_NAME_MAPS[
        "mistral" if family == "llama" else family]
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (q, cfg.dim), "wk": (kv, cfg.dim), "wv": (kv, cfg.dim),
              "wo": (cfg.dim, q), "w1": (cfg.hidden_dim, cfg.dim),
              "w2": (cfg.dim, cfg.hidden_dim),
              "w3": (cfg.hidden_dim, cfg.dim)}
    w = SafeTensorWriter(str(d), "model", shard_bytes=1 << 20)

    def add(name, shape, scale=0.02, base=0.0):
        t = (base + rng.standard_normal(shape) * scale).astype(np.float32)
        if bf16:
            w.add(name, (t.view(np.uint32) >> 16).astype(np.uint16),
                  bf16_bits=True)
        else:
            w.add(name, t)

    add(names["norm"], (cfg.dim,), 0.1, 1.0)
    add(names["embed"], (cfg.vocab_size, cfg.dim))
    if not tied:
        add(names["lm_head"], (cfg.vocab_size, cfg.dim))
    for l in range(cfg.n_layers):
        add(names["attn_norm"].format(l=l), (cfg.dim,), 0.1, 1.0)
        add(names["ffn_norm"].format(l=l), (cfg.dim,), 0.1, 1.0)
        for p in ("wq", "wk", "wv", "wo"):
            add(names[p].format(l=l), shapes[p])
        if family == "mixtral":
            add(names["gate"].format(l=l), (cfg.n_experts, cfg.dim), 0.1)
        for e in range(cfg.n_experts):
            for p in ("w1", "w2", "w3"):
                add(names[p].format(l=l, e=e), shapes[p])
    w.save()
    hf = {"model_type": family, "hidden_size": cfg.dim,
          "intermediate_size": cfg.hidden_dim,
          "num_hidden_layers": cfg.n_layers,
          "num_attention_heads": cfg.n_heads,
          "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
          "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.norm_eps,
          "rope_theta": cfg.rope_theta, "max_position_embeddings": 128,
          "sliding_window": None, "tie_word_embeddings": tied}
    if family == "mixtral":
        hf.update(num_local_experts=cfg.n_experts,
                  num_experts_per_tok=cfg.n_experts_per_tok)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)


def _calib(case: Case, cfg):
    if not case.calib:
        return None
    rng = np.random.default_rng(17)
    out = {"rms_m": np.exp(rng.normal(0, 1.2, cfg.dim)).astype(np.float32)}
    if "f" in case.calib:
        out["rms_f"] = np.exp(rng.normal(0, 1.2, cfg.hidden_dim)).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """case id -> (HF dir, JAX's conversion, the port's conversion), each
    made once, on the CPU."""
    made = {}

    def get(cid):
        if cid not in made:
            case = BY_ID[cid]
            root = tmp_path_factory.mktemp(cid)
            cfg, jcfg = _cfgs(case)
            bcfg, jbcfg = _bcfgs(case)
            src = root / "hf"
            src.mkdir()
            write_hf_checkpoint(src, cfg, CASES.index(case), case.family,
                                case.tied, case.bf16_src)
            calib = _calib(case, cfg)
            kw = dict(family=case.family, store_core=case.core, calib=calib,
                      fuse=case.fuse, **QUIET)
            jax_convert.convert_checkpoint(str(src), str(root / "jax"),
                                           jcfg, jbcfg, **kw)
            port_convert.convert_checkpoint(str(src), str(root / "port"),
                                            cfg, bcfg, device="cpu", **kw)
            made[cid] = (str(src), str(root / "jax"), str(root / "port"))
        return made[cid]
    return get


def _int4_codes(packed: np.ndarray) -> np.ndarray:
    """Nibble codes of int4 storage (byte j holds columns j and j + n/2)."""
    return np.concatenate([packed & 15, packed >> 4], axis=-1).astype(
        np.int32)


def assert_same_conversion(dj: str, dt: str, dtype: str) -> dict:
    """Two converted directories: the same files, index and config.json;
    every tensor's dtype and shape, and its bytes up to the module's
    tolerances. Returns the int4 code differences by tensor."""
    files = sorted(os.listdir(dj))
    assert files == sorted(os.listdir(dt))
    for fn in files:
        if fn.endswith(".json"):
            with open(os.path.join(dj, fn)) as a, \
                    open(os.path.join(dt, fn)) as b:
                assert json.load(a) == json.load(b), fn
    rj, rt = MultiShardReader(dj), MultiShardReader(dt)
    assert rj.weight_map == rt.weight_map
    ties = {}
    for k in rj.keys():
        assert (rj._reader(k).info(k)["dtype"], rj[k].shape) == (
            rt._reader(k).info(k)["dtype"], rt[k].shape), k
        a, b = rj[k], rt[k]
        if k.endswith(".stats") or (dtype == "int4"
                                    and k.endswith(".scales")):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=k)
        elif dtype == "int4" and k.endswith(".vals"):
            ca, cb = _int4_codes(a), _int4_codes(b)
            assert np.abs(ca - cb).max() <= 1, k
            ties[k] = int((ca != cb).sum())
            assert ties[k] <= INT4_TIES_ALLOWED, (k, ties[k])
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    rj.close()
    rt.close()
    return ties


@pytest.mark.parametrize("family", ["mistral", "mixtral"])
def test_config_from_hf_matches_jax(tmp_path, family):
    cfg = tiny_test_model(n_experts=4 if family == "mixtral" else 1)
    write_hf_checkpoint(tmp_path, cfg, 0, family)
    for seq in (None, 96):
        tc = port_convert.config_from_hf(str(tmp_path), seq)
        jc = jax_convert.config_from_hf(str(tmp_path), seq)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.n_experts == cfg.n_experts and tc.max_seq_len == 96


@pytest.mark.parametrize("cid", list(BY_ID))
def test_convert_matches_jax(ckpts, cid):
    """The port's conversion of an HF checkpoint against JAX's, shard by
    shard and tensor by tensor (module docstring); config.json equal as
    JSON, activation profile included."""
    _, dj, dt = ckpts(cid)
    ties = assert_same_conversion(dj, dt, BY_ID[cid].dtype)
    if ties:
        print(cid, "int4 codes differing at rounding ties:", ties)
    with open(os.path.join(dt, "config.json")) as f:
        meta = json.load(f)
    assert meta["calibrated"] == bool(BY_ID[cid].calib)
    assert ("activation_profile" in meta) == bool(BY_ID[cid].calib)


def _assert_same_weights(tw, jw):
    """The port's ModelWeights against JAX's, field by field (bridge
    numpy form: bf16 as bits)."""
    jd = jax_weights_to_numpy(jw)
    for f in ("tok_embeddings", "norm", "output"):
        np.testing.assert_array_equal(torch_np(getattr(tw, f)), jd[f])
    for f, want in jd["layers"].items():
        got = getattr(tw.layers, f)
        if want is None:
            assert got is None, f
        elif isinstance(want, dict):
            for m in META_FIELDS:
                assert getattr(got, m) == want[m], (f, m)
            for t in TENSOR_FIELDS:
                g = getattr(got, t)
                if want[t] is None:
                    assert g is None, (f, t)
                else:
                    np.testing.assert_array_equal(torch_np(g), want[t],
                                                  err_msg=f"{f}.{t}")
        else:
            np.testing.assert_array_equal(torch_np(got), want, err_msg=f)


LOADS = [  # (case id, percent_load, load_dense)
    ("mistral-int8-B1-fuse-core-bf16_src-calib_mf", None, "auto"),
    ("mistral-int8-B1-fuse-core-bf16_src-calib_mf", 0.5, "auto"),
    ("mistral-int8-B1-fuse-core", 0.5, "auto"),
    ("mistral-bf16-B4-fuse-core-calib_mf", 0.5, "auto"),
    ("mistral-bf16-B4-fuse-core-calib_mf", None, True),
    ("mistral-bf16-B4-fuse-core-calib_mf", None, False),
    ("mixtral-bf16-B4-fuse-core-calib_mf", None, "auto"),
    ("mistral-int4-B4-tied", 0.5, False),
]


@pytest.mark.parametrize("cid,percent_load,load_dense", LOADS)
def test_load_matches_jax(ckpts, cid, percent_load, load_dense):
    """The port's load_bucketized of JAX's conversion equals JAX's, field
    by field: truncated loading on B = 1 with calibration-sorted rows and
    with unsorted ones (kept whole), on B = 4 (leading ranks), and the
    dense copies forced, skipped, or "auto" (JAX's CPU budget is its
    16 GiB fallback; the port's is given explicitly)."""
    _, dj, _ = ckpts(cid)
    jw, jc, jb = jax_weights.load_bucketized(dj, percent_load=percent_load,
                                             load_dense=load_dense)
    tw, tc, tb = port_weights.load_bucketized(
        dj, percent_load=percent_load, load_dense=load_dense, device="cpu",
        hbm_budget_bytes=16 * 2**30)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    _assert_same_weights(tw, jw)
    if percent_load is not None and BY_ID[cid].B == 4:
        assert tw.layers.wo.n_ranks == 2
    dense = tw.layers.wo.dense is not None
    assert dense == (load_dense is not False and percent_load is None
                     and BY_ID[cid].core)


def test_load_budget_rules(ckpts):
    """load_dense="auto" skips the dense copies when buckets plus copies
    pass 80% of the budget (JAX's decision with load_dense=False); on the
    CPU "auto" needs an explicit budget, as do auto_adjust and
    auto_percent_load; auto_percent_load picks JAX's 16ths."""
    cid = "mistral-bf16-B4-fuse-core-calib_mf"
    _, dj, _ = ckpts(cid)
    jw, *_ = jax_weights.load_bucketized(dj, load_dense=False)
    tw, cfg, bcfg = port_weights.load_bucketized(
        dj, device="cpu", hbm_budget_bytes=1 << 20)
    _assert_same_weights(tw, jw)
    with pytest.raises(ValueError, match="hbm_budget_bytes"):
        port_weights.load_bucketized(dj, device="cpu")
    with pytest.raises(ValueError, match="hbm_budget_bytes"):
        port_weights.auto_percent_load(cfg, bcfg, device="cpu")
    jcfg, jbcfg = jax_weights.load_config(dj)
    full = port_weights.model_weight_bytes(cfg, bcfg)
    for budget in (full * 2, int(full / 0.75 * 0.5) + 1, 1000):
        assert (port_weights.auto_percent_load(cfg, bcfg, budget)
                == jax_weights.auto_percent_load(jcfg, jbcfg, budget))
    tw, *_ = port_weights.load_bucketized(
        dj, auto_adjust=True, device="cpu",
        hbm_budget_bytes=int(full / 0.75 * 0.5) + 1)
    assert tw.layers.wo.n_ranks < bcfg.bucket_size


def _greedy_jax(d, effort):
    w, cfg, _ = jax_weights.load_bucketized(d)
    return JaxEngine(w, cfg, impl="jnp", pad_to=PAD).generate(
        PROMPT, n_new=6, effort=effort)


@pytest.mark.parametrize("cid", ["mistral-int8-B1-fuse-core-bf16_src-calib_mf",
                                 "mixtral-bf16-B4-fuse-core-calib_mf"])
def test_hf_to_generate_matches_jax(ckpts, cid):
    """HF -> convert -> load -> Engine.generate: the port's conversion,
    loaded by the port, gives the tokens and per-step predictions JAX
    gives from its own conversion, at efforts 0.5 and 1.0 (reference route
    against JAX's "jnp")."""
    _, dj, dt = ckpts(cid)
    w, cfg, _ = port_weights.load_bucketized(dt, device="cpu",
                                             load_dense=True)
    eng = Engine(w, cfg, impl="reference", pad_to=PAD, device="cpu")
    for effort in (0.5, 1.0):
        rt = eng.generate(PROMPT, n_new=6, effort=effort)
        rj = _greedy_jax(dj, effort)
        assert rt.token_ids == rj.token_ids, effort
        assert rt.predictions == rj.predictions, effort


def test_collect_act_rms_matches_jax(ckpts):
    """collect_act_rms on an unfused checkpoint against JAX's, 1e-5
    relative, through the port's default route and its reference route."""
    cid = "llama-int8-B4-calib_m"
    _, dj, _ = ckpts(cid)
    seqs = [[1, 5, 9, 33], [2, 100, 7]]
    jw, jcfg, _ = jax_weights.load_bucketized(dj)
    want = jax_calibrate.collect_act_rms(jw, jcfg, [jnp.asarray(s)
                                                    for s in seqs])
    tw, cfg, _ = port_weights.load_bucketized(dj, device="cpu")
    for impl in ("auto", "reference"):
        got = port_calibrate.collect_act_rms(tw, cfg, seqs, impl=impl)
        for k in ("rms_m", "rms_f"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, err_msg=f"{impl} {k}")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.status, json.loads(r.read().decode())


def _ask(srv, path):
    async def run():
        await srv.start()
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, _get, srv.port, path)
        finally:
            await srv.stop()
    return asyncio.run(run())


@pytest.mark.parametrize("batch", [0, 2])
def test_server_serves_checkpoint(ckpts, tmp_path, batch):
    """build_server(--ckpt, --tokenizer, --device cpu) answers /q with the
    decoded reply, single-flight (the same text as an Engine on the same
    checkpoint) and batched (the text of its token ids)."""
    _, _, dt = ckpts("mistral-int8-B1-fuse-core-bf16_src-calib_mf")
    tok_json = tmp_path / "tokenizer.json"
    write_bpe_json(tok_json, vocab_size=tiny_test_model().vocab_size)
    srv = port_server.build_server(port_server.parse_args(
        ["--ckpt", dt, "--tokenizer", str(tok_json), "--device", "cpu",
         "--port", "0", "--batch", str(batch)]))
    assert srv.tokenizer is not None and srv.engine.tokenizer is not None
    st, body = _ask(srv, "/q?query=hello%20there&effort=50&numtokens=4")
    assert st == 200, body
    tok = Tokenizer(str(tok_json))
    if batch:
        assert body["reply"] == (tok.decode(body["token_ids"])
                                 or str(body["token_ids"]))
    else:
        w, cfg, _ = port_weights.load_bucketized(dt, device="cpu",
                                                 load_dense=True)
        want = Engine(w, cfg, tokenizer=tok, device="cpu").generate(
            tok.encode(mistral_instruct_prompt("hello there")), n_new=4,
            effort=0.5)
        assert body["reply"] == (want.text or str(want.token_ids))
        assert want.text
