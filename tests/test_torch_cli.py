"""The port's command line (`python -m effort_tpu_torch`) held against the
JAX package's (`effort_tpu.cli`) on one converted tiny checkpoint: the
same token ids and sweep lines for generate, agreement, kl and quiz with
`--device cpu --ckpt DIR --impl jnp` (the port's "reference" route, the
JAX package's "jnp"); convert; the REPL fed through stdin (its --stream
output equals JAX's); the mode aliases; `--help` in a subprocess; and the
card by default (no --device and no card raises).

Tolerances: printed lines equal, character for character, except each
generate's timing numbers (wall-clock ms/token and tok/s).
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from effort_tpu import cli as jax_cli
from effort_tpu_torch import cli
from effort_tpu_torch.config import tiny_test_model
from effort_tpu_torch.runtime.safetensors_io import MultiShardReader
from test_torch_bridge import REPO
from test_torch_convert import write_hf_checkpoint
from test_torch_tokenizer import write_bpe_json

torch.set_num_threads(2)

CONVERT = ["--model", "tiny", "--bucket-size", "1", "--chunk-rows", "128",
           "--dtype", "int8", "--fuse"]
PROMPT = ["--prompt", "hi there"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(HF dir, the JAX CLI's conversion, the port CLI's conversion,
    tokenizer.json): a random tiny HF checkpoint converted by both command
    lines to int8 row-prefix, fused."""
    root = tmp_path_factory.mktemp("cli")
    src = root / "hf"
    src.mkdir()
    write_hf_checkpoint(src, tiny_test_model(), seed=21)
    jax_cli.main(["convert", "--src", str(src), "--dst", str(root / "jax"),
                  *CONVERT])
    cli.main(["convert", "--src", str(src), "--dst", str(root / "port"),
              *CONVERT, "--device", "cpu"])
    tok = root / "tokenizer.json"
    write_bpe_json(tok, vocab_size=512)
    return str(src), str(root / "jax"), str(root / "port"), str(tok)


def _both(capsys, argv, stdin: str = None):
    """(JAX CLI stdout lines, port CLI stdout lines) of one argv, both on
    the JAX CLI's conversion, JAX with --impl jnp, the port also with
    --device cpu."""
    out = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            main(argv + ["--impl", "jnp"] + extra)
        finally:
            sys.stdin = sys.__stdin__
        out.append(capsys.readouterr().out.splitlines())
    return out


def test_convert_mode_matches_jax(ckpt):
    """The port's `convert` writes JAX's config.json and the same tensor
    names, values and positions byte for byte (stats: f32 means, within
    1e-6 relative, as tests/test_torch_convert.py holds them)."""
    _, dj, dt, _ = ckpt
    with open(os.path.join(dj, "config.json")) as a, \
            open(os.path.join(dt, "config.json")) as b:
        assert json.load(a) == json.load(b)
    rj, rt = MultiShardReader(dj), MultiShardReader(dt)
    try:
        assert sorted(rj.keys()) == sorted(rt.keys())
        for k in rj.keys():
            a, b = np.asarray(rj[k]), np.asarray(rt[k])
            if k.endswith(".stats"):
                np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)
    finally:
        rj.close()
        rt.close()


@pytest.mark.parametrize("effort", ["0.25", "1.0"])
def test_generate_matches_jax(capsys, ckpt, effort):
    """generate: the same token ids, and the stats line's effort."""
    j, t = _both(capsys, ["generate", "--ckpt", ckpt[1], *PROMPT,
                          "--n-tokens", "8", "--effort", effort])
    assert j[0] == t[0] and j[0].startswith("[")
    head = f"[effort {float(effort) * 100:.0f}%: "
    assert j[1].startswith(head) and t[1].startswith(head)
    assert t[1].endswith("tok/s]")


def test_generate_speculative_matches_jax(capsys, ckpt):
    """generate --spec-k: the greedy tokens at 1.0, JAX's."""
    j, t = _both(capsys, ["generate", "--ckpt", ckpt[1], *PROMPT,
                          "--n-tokens", "8", "--spec-k", "3"])
    assert j[0] == t[0]
    assert t[1].startswith("[speculative, draft 25%: ")


def test_agreement_and_kl_match_jax(capsys, ckpt):
    """agreement and kl over the effort scale: every line JAX's (100%
    agreement and 0 KL at 100% effort)."""
    for mode in ("agreement", "kl"):
        j, t = _both(capsys, [mode, "--ckpt", ckpt[1], *PROMPT,
                              "--n-tokens", "4"])
        assert len(t) == 24 and t == j, (mode, t, j)
    assert t[0] == "effort 100.0%: KL   0.0000 nats"


def test_quiz_matches_jax(capsys, ckpt, tmp_path):
    """quiz on a 3-item --quiz-file with the BPE tokenizer: JAX's accuracy
    lines at every effort."""
    items = [{"question": q, "answers": a, "correct": c} for q, a, c in (
        ("Sky?", ["blue", "red", "green"], 0),
        ("Two plus two?", ["3", "4"], 1),
        ("Fox?", ["quick", "lazy", "dog", "cat"], 2))]
    qf = tmp_path / "quiz.json"
    qf.write_text(json.dumps(items))
    j, t = _both(capsys, ["quiz", "--ckpt", ckpt[1], "--tokenizer",
                          ckpt[3], "--quiz-file", str(qf)])
    acc = [x for x in t if x.startswith("effort")]
    assert len(acc) == 24 and t == j


def test_repl_stream_matches_jax(capsys, ckpt):
    """repl --stream fed "Hello", "25" (effort 25%, the last query again)
    and "r" on stdin: the session's chunks, JAX's, line for line."""
    j, t = _both(capsys, ["repl", "--stream", "--ckpt", ckpt[1],
                          "--n-tokens", "10"], stdin="Hello\n25\nr\n")
    assert t == j
    assert sum("[effort 100%]" in x for x in t) == 1
    assert sum("[effort 25%]" in x for x in t) == 2


def test_repl_plain(capsys, ckpt):
    """repl without --stream answers each line through Engine.generate."""
    sys.stdin = io.StringIO("Hello\n50\n")
    try:
        cli.main(["repl", "--ckpt", ckpt[2], "--n-tokens", "4",
                  "--device", "cpu"])
    finally:
        sys.stdin = sys.__stdin__
    out = capsys.readouterr().out
    assert out.count("[effort 100%: ") == 1
    assert out.count("[effort 50%: ") == 1


def test_aliases_and_impl_names():
    """playground -> bucket, benchmark -> agreement, quickstart ->
    generate; --impl takes the JAX package's names."""
    for alias, mode in (("playground", "bucket"), ("benchmark", "agreement"),
                        ("quickstart", "generate"), ("kl", "kl")):
        assert cli.parse_args([alias]).mode == mode
    assert [cli.IMPLS[n] for n in ("auto", "jnp", "pallas", "dense")] == [
        "auto", "reference", "kernel", "dense"]


def test_quickstart_synthetic(capsys):
    """quickstart runs generate on the synthetic tiny model with --qhead
    and --effort-floors."""
    cli.main(["quickstart", "--synthetic", "--device", "cpu", "--n-tokens",
              "3", "--effort", "0.5", "--qhead", "--effort-floors",
              "wk=0.4,wv=0.4"])
    out = capsys.readouterr().out.splitlines()
    assert len(json.loads(out[0])) == 3
    assert out[1].startswith("[effort 50%: ")


def test_card_is_the_default():
    """Without --device the entry points run on the card: with no card
    they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--synthetic", "--n-tokens", "2"])


def test_module_help():
    """`python -m effort_tpu_torch --help` lists the modes."""
    r = subprocess.run([sys.executable, "-m", "effort_tpu_torch", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    for mode in ("convert", "generate", "repl", "bucket", "quiz",
                 "agreement", "kl", "autotune", "--device"):
        assert mode in r.stdout, mode

