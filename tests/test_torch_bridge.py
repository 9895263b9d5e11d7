"""Carrying weights from the JAX package into the PyTorch port, and the
port's import isolation.

The helpers here flatten JAX containers into the numpy dicts that
effort_tpu_torch.models.bridge takes (bf16 as its uint16 bit pattern); the
other port test files import them from this module.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.ops.bucketize import bucketize as jax_bucketize
from effort_tpu_torch.models.bridge import (bucketed_from_numpy,
                                            model_weights_from_numpy)
from effort_tpu_torch.ops.layouts import META_FIELDS, TENSOR_FIELDS

torch.set_num_threads(2)

IN, OUT = 256, 512
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJ = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wqkv", "w13")


def np_of(a):
    """A JAX array as numpy; bf16 as its uint16 bit pattern."""
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return np.asarray(a.view(jnp.uint16))
    return np.asarray(a)


def jax_bm_to_numpy(bm):
    if bm is None:
        return None
    d = {f: np_of(getattr(bm, f)) for f in TENSOR_FIELDS}
    d.update({m: getattr(bm, m) for m in META_FIELDS})
    return d


def jax_weights_to_numpy(w):
    lw = w.layers
    layers = dict(attn_norm=np_of(lw.attn_norm), ffn_norm=np_of(lw.ffn_norm),
                  ffn_gate=np_of(lw.ffn_gate))
    layers.update({f: jax_bm_to_numpy(getattr(lw, f)) for f in PROJ})
    return dict(tok_embeddings=np_of(w.tok_embeddings), norm=np_of(w.norm),
                output=np_of(w.output), output_q=np_of(w.output_q),
                output_qscale=np_of(w.output_qscale), layers=layers)


def torch_np(t):
    """A port tensor as numpy; bf16 as its uint16 bit pattern."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_bucketed_round_trip(dtype, B):
    """JAX container -> numpy -> port: every field equal, bf16 bit for bit,
    and the dense reconstruction within 1e-6."""
    rng = np.random.default_rng(3)
    wt = (rng.standard_normal((IN, OUT)) * 0.02).astype(np.float32)
    cfg = JaxBucketConfig(bucket_size=B, chunk_rows=128 if B == 1 else 16,
                          dtype=dtype)
    jb = jax_bucketize(jnp.asarray(wt), cfg, keep_dense=True)
    tb = bucketed_from_numpy(jax_bm_to_numpy(jb))
    for f in TENSOR_FIELDS:
        a, t = getattr(jb, f), getattr(tb, f)
        assert (a is None) == (t is None), f
        if a is not None:
            np.testing.assert_array_equal(np_of(a), torch_np(t), err_msg=f)
    for m in META_FIELDS:
        assert getattr(jb, m) == getattr(tb, m), m
    if dtype == "bf16":
        assert tb.vals.dtype == torch.bfloat16
    assert tb.dense.dtype == torch.bfloat16
    np.testing.assert_allclose(tb.reconstruct_dense().numpy(),
                               np.asarray(jb.reconstruct_dense()),
                               rtol=0, atol=1e-6)


def test_bucketed_round_trip_runtime_permutation():
    """A seg_order (run-time permuted) container crosses too, and the port
    undoes the permutation in reconstruct_dense as JAX does."""
    rng = np.random.default_rng(4)
    wt = (rng.standard_normal((IN, OUT)) * 0.02).astype(np.float32)
    rms = np.exp(rng.standard_normal(IN)).astype(np.float32)
    jb = jax_bucketize(jnp.asarray(wt), JaxBucketConfig(
        bucket_size=1, chunk_rows=128, dtype="int8"), act_rms=rms)
    tb = bucketed_from_numpy(jax_bm_to_numpy(jb))
    np.testing.assert_array_equal(tb.seg_order.numpy(),
                                  np.asarray(jb.seg_order))
    np.testing.assert_allclose(tb.reconstruct_dense().numpy(),
                               np.asarray(jb.reconstruct_dense()),
                               rtol=0, atol=1e-6)


def test_model_weights_round_trip():
    """ModelWeights cross as a nested dict; bf16 leaves keep their bits."""
    from effort_tpu.config import tiny_test_model
    from effort_tpu.models.transformer import (init_random_weights,
                                               quantize_head)
    jw = quantize_head(init_random_weights(
        tiny_test_model(), JaxBucketConfig(bucket_size=1, chunk_rows=128),
        fuse=True))
    tw = model_weights_from_numpy(jax_weights_to_numpy(jw))
    assert tw.tok_embeddings.dtype == torch.bfloat16
    np.testing.assert_array_equal(torch_np(tw.output), np_of(jw.output))
    np.testing.assert_array_equal(tw.output_q.numpy(), np_of(jw.output_q))
    assert tw.layers.wq is None and tw.layers.w13 is not None
    np.testing.assert_array_equal(torch_np(tw.layers.w13.vals),
                                  np_of(jw.layers.w13.vals))
    assert tw.layers.w13.n_experts == jw.layers.w13.n_experts


_ISOLATION = """
import importlib, importlib.util, pkgutil, sys
import effort_tpu_torch
for m in pkgutil.walk_packages(effort_tpu_torch.__path__, "effort_tpu_torch."):
    importlib.import_module(m.name)
for name in ("kernels.fused_stream", "kernels.flash_attention",
             "kernels.prefix_stream", "kernels.gather_dma",
             "kernels.gather_mul", "models.generate", "serving.batcher",
             "serving.server", "runtime.safetensors_io",
             "runtime.tokenizer", "runtime.word_tokenizer",
             "runtime._native_build", "convert.convert",
             "convert.calibrate", "models.weights", "cli", "__main__",
             "models.session", "models.tester", "models.autotune",
             "ops.oracle", "eval.harness", "utils.profiling",
             "train", "train.trainer", "train.optim", "parallel",
             "parallel.collectives", "parallel.multihost", "parallel.tp",
             "parallel.sp", "parallel.ep", "parallel.pp",
             "parallel.composed", "parallel._ranks"):
    importlib.import_module("effort_tpu_torch." + name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
ROOTS = ("jax", "jaxlib", "effort_tpu", "optax")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ROOTS)
if bad:
    sys.exit("imported: %s" % bad)
from effort_tpu_torch.parallel import _ranks, multihost
bad = multihost.spawn(_ranks.loaded_modules, 1, "gloo", "cpu", ROOTS,
                      timeout=120)[0]
if bad:
    sys.exit("a spawned rank imported: %s" % bad)
print(len([m for m in sys.modules if m.startswith("effort_tpu_torch")]))
"""


def test_port_imports_no_jax():
    """Importing the port (every submodule, the kernels, the prefill and
    serving modules by name, the rank-prefix and gather kernels too, the
    checkpoint modules: runtime.*, convert.*, models.weights; the
    user-facing modules: cli, __main__, models.session, models.tester,
    models.autotune, ops.oracle, eval.harness, utils.profiling; the
    trainer: train, train.trainer, train.optim; the parallel modules:
    parallel.*) and chip_smoke.py leaves jax, optax and every effort_tpu
    module out of sys.modules, and so does a rank spawned by
    parallel.multihost.spawn (gloo, one rank)."""
    r = subprocess.run(
        [sys.executable, "-c", _ISOLATION,
         os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 45, r.stdout
