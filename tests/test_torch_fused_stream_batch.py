"""The batched row-prefix effort matmul (kernel K2) of the port against the
JAX package's mxu_matvec_batch run in Pallas interpret mode, on the same
containers and the same numpy inputs.

On the CPU the port's wrapper runs the kernel's plain version
(mxu_matvec_batch_ref); the CUDA kernel itself is held against that plain
version on the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.kernels.fused_stream import _prefix_len, _vec_cutoff
from effort_tpu.kernels.fused_stream import \
    mxu_matvec_batch as jax_mxu_matvec_batch
from effort_tpu.ops.bucketize import bucketize as jax_bucketize
from effort_tpu.ops.layouts import strided_sample as jax_strided_sample
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels import fused_stream as port_fs
from effort_tpu_torch.models.bridge import bucketed_from_numpy
from effort_tpu_torch.ops.bucketmul import bucket_matmul
from test_torch_bridge import cos, jax_bm_to_numpy
from test_torch_fused_stream import IN, OUT, _containers

torch.set_num_threads(2)

T = 8
# per-slot efforts, two slots at 0 (kq is clamped to 1 there, so a slot
# selects nothing only when no row clears the top cutoff)
EFFORTS = np.asarray([0.25, 0.5, 1.0, 0.0, 0.25, 0.7, 0.1, 0.0], np.float32)


def _V(seed):
    return np.random.default_rng(seed).standard_normal((T, IN)).astype(
        np.float32)


def jax_stream_len(jb, V, efforts, tau) -> int:
    """The chunk count JAX's _kernel_mxu_batch streams for these inputs,
    recomputed with the kernel's own helpers: each slot's coverage length
    at its f32 effort, then the max over slots (fused_stream.py:414-437)."""
    P = jb.probes.shape[1]
    lens = []
    for v, e in zip(V, efforts):
        vp = jb.permute_v(jnp.asarray(v), 0).astype(jnp.float32)
        vs = jax_strided_sample(vp, jb.in_dim, P)
        n = vs.shape[0]
        scores = jnp.abs(vs * jb.probes[0, :n].astype(jnp.float32))[None]
        kq = jnp.clip(jnp.round(float(n) * jnp.float32(e)), 1.0, float(n))
        cutoff = _vec_cutoff(scores, kq, jnp.max(scores) + 1e-30)
        x = jb.stats[0][:, 0] * jnp.abs(vp)
        mass = jnp.where(x > cutoff, x, 0.0).reshape(jb.n_chunks, -1).sum(1)
        lens.append(int(_prefix_len(mass[:, None], tau)[0]))
    return max(lens)


@pytest.mark.parametrize("tau", [1.0, 0.97])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_mxu_matvec_batch_matches_jax_interpret(dtype, tau):
    """Per-slot efforts including 0: the same streamed chunk count C as
    JAX's kernel and every slot's row at cos >= 0.9999 (the two differ by
    f32 summation order only; a row that is 0 in JAX must be 0 here)."""
    jb, tb = _containers(dtype)
    V = _V(7)
    yj = np.asarray(jax_mxu_matvec_batch(jb, jnp.asarray(V),
                                         jnp.asarray(EFFORTS), 0, tau=tau,
                                         interpret=True))
    yt, C = port_fs.mxu_matvec_batch(tb, torch.from_numpy(V),
                                     torch.from_numpy(EFFORTS), 0, tau=tau,
                                     return_len=True)
    assert yt.shape == (T, OUT)
    assert int(C) == jax_stream_len(jb, V, EFFORTS, tau), (dtype, tau)
    for t in range(T):
        if not np.abs(yj[t]).max():
            assert float(yt[t].abs().max()) == 0.0, t
            continue
        assert cos(yj[t], yt[t].numpy()) >= 0.9999, (t, cos(yj[t], yt[t]))


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_batch_rows_match_single_vector_plain(dtype):
    """At tau = 1 every slot's row equals the port's K1 plain version on
    that slot alone at the same effort (cos >= 0.9999): the batch streams
    the longest slot's prefix, and the extra chunks carry u = 0."""
    _, tb = _containers(dtype, seed=3)
    V = torch.from_numpy(_V(8))
    eff = torch.from_numpy(EFFORTS)
    Y = port_fs.mxu_matvec_batch(tb, V, eff, 0, tau=1.0)
    for t in range(T):
        if EFFORTS[t] == 0.0:
            continue
        y = port_fs.mxu_matvec_ref(tb, V[t], float(EFFORTS[t]), 0, tau=1.0)
        assert cos(Y[t].numpy(), y.numpy()) >= 0.9999, t


def test_bucket_matmul_routes():
    """bucket_matmul on the CPU: "kernel" and "plain" reach the same plain
    version (bit for bit), "reference" (per-row bucketMul semantics) agrees
    at tau = 1, "dense" equals a bf16 matmul on the dense copy, and "auto"
    takes the dense copy only for a python-float effort >= 0.999. A shared
    effort (float or scalar tensor) equals the same effort per slot. No
    launch is counted."""
    _, tb = _containers("int8", seed=5)
    rng = np.random.default_rng(5)
    wt = (rng.standard_normal((IN, OUT)) * 0.02).astype(np.float32)
    tbd = bucketed_from_numpy(jax_bm_to_numpy(jax_bucketize(
        jnp.asarray(wt), JaxBucketConfig(bucket_size=1, chunk_rows=128,
                                         dtype="int8"), keep_dense=True)))
    V = torch.from_numpy(_V(9))
    launches = dict(LAUNCHES)
    yk = bucket_matmul(tb, V, 0.5, impl="kernel")
    torch.testing.assert_close(bucket_matmul(tb, V, 0.5, impl="plain"), yk,
                               rtol=0, atol=0)
    torch.testing.assert_close(
        bucket_matmul(tb, V, torch.full((T,), 0.5), impl="kernel"), yk,
        rtol=0, atol=0)
    torch.testing.assert_close(
        bucket_matmul(tb, V, torch.tensor(0.5), impl="kernel"), yk,
        rtol=0, atol=0)
    yr = bucket_matmul(tb, V, 0.5, impl="reference")
    yk1 = port_fs.mxu_matvec_batch(tb, V, 0.5, tau=1.0)
    for t in range(T):
        assert cos(yr[t].numpy(), yk1[t].numpy()) >= 0.9999, t
    dense = bucket_matmul(tbd, V, 1.0, impl="dense")
    ref = (V.to(torch.bfloat16).float()
           @ tbd.dense[0].float())
    torch.testing.assert_close(dense, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bucket_matmul(tbd, V, 1.0), dense,
                               rtol=0, atol=0)
    torch.testing.assert_close(bucket_matmul(tbd, V, torch.tensor(1.0)),
                               bucket_matmul(tbd, V, 1.0, impl="kernel"),
                               rtol=0, atol=0)
    assert LAUNCHES == launches


def test_mxu_matvec_batch_forms_of_effort():
    """Efforts as a python float and an f32 [T] tensor give the same rows,
    and a 16.16 int32 tensor (K1's form) raises; JAX's kernel under one jit
    with traced efforts agrees for two effort mixes."""
    jb, tb = _containers("bf16", seed=2)
    V = _V(10)
    run = jax.jit(lambda b, v, e: jax_mxu_matvec_batch(b, v, e, 0, tau=1.0,
                                                       interpret=True))
    for mix in (EFFORTS, EFFORTS[::-1].copy()):
        yj = np.asarray(run(jb, jnp.asarray(V), jnp.asarray(mix)))
        yt = port_fs.mxu_matvec_batch(tb, torch.from_numpy(V),
                                      torch.from_numpy(mix), tau=1.0)
        for t in range(T):
            if np.abs(yj[t]).max():
                assert cos(yj[t], yt[t].numpy()) >= 0.9999, t
    Vt = torch.from_numpy(V)
    y0 = port_fs.mxu_matvec_batch(tb, Vt, 0.375)
    torch.testing.assert_close(
        port_fs.mxu_matvec_batch(tb, Vt, torch.full((T,), 0.375)), y0,
        rtol=0, atol=0)
    q16 = torch.full((T,), int(0.375 * 65536), dtype=torch.int32)
    with pytest.raises(TypeError):
        port_fs.mxu_matvec_batch(tb, Vt, q16)


# ---- K2's launch plan (kernels/fused_stream.k2_plan) -----------------------
# The index arithmetic below is csrc/mxu_matvec_batch.cu's, written out:
# which rows split z streams, which columns column tile y writes.

MISTRAL_SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
                  "w13": (4096, 28672), "w2": (14336, 4096)}
SMS = 132               # an H100's SMs


def _kernel_rows(splits, CG, KT=port_fs._K2_TILE_ROWS):
    tiles = -(-CG // KT)
    per = -(-tiles // splits)
    return [(z * per * KT, min(z * per * KT + per * KT, CG))
            for z in range(splits)]


def _kernel_cols(kind, row_bytes, y):
    bmb = port_fs._K2_BLOCK_BYTES[kind]
    bpt = bmb // 32                          # 4 warps x 8 thread groups
    cols = []
    for cb in range(y * bmb, (y + 1) * bmb, bpt):
        if cb >= row_bytes:
            break
        for ll in range(8):
            if kind == 0:
                cols.append(cb // 2 + ll)
            elif kind == 1:
                cols.append(cb + ll)
            else:
                cols.append(cb + ll if ll < 4 else row_bytes + cb + ll - 4)
    return cols


@pytest.mark.parametrize("T", [1, 4, 64, 512])
@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("shape", list(MISTRAL_SHAPES))
def test_k2_plan_covers_every_row_column_and_slot(shape, kind, T):
    """At the Mistral-7B projections, for 1 to 4 blocks an SM: the slot
    tiles cover T (the last one ragged at most), the column tiles every
    decoded column once, the splits every live row once for any C*G, and
    the partial buffer is exactly what the blocks write. The grid reaches
    the card: a block for at least 70% of the 132 SMs up to 64 slots, half
    of them past that (where more splits cost more partial sums than idle
    SMs do)."""
    in_dim, out_dim = MISTRAL_SHAPES[shape]
    row_bytes = {0: 2 * out_dim, 1: out_dim, 2: out_dim // 2}[kind]
    width = out_dim
    for per_sm in (1, 2, 4):
        _check_plan(T, in_dim, row_bytes, width, kind, per_sm)


def _check_plan(T, in_dim, row_bytes, width, kind, per_sm):
    p = port_fs.k2_plan(T, in_dim, row_bytes, width, kind, SMS, per_sm)
    ns = 8 * p.nn
    assert p.nn in (1, 2, 4, 8) and ns >= min(T, 64)
    assert (p.slot_tiles - 1) * ns < T <= p.slot_tiles * ns
    cols = [c for y in range(p.col_tiles)
            for c in _kernel_cols(kind, row_bytes, y)]
    assert sorted(cols) == list(range(width))
    for CG in (128, 1152, in_dim // 2, in_dim):
        spans = _kernel_rows(p.splits, CG)
        rows = [r for r0, r1 in spans for r in range(r0, r1)]
        assert rows == list(range(CG))
    written = p.splits * T * len(cols)   # (split, slot < T, column) triples
    if p.splits > 1:
        assert p.partial == (p.splits, T, width)
        assert written == p.partial[0] * p.partial[1] * p.partial[2]
    else:
        assert p.partial is None
    assert p.blocks >= (0.7 if T <= 64 else 0.5) * SMS, p
