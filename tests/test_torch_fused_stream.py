"""The row-prefix effort matvec (kernel K1) of the port against the JAX
package's mxu_matvec run in Pallas interpret mode, on the same container.

On the CPU the port's wrapper runs the kernel's plain version
(mxu_matvec_ref); the CUDA kernel itself is held against that plain version
on the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.kernels.fused_stream import mxu_matvec as jax_mxu_matvec
from effort_tpu.ops.bucketize import bucketize as jax_bucketize
from effort_tpu.ops.bucketize import calib_row_order as jax_calib_row_order
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels import fused_stream as port_fs
from effort_tpu_torch.models.bridge import bucketed_from_numpy
from effort_tpu_torch.ops.bucketmul import bucket_matvec
from effort_tpu_torch.ops.effort import effort_q16
from test_torch_bridge import cos, jax_bm_to_numpy

torch.set_num_threads(2)

IN, OUT = 256, 512
FULL_TAU = 1.0      # stream through the last selected chunk: the exact
                    # selection, so only rounding separates the two


def _containers(dtype, seed=0, in_perm=None):
    rng = np.random.default_rng(seed)
    wt = (rng.standard_normal((IN, OUT)) * 0.02).astype(np.float32)
    jb = jax_bucketize(jnp.asarray(wt), JaxBucketConfig(
        bucket_size=1, chunk_rows=128, dtype=dtype), in_perm=in_perm)
    return jb, bucketed_from_numpy(jax_bm_to_numpy(jb))


def _v(seed):
    return np.random.default_rng(seed).standard_normal(IN).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("effort", [0.25, 0.6])
def test_mxu_matvec_matches_jax_interpret(dtype, effort):
    jb, tb = _containers(dtype)
    v = _v(1)
    yj = jax_mxu_matvec(jb, jnp.asarray(v), effort, 0, tau=FULL_TAU,
                        interpret=True)
    yt = port_fs.mxu_matvec(tb, torch.from_numpy(v), effort, 0,
                            tau=FULL_TAU)
    assert cos(yj, yt.numpy()) > 0.9999, (dtype, effort, cos(yj, yt))
    # on the CPU the router's kernel and plain routes reach the same
    # function, and the port's reference path (exact bucketMul) agrees
    torch.testing.assert_close(
        bucket_matvec(tb, torch.from_numpy(v), effort, impl="kernel"),
        bucket_matvec(tb, torch.from_numpy(v), effort, impl="plain"),
        rtol=0, atol=0)
    yr = bucket_matvec(tb, torch.from_numpy(v), effort, impl="reference")
    assert cos(yr.numpy(), yt.numpy()) > 0.9999


def test_mxu_matvec_production_tau_calibrated():
    """At the default tau the streamed prefix keeps tau of the selected
    mass; on a calibrated layout both packages agree closely."""
    rng = np.random.default_rng(9)
    rms = np.exp(rng.standard_normal(IN) * 1.2).astype(np.float32)
    pi = np.asarray(jax_calib_row_order(jnp.asarray(rms)))
    jb, tb = _containers("bf16", in_perm=pi)
    v = (rms[pi] * rng.standard_normal(IN)).astype(np.float32)
    yj = jax_mxu_matvec(jb, jnp.asarray(v), 0.25, 0, interpret=True)
    yt = port_fs.mxu_matvec(tb, torch.from_numpy(v), 0.25, 0)
    assert cos(yj, yt.numpy()) > 0.998, cos(yj, yt)


def test_mxu_matvec_production_tau_uncalibrated():
    """On an uncalibrated layout (selection scattered over the chunks)
    the coverage bound keeps the two close at low effort too."""
    jb, tb = _containers("bf16", seed=11)
    v = _v(12)
    for e in (0.4, 0.25):
        yj = jax_mxu_matvec(jb, jnp.asarray(v), e, 0, interpret=True)
        yt = port_fs.mxu_matvec(tb, torch.from_numpy(v), e, 0)
        assert cos(yj, yt.numpy()) > 0.998, (e, cos(yj, yt))


def test_mxu_matvec_runtime_effort():
    """Several efforts through one wrapper, as a float, as an f32 tensor
    and as the 16.16 int32 tensor the kernel takes; JAX's one jitted
    callable with a traced effort gives the same results."""
    jb, tb = _containers("bf16")
    v = _v(4)
    run = jax.jit(lambda b, v, e: jax_mxu_matvec(b, v, e, 0, tau=FULL_TAU,
                                                 interpret=True))
    for e in (0.2, 0.7):
        yj = np.asarray(run(jb, jnp.asarray(v), jnp.float32(e)))
        vt = torch.from_numpy(v)
        forms = (e, torch.tensor(e), effort_q16(e, "cpu"))
        ys = [port_fs.mxu_matvec(tb, vt, f, 0, tau=FULL_TAU) for f in forms]
        for y in ys:
            torch.testing.assert_close(y, ys[0], rtol=0, atol=0)
        assert cos(yj, ys[0].numpy()) > 0.9999, (e, cos(yj, ys[0]))


def test_mxu_matvec_stream_length_bounds():
    """C, the streamed chunk count: 1 for an empty selection, nc at full
    effort and coverage, never more than nc. CPU calls count no launch."""
    _, tb = _containers("int8")
    launches = LAUNCHES["mxu_matvec"]
    zero = torch.zeros(IN)
    y, C = port_fs.mxu_matvec(tb, zero, 0.5, 0, return_len=True)
    assert int(C) == 1 and float(y.abs().max()) == 0.0
    v = torch.from_numpy(_v(5))
    _, C = port_fs.mxu_matvec(tb, v, 1.0, 0, tau=FULL_TAU, return_len=True)
    assert int(C) == tb.n_chunks
    _, C = port_fs.mxu_matvec(tb, v, 0.3, 0, tau=2.0, return_len=True)
    assert int(C) == tb.n_chunks
    assert LAUNCHES["mxu_matvec"] == launches


@pytest.mark.parametrize("nc,sms", [(8, 132), (32, 132), (112, 132),
                                    (200, 132), (13, 4), (7, 3)])
def test_select_plan_owns_every_chunk_once(nc, sms):
    """K1's selection grid: at most one block an SM, none without a chunk,
    every chunk owned by exactly one block, in order."""
    plan = port_fs.select_plan(nc, sms)
    assert len(plan) == min(nc, sms)
    assert all(c1 > c0 for c0, c1 in plan)
    owned = [c for c0, c1 in plan for c in range(c0, c1)]
    assert owned == list(range(nc))


@pytest.mark.parametrize("in_dim,dtype", [(896, "int8"), (1664, "int4"),
                                          (1664, "bf16")])
def test_mxu_matvec_ref_uneven_chunks_matches_jax(in_dim, dtype):
    """The plain version against JAX's mxu_matvec (interpret) at chunk
    counts (7 or 13 chunks of 128 rows) that do not divide evenly over the
    selection's blocks (select_plan at 4 SMs): C within 1..nc and y within
    cos 0.9999 at tau = 1. The plain version has no block split; this holds
    the function that the kernel's uneven split must give, and the card
    test test_mxu_matvec_grid_selection_matches_plain runs the split."""
    rng = np.random.default_rng(in_dim)
    wt = (rng.standard_normal((in_dim, OUT)) * 0.02).astype(np.float32)
    jb = jax_bucketize(jnp.asarray(wt), JaxBucketConfig(
        bucket_size=1, chunk_rows=128, dtype=dtype))
    tb = bucketed_from_numpy(jax_bm_to_numpy(jb))
    assert tb.n_chunks % len(port_fs.select_plan(tb.n_chunks, 4))
    v = rng.standard_normal(in_dim).astype(np.float32)
    for effort in (0.3, 0.8):
        yj = jax_mxu_matvec(jb, jnp.asarray(v), effort, 0, tau=FULL_TAU,
                            interpret=True)
        yt, C = port_fs.mxu_matvec_ref(tb, torch.from_numpy(v), effort, 0,
                                       tau=FULL_TAU, return_len=True)
        assert 1 <= int(C) <= tb.n_chunks
        assert cos(yj, yt.numpy()) > 0.9999, (effort, cos(yj, yt))
