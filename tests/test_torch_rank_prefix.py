"""The rank-prefix stream (bucket_size >= 2) of the port against the JAX
package on the same containers: select_stream, the plain versions of K4
(fused_matvec) and K5 (stream_matvec) against the JAX kernels run in Pallas
interpret mode, and bucket_matvec's "kernel", "stream" and "gather" routes
against JAX's "pallas", "stream" and "gather".

JAX's fused_matvec takes interpret mode from its module flag; its
stream_matvec and gather_matvec_dma have no such flag, so those tests patch
jax.experimental.pallas.pallas_call to pass interpret=True (the JAX package
itself is unchanged). On the CPU the port's wrappers run the plain versions;
the CUDA kernels are held against those on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

import effort_tpu.kernels.fused_stream as jax_fs
import effort_tpu.kernels.prefix_stream as jax_ps
from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.ops.bucketize import bucketize as jax_bucketize
from effort_tpu.ops.bucketize import calib_row_order as jax_calib_row_order
from effort_tpu.ops.bucketmul import bucket_matvec as jax_bucket_matvec
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels import fused_stream as port_fs
from effort_tpu_torch.kernels import prefix_stream as port_ps
from effort_tpu_torch.models.bridge import bucketed_from_numpy
from effort_tpu_torch.ops.bucketmul import bucket_matvec
from test_torch_bridge import cos, jax_bm_to_numpy

torch.set_num_threads(2)

IN, OUT, G, TGB = 256, 512, 16, 8
EFFORT = 0.4        # P * effort (P = 256) is not near a rounding boundary
# The bar for a plain version against the JAX kernel: both sum the same
# products in f32, in other orders
COS, REL = 0.99999, 1e-5


def containers(dtype, seed=0, percent_load=1.0, outlier_frac=0.0, B=4,
               chunk_rows=G):
    """(JAX container, port container, v): a calibrated row order (rows by
    descending rms, v scaled to match), so each rank's selection sits at
    its slab's front and tau < 1 truncates; bucket size B, chunk_rows rows
    a chunk."""
    rng = np.random.default_rng(seed)
    rms = np.exp(rng.standard_normal(IN) * 1.2).astype(np.float32)
    pi = np.asarray(jax_calib_row_order(jnp.asarray(rms)))
    wt = (rng.standard_normal((IN, OUT)) * 0.02).astype(np.float32)
    jb = jax_bucketize(jnp.asarray(wt), JaxBucketConfig(
        bucket_size=B, chunk_rows=chunk_rows, dtype=dtype,
        percent_load=percent_load,
        outlier_frac=outlier_frac), in_perm=pi)
    v = (rms[pi] * rng.standard_normal(IN)).astype(np.float32)
    return jb, bucketed_from_numpy(jax_bm_to_numpy(jb)), v


def assert_close(yj, yt, cos_min=COS, rel=REL):
    yj, yt = np.asarray(yj), np.asarray(yt)
    err = np.abs(yj - yt).max()
    assert cos(yj, yt) >= cos_min and err <= rel * np.abs(yj).max(), \
        (cos(yj, yt), err, np.abs(yj).max())


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode: the fused kernel by its
    module flag, the others through a patched pallas_call."""
    monkeypatch.setattr(jax_fs, "_INTERPRET", True)
    call = jax_pallas.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return call(*args, **kw)
    monkeypatch.setattr(jax_pallas, "pallas_call", interpreted)


@pytest.mark.parametrize("dtype,tau,percent_load", [
    ("bf16", 1.0, 1.0), ("bf16", 0.97, 1.0), ("int8", 1.0, 1.0),
    ("int8", 0.97, 0.5), ("int4", 1.0, 1.0), ("int4", 0.97, 1.0)])
def test_select_stream_matches_jax(dtype, tau, percent_load):
    """cum_tiles and base_blocks equal JAX's, u_scaled within 1e-6
    relative (percent_load 0.5 keeps K = 2 of B = 4 ranks)."""
    jb, tb, v = containers(dtype, percent_load=percent_load)
    for e in (0.25, EFFORT):
        sj = jax_ps.select_stream(jb, jnp.asarray(v), e, 0,
                                  tile_blocks=TGB, tau=tau)
        st = port_ps.select_stream(tb, torch.from_numpy(v), e, 0,
                                   tile_blocks=TGB, tau=tau)
        np.testing.assert_array_equal(st.cum_tiles.numpy(),
                                      np.asarray(sj.cum_tiles))
        np.testing.assert_array_equal(st.base_blocks.numpy(),
                                      np.asarray(sj.base_blocks))
        np.testing.assert_allclose(st.u_scaled.numpy(),
                                   np.asarray(sj.u_scaled), rtol=1e-6,
                                   atol=0)
    assert st.u_scaled.shape == (tb.n_ranks, IN // G, G)


def jax_k4_lengths(jb, v, effort, tau):
    """C_k as JAX's fused kernel computes it (fused_stream.py:157-186): its
    own _vec_cutoff and _prefix_len (f32 masses, a triangular matmul) on
    the same container, outside the kernel."""
    from effort_tpu.ops.layouts import strided_sample
    K, nc = jb.n_ranks, jb.n_chunks
    vp = jnp.asarray(v)
    vs = strided_sample(vp, jb.in_dim, jb.probes.shape[1])
    P = vs.shape[0]
    scores = jnp.abs(vs * jb.probes[0]).reshape(P // 128, 128)
    kq = float(min(max(round(P * effort), 1), P))
    cutoff = jax_fs._vec_cutoff(scores, kq, jnp.max(scores) + 1e-30)
    absv = jnp.abs(vp).reshape(nc, G)
    st = jb.stats[0].T.reshape(K, nc, G)
    n = sum((st[k] * absv > cutoff).astype(jnp.int32) for k in range(K))
    return [int(jax_fs._prefix_len(jnp.sum(jnp.where(
        n > k, st[k] * absv, 0.0), axis=1, keepdims=True), tau)[0])
        for k in range(K)]


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("tau", [1.0, 0.97])
def test_fused_matvec_plain_matches_jax_interpret(dtype, tau):
    """K4's plain version against JAX's fused_matvec in interpret mode: C_k
    per rank equal to what JAX's kernel computes (its f32 sums against the
    port's f64 ones; none differed on these inputs), the tiles their
    round-up, y at cos >= 0.99999 and max|dy| <= 1e-5 max|y_ref|."""
    jb, tb, v = containers(dtype, seed=1)
    yj = jax_fs.fused_matvec(jb, jnp.asarray(v), EFFORT, 0, tau=tau,
                             tile_blocks=TGB, interpret=True)
    yt, C, sel = port_fs.fused_matvec(tb, torch.from_numpy(v), EFFORT, 0,
                                      TGB, tau, return_selection=True)
    assert_close(yj, yt)
    assert C.tolist() == jax_k4_lengths(jb, v, EFFORT, tau)
    np.testing.assert_array_equal(
        sel.cum_tiles.numpy(), np.concatenate([[0], np.cumsum(
            (C.numpy() + TGB - 1) // TGB)]))
    if tau < 1:
        # the calibrated order lets tau truncate: fewer tiles than all
        assert int(sel.cum_tiles[-1]) < tb.n_ranks * tb.n_chunks // TGB


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("tau", [1.0, 0.97])
def test_stream_matvec_plain_matches_jax_interpret(interpret, dtype, tau):
    """K5's plain version against JAX's stream_matvec in interpret mode on
    one selection (JAX's, carried across): cos >= 0.99999, max|dy| <=
    1e-5 max|y_ref|. On CPU tensors the wrapper counts no launch."""
    jb, tb, v = containers(dtype, seed=2)
    sj = jax_ps.select_stream(jb, jnp.asarray(v), EFFORT, 0,
                              tile_blocks=TGB, tau=tau)
    yj = jax_ps.stream_matvec(jb, sj, TGB)
    st = port_ps.StreamSelection(*(torch.from_numpy(np.array(a))
                                   for a in sj))
    before = dict(LAUNCHES)
    yt = port_ps.stream_matvec(tb, st, TGB)
    assert LAUNCHES == before
    assert_close(yj, yt)
    torch.testing.assert_close(yt, port_ps.stream_matvec_ref(tb, st, TGB),
                               rtol=0, atol=0)


def test_k5_on_k4_selection_equals_k4():
    """K5 run on the selection K4 computed gives K4's y (JAX's
    test_fused_matches_v3_on_tpu holds the two at atol 1e-5)."""
    _, tb, v = containers("int8", seed=3)
    for tau in (1.0, 0.97):
        y4, _, sel = port_fs.fused_matvec(tb, torch.from_numpy(v), 0.25, 0,
                                          TGB, tau, return_selection=True)
        torch.testing.assert_close(port_ps.stream_matvec(tb, sel, TGB), y4,
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,percent_load,outlier_frac", [
    ("bf16", 1.0, 0.0), ("int8", 0.5, 0.0), ("int4", 1.0, 0.01)])
def test_bucket_matvec_routes_match_jax(interpret, dtype, percent_load,
                                        outlier_frac):
    """Port "kernel" (K4), "stream" (K5) and "gather" (K6) against JAX's
    "pallas", "stream" and "gather" in interpret mode, at the default tau:
    cos >= 0.99999, max|dy| <= 1e-5 max|y_ref| (K < B at percent_load 0.5;
    int4 with the exact outlier table, which the gather refuses on both
    sides)."""
    jb, tb, v = containers(dtype, seed=4, percent_load=percent_load,
                           outlier_frac=outlier_frac)
    for jimpl, timpl in (("pallas", "kernel"), ("stream", "stream"),
                         ("gather", "gather")):
        if dtype == "int4" and jimpl == "gather":
            with pytest.raises(ValueError):
                bucket_matvec(tb, torch.from_numpy(v), EFFORT, impl=timpl)
            continue
        yj = jax_bucket_matvec(jb, jnp.asarray(v), EFFORT, impl=jimpl)
        yt = bucket_matvec(tb, torch.from_numpy(v), EFFORT, impl=timpl)
        assert_close(yj, yt)


def test_rank_prefix_routes_on_the_cpu():
    """The router on a rank-prefix container: "auto" is the kernel route
    (K4's plain version on the CPU), "plain" equals it, "kernel" takes K5
    where K4's selection limits fail, the gather route wants a python float
    effort; on a row-prefix container "stream" is the reference route (as
    the JAX package's "stream" takes its "jnp" there) and "gather" has no
    block list (JAX's fails there too)."""
    _, tb, v = containers("int8", seed=5)
    vt = torch.from_numpy(v)
    y = bucket_matvec(tb, vt, EFFORT)
    torch.testing.assert_close(y, bucket_matvec(tb, vt, EFFORT,
                                                impl="kernel"),
                               rtol=0, atol=0)
    torch.testing.assert_close(y, bucket_matvec(tb, vt, EFFORT,
                                                impl="plain"),
                               rtol=0, atol=0)
    assert port_fs.supports_fused(tb)
    port_fs_limit = port_fs._MAX_MASSES
    try:
        port_fs._MAX_MASSES = 8           # K4's selection cannot hold it
        assert not port_fs.supports_fused(tb)
        ys = bucket_matvec(tb, vt, EFFORT, impl="kernel")
    finally:
        port_fs._MAX_MASSES = port_fs_limit
    torch.testing.assert_close(ys, bucket_matvec(tb, vt, EFFORT,
                                                 impl="stream"),
                               rtol=0, atol=0)
    with pytest.raises(TypeError):
        bucket_matvec(tb, vt, torch.tensor(EFFORT), impl="gather")
    wt = torch.randn((IN, OUT)) * 0.02
    from effort_tpu_torch.config import BucketConfig
    from effort_tpu_torch.ops.bucketize import bucketize
    b1 = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=128))
    torch.testing.assert_close(
        bucket_matvec(b1, vt, EFFORT, impl="stream"),
        bucket_matvec(b1, vt, EFFORT, impl="reference"), rtol=0, atol=0)
    with pytest.raises(ValueError):
        bucket_matvec(b1, vt, EFFORT, impl="gather")
    # a width the kernels' 16-byte rows cannot take: "auto" is the reference
    b_odd = bucketize(torch.randn((IN, 40)) * 0.02,
                      BucketConfig(bucket_size=4, chunk_rows=G))
    assert port_ps.body_limits(b_odd, TGB * G) is not None
    torch.testing.assert_close(
        bucket_matvec(b_odd, vt, EFFORT),
        bucket_matvec(b_odd, vt, EFFORT, impl="reference"), rtol=0, atol=0)


@pytest.mark.parametrize("name,in_dim,out_dim,col_blocks", [
    ("wqkv", 4096, 6144, 3), ("wo", 4096, 4096, 2), ("w13", 4096, 28672, 14),
    ("w2", 14336, 4096, 2)])
def test_stream_plan_at_mistral_widths(name, in_dim, out_dim, col_blocks):
    """The ring stream's launch shape at the four Mistral-7B projections (B
    = 4, G = 16, K = 4; the container's widths stood in on a small one): a
    producer warp beside four consumer warps, column blocks that cover the
    position row, and splits that keep every block resident (at most
    _RING_BLOCKS in all) and at most one a tile."""
    import dataclasses
    _, tb, _ = containers("int8")
    B, K = tb.bucket_size, tb.n_ranks
    prow = -(-(out_dim // B) * 2 // 8 // 128) * 128   # 2-bit positions
    bm = dataclasses.replace(
        tb, in_dim=in_dim, out_dim=out_dim,
        pos=torch.zeros((1, 1, prow), dtype=torch.uint8))
    threads, cb, splits = port_ps.stream_plan(bm, TGB)
    n_work = K * (in_dim // G) // TGB
    assert threads == 32 * 5
    assert cb == col_blocks
    assert cb * 32 * port_ps.cols_per_thread(B, True) >= prow
    assert splits == max(1, min(n_work, port_ps._RING_BLOCKS // cb))
    assert cb * splits <= port_ps._RING_BLOCKS


def test_plain_stream_takes_the_plan(monkeypatch):
    """The plain stream adds its splits as the kernel does: it takes the
    split count from stream_plan, so another plan gives another order of
    sums (and the same value to rounding)."""
    _, tb, v = containers("int8", seed=5)
    sel = port_ps.select_stream(tb, torch.from_numpy(v), 0.5, 0, TGB)
    y = port_ps.stream_matvec_ref(tb, sel, TGB)
    seen = []
    plan = port_ps.stream_plan

    def one_split(bm, tile_blocks):
        seen.append(tile_blocks)
        return plan(bm, tile_blocks)[:2] + (1,)
    monkeypatch.setattr(port_ps, "stream_plan", one_split)
    y1 = port_ps.stream_matvec_ref(tb, sel, TGB)
    assert seen == [TGB]
    assert plan(tb, TGB)[2] > 1
    torch.testing.assert_close(y1, y, rtol=1e-5, atol=1e-6)
