"""The port's ops held against the JAX package on the same numpy inputs:
bucketize, position packing, the effort cutoff, the reference matvec and
the weight-set utilities."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.models import weights as jax_weights
from effort_tpu.ops import effort as jax_effort
from effort_tpu.ops import layouts as jax_layouts
from effort_tpu.ops.bucketize import bucketize as jax_bucketize
from effort_tpu.ops.bucketmul import bucket_matvec_jnp
from effort_tpu_torch.config import BucketConfig
from effort_tpu_torch.models.bridge import bucketed_from_numpy
from effort_tpu_torch.models import weights as port_weights
from effort_tpu_torch.ops import effort as port_effort
from effort_tpu_torch.ops import layouts as port_layouts
from effort_tpu_torch.ops.bucketize import bucketize
from effort_tpu_torch.ops.bucketmul import bucket_matvec, bucket_matvec_ref
from test_torch_bridge import cos, jax_bm_to_numpy, np_of, torch_np

torch.set_num_threads(2)

IN, OUT = 256, 512
# int4 codes may differ by one where |w|/scale sits on a rounding tie and
# the two frameworks' quantile scales differ in the last bit
INT4_TIES_ALLOWED = 8


def _wt(seed, shape=(IN, OUT)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def _cfgs(B, dtype):
    G = 128 if B == 1 else 16
    return (JaxBucketConfig(bucket_size=B, chunk_rows=G, dtype=dtype),
            BucketConfig(bucket_size=B, chunk_rows=G, dtype=dtype))


def _assert_same_layout(jb, tb, dtype):
    for m in port_layouts.META_FIELDS:
        assert getattr(jb, m) == getattr(tb, m), m
    for f in ("pos", "probe_dims"):
        np.testing.assert_array_equal(torch_np(getattr(tb, f)),
                                      np_of(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(tb.probes.numpy(), np_of(jb.probes))
    # stats are f32 means: the reduction order may move the last bit
    np.testing.assert_allclose(tb.stats.numpy(), np_of(jb.stats),
                               rtol=1e-6, atol=0)
    if dtype == "int4":
        np.testing.assert_allclose(tb.scales.numpy(), np_of(jb.scales),
                                   rtol=1e-6, atol=0)
        a = tb.vals_unpacked().numpy().astype(np.int32)
        b = np_of(jb.vals_unpacked()).astype(np.int32)
        assert np.abs(a - b).max() <= 1
        assert (a != b).sum() <= INT4_TIES_ALLOWED, (a != b).sum()
    else:
        np.testing.assert_array_equal(torch_np(tb.vals), np_of(jb.vals))
        if dtype == "int8":
            np.testing.assert_array_equal(tb.scales.numpy(),
                                          np_of(jb.scales))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_bucketize_matches_jax(dtype, B):
    wt = _wt(0)
    jcfg, tcfg = _cfgs(B, dtype)
    jb = jax_bucketize(jnp.asarray(wt), jcfg, keep_dense=True)
    tb = bucketize(torch.from_numpy(wt), tcfg, keep_dense=True)
    _assert_same_layout(jb, tb, dtype)
    np.testing.assert_array_equal(torch_np(tb.dense), np_of(jb.dense))


@pytest.mark.parametrize("B", [1, 4])
def test_bucketize_permutations_match_jax(B):
    """Baked in_perm/out_perm on a two-instance tensor (per-instance
    permutations), and the run-time act_rms permutation."""
    rng = np.random.default_rng(5)
    wt = _wt(1, (2, IN, OUT))
    in_perm = np.stack([rng.permutation(IN) for _ in range(2)]).astype(
        np.int32)
    out_perm = rng.permutation(OUT).astype(np.int32)
    jcfg, tcfg = _cfgs(B, "int8")
    jb = jax_bucketize(jnp.asarray(wt), jcfg, in_perm=in_perm,
                       out_perm=out_perm)
    tb = bucketize(torch.from_numpy(wt), tcfg, in_perm=in_perm,
                   out_perm=out_perm)
    _assert_same_layout(jb, tb, "int8")
    rms = np.exp(rng.standard_normal(IN)).astype(np.float32)
    jb = jax_bucketize(jnp.asarray(wt), jcfg, act_rms=rms)
    tb = bucketize(torch.from_numpy(wt), tcfg, act_rms=torch.from_numpy(rms))
    _assert_same_layout(jb, tb, "int8")
    np.testing.assert_array_equal(tb.seg_order.numpy(), np_of(jb.seg_order))


@pytest.mark.parametrize("B", [2, 4, 8, 16, 32])
def test_pack_positions_match_jax(B):
    rng = np.random.default_rng(B)
    pos = rng.integers(0, B if B < 16 else 16, (3, 8, 256)).astype(np.int8)
    packed = port_layouts.pack_positions(torch.from_numpy(pos), B)
    np.testing.assert_array_equal(
        packed.numpy(),
        np.asarray(jax_layouts.pack_positions(jnp.asarray(pos), B)))
    np.testing.assert_array_equal(
        port_layouts.unpack_positions(packed, B).numpy(), pos)


def _ulps(a, b):
    a = np.asarray(a, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("effort", [0.05, 0.25, 0.5, 0.9, 1.0])
def test_cutoff_and_rank_counts_match_jax(effort):
    rng = np.random.default_rng(11)
    vs = rng.standard_normal(1024).astype(np.float32)
    probes = (rng.standard_normal(1024) * 0.02).astype(np.float32)
    for jf, tf in ((jax_effort.compute_cutoff, port_effort.compute_cutoff),
                   (jax_effort.compute_cutoff_exact,
                    port_effort.compute_cutoff_exact)):
        cj = jf(jnp.asarray(vs), jnp.asarray(probes), effort)
        ct = tf(torch.from_numpy(vs), torch.from_numpy(probes), effort)
        assert _ulps(cj, ct.numpy()) <= 1, (jf.__name__, cj, ct)
    stats = np.abs(rng.standard_normal((1024, 4))).astype(np.float32)
    stats = -np.sort(-stats, axis=1)
    cut = np.float32(np.asarray(cj))
    np.testing.assert_array_equal(
        port_effort.row_rank_counts(torch.from_numpy(vs),
                                    torch.from_numpy(stats),
                                    torch.tensor(cut)).numpy(),
        np.asarray(jax_effort.row_rank_counts(jnp.asarray(vs),
                                              jnp.asarray(stats), cut)))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_reference_matvec_matches_jax(dtype, B):
    """Port "reference" == JAX bucket_matvec_jnp on the same container,
    with the kernels' approximate cutoff and with the exact one."""
    wt = _wt(2)
    v = np.random.default_rng(7).standard_normal(IN).astype(np.float32)
    jcfg, _ = _cfgs(B, dtype)
    jb = jax_bucketize(jnp.asarray(wt), jcfg)
    tb = bucketed_from_numpy(jax_bm_to_numpy(jb))
    for effort in (0.25, 0.6):
        yj = bucket_matvec_jnp(jb, jnp.asarray(v), effort,
                               exact_cutoff=False)
        yt = bucket_matvec(tb, torch.from_numpy(v), effort,
                           impl="reference")
        assert cos(yj, yt.numpy()) > 0.99999, (effort, cos(yj, yt))
        yj = bucket_matvec_jnp(jb, jnp.asarray(v), effort)
        yt = bucket_matvec_ref(tb, torch.from_numpy(v), effort)
        assert cos(yj, yt.numpy()) > 0.99999, (effort, cos(yj, yt))


@pytest.mark.parametrize("B", [1, 4])
def test_truncate_and_dense_match_jax(B):
    """truncate_bucketed (row chunks for B=1 on sorted rows, ranks for
    B=4), attach_dense_bucketed and model_weight_bytes."""
    from effort_tpu.config import tiny_test_model
    from effort_tpu_torch.config import tiny_test_model as port_tiny
    wt = _wt(3, (2, 512, OUT))
    pi = np.random.default_rng(9).permutation(512).astype(np.int32)
    jcfg, _ = _cfgs(B, "int8")
    jb = jax_bucketize(jnp.asarray(wt), jcfg, in_perm=pi)
    tb = bucketed_from_numpy(jax_bm_to_numpy(jb))
    jt = jax_weights.truncate_bucketed(jb, 0.5)
    tt = port_weights.truncate_bucketed(tb, 0.5)
    assert (tt.in_dim, tt.n_ranks) == (jt.in_dim, jt.n_ranks)
    for f in ("vals", "pos", "stats", "scales", "probes", "probe_dims"):
        np.testing.assert_array_equal(torch_np(getattr(tt, f)),
                                      np_of(getattr(jt, f)), err_msg=f)
    jd = jax_weights.attach_dense_bucketed(jt)
    td = port_weights.attach_dense_bucketed(tt)
    # equal values (the one-hot sum may give -0.0 where the other gives 0.0)
    np.testing.assert_array_equal(td.dense.float().numpy(),
                                  np.asarray(jd.dense, np.float32))
    bc = BucketConfig(bucket_size=B, dtype="int4")
    assert port_weights.model_weight_bytes(port_tiny(), bc, 0.5) == \
        jax_weights.model_weight_bytes(
            tiny_test_model(), JaxBucketConfig(bucket_size=B, dtype="int4"),
            0.5)


def test_truncate_int4_outliers_match_jax(monkeypatch):
    """A row-prefix int4 container with an outlier table, truncated to half
    its rows: the fields equal JAX's, outliers on dropped rows add 0, and
    bucket_matvec / bucket_matmul and the dense copy agree with JAX: the
    reference routes with its "jnp" route, the kernel routes with its
    "pallas" route (interpret mode)."""
    import effort_tpu.kernels.fused_stream as jax_fused_stream
    from effort_tpu.ops.bucketmul import bucket_matmul as jax_bucket_matmul
    from effort_tpu.ops.bucketmul import bucket_matvec as jax_bucket_matvec
    from effort_tpu_torch.ops.bucketmul import bucket_matmul
    monkeypatch.setattr(jax_fused_stream, "_INTERPRET", True)
    wt = _wt(4, (512, OUT))
    pi = np.random.default_rng(11).permutation(512).astype(np.int32)
    jcfg = JaxBucketConfig(bucket_size=1, chunk_rows=8, dtype="int4",
                           outlier_frac=0.01)
    jb = jax_bucketize(jnp.asarray(wt), jcfg, in_perm=pi)
    tb = bucketed_from_numpy(jax_bm_to_numpy(jb))
    jt = jax_weights.truncate_bucketed(jb, 0.5)
    tt = port_weights.truncate_bucketed(tb, 0.5)
    assert tt.in_dim == jt.in_dim == 256
    assert (tt.outlier_idx[..., 0] >= tt.in_dim).any()   # the case at stake
    for f in ("vals", "pos", "stats", "scales", "probes", "probe_dims",
              "outlier_vals", "outlier_idx"):
        np.testing.assert_array_equal(torch_np(getattr(tt, f)),
                                      np_of(getattr(jt, f)), err_msg=f)
    V = np.random.default_rng(12).standard_normal((3, 512)).astype(np.float32)
    for effort in (0.3, 1.0):
        for jimpl, impl in (("jnp", "reference"), ("pallas", "kernel")):
            for v in V:
                yj = np_of(jax_bucket_matvec(jt, jnp.asarray(v), effort,
                                             impl=jimpl))
                yt = bucket_matvec(tt, torch.from_numpy(v), effort,
                                   impl=impl).numpy()
                assert cos(yj, yt) > 0.9999, (effort, impl, cos(yj, yt))
            Yj = np_of(jax_bucket_matmul(jt, jnp.asarray(V), effort,
                                         impl=jimpl))
            Yt = bucket_matmul(tt, torch.from_numpy(V), effort,
                               impl=impl).numpy()
            for a, b in zip(Yj, Yt):
                assert cos(a, b) > 0.9999, (effort, impl, cos(a, b))
    # the reference route adds the outlier terms exactly: dropping the
    # rows' terms by hand gives the same bits
    y = bucket_matvec_ref(tt, torch.from_numpy(V[0]), 0.5)
    keep = tt.outlier_idx[0, :, 0] < tt.in_dim
    cut = dataclasses.replace(tt, outlier_vals=tt.outlier_vals[:, keep],
                              outlier_idx=tt.outlier_idx[:, keep])
    torch.testing.assert_close(
        bucket_matvec_ref(cut, torch.from_numpy(V[0]), 0.5), y, rtol=0,
        atol=0)
    np.testing.assert_allclose(
        port_weights.attach_dense_bucketed(tt).dense.float().numpy(),
        np.asarray(jax_weights.attach_dense_bucketed(jt).dense, np.float32),
        rtol=0, atol=0)
