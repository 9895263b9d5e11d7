"""Tensor-parallel decode in the port (effort_tpu_torch/parallel/tp.py): two
ranks (gloo, CPU, spawned once for the file) against the JAX package's
shard_map step on the same shards (JAX's make_tp_weights carried across by
parallel_weights_from_numpy), and the port's own shards against its
single-device model with the JAX tests' bounds (tests/test_parallel.py).
Also the transformer's tp and ffn_fn hooks over a 1-rank group, bit for
bit, and the port's shard builder against JAX's on the same raw weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models.transformer import make_kv_cache as jax_kv_cache
from effort_tpu.parallel import shard_map
from effort_tpu.parallel import tp as jax_tp
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.transformer import RawWeight
from effort_tpu_torch.parallel import _ranks, multihost, tp
from test_torch_bridge import cos, jax_bm_to_numpy, jax_weights_to_numpy
from test_torch_bridge import np_of, torch_np

torch.set_num_threads(2)

N_TP = 2
TOKENS = [3, 17, 200, 5]
B4 = dict(bucket_size=4, chunk_rows=8)
B1 = dict(bucket_size=1, chunk_rows=8)


def jax_tp_logits(bk: dict, effort: float):
    """JAX's tp_forward_token in shard_map over TOKENS (its "jnp" route):
    (global weights as numpy, logits [steps, vocab], k cache)."""
    cfg = jax_tiny()
    jw, cfg_l = jax_tp.make_tp_weights(cfg, JaxBucketConfig(**bk), N_TP,
                                       seed=0)
    kv = P(None, None, "tp", None)

    def step(w_local, tok, pos, kc, vc):
        return jax_tp.tp_forward_token(w_local, cfg_l, tok, pos, kc, vc,
                                       effort=effort, impl="jnp")
    fn = jax.jit(shard_map(step, mesh=jax_tp.make_mesh(1, N_TP),
                           in_specs=(jax_tp.tp_specs(jw), P(), P(), kv, kv),
                           out_specs=(P(), kv, kv)))
    kc, vc = jax_kv_cache(cfg)
    out = []
    for p, t in enumerate(TOKENS):
        lg, kc, vc = fn(jw, jnp.asarray(t), jnp.asarray(p), kc, vc)
        out.append(np.asarray(lg))
    return jax_weights_to_numpy(jw), np.stack(out), np.asarray(
        kc.astype(jnp.float32))


def port_single_logits(bk: dict, effort: float, impl: str,
                       cfg=None) -> np.ndarray:
    """The port's single-device model of seed 0 (make_tp_weights with one
    shard) over TOKENS."""
    cfg = cfg or tiny_test_model()
    w, _ = tp.make_tp_weights(cfg, BucketConfig(**bk), 1, 0, rank=0,
                              device="cpu")
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    return np.stack([port_tf.forward_token(w, cfg, t, p, kc, vc,
                                           effort=effort, impl=impl).numpy()
                     for p, t in enumerate(TOKENS)])


def decode(weights, bk, efforts, impl="reference", **kw) -> dict:
    return dict(mode="tp", n=N_TP, cfg=tiny_test_model(),
                bcfg=BucketConfig(**bk), weights=weights, impl=impl,
                runs=[dict(effort=e, tokens=TOKENS) for e in efforts], **kw)


@pytest.fixture(scope="module")
def ran():
    """JAX's results, then every case's ranks in one spawn."""
    jax_b4 = {e: jax_tp_logits(B4, e) for e in (1.0, 0.5)}
    jax_b1 = jax_tp_logits(B1, 0.5)
    jobs = [
        decode(("numpy", jax_b4[1.0][0]), B4, (1.0, 0.5),
               return_cache=True),
        decode(("numpy", jax_b1[0]), B1, (0.5,)),
        decode(("seed", 0), B4, (1.0, 0.5)),
        decode(("seed", 0), B4, (0.5,), impl="kernel"),
        dict(kind="hooks", cfg=tiny_test_model(), bcfg=BucketConfig(**B4),
             impl="reference", seed=0, tokens=TOKENS),
        dict(kind="hooks", cfg=tiny_test_model(n_experts=4),
             bcfg=BucketConfig(**B1), impl="kernel", seed=1, tokens=TOKENS),
    ]
    ranks = multihost.spawn(_ranks.run_jobs, N_TP, "gloo", "cpu", jobs,
                            timeout=300)
    return dict(jax_b4=jax_b4, jax_b1=jax_b1, ranks=ranks)


def _logits(ranks, job: int, run: int) -> np.ndarray:
    """Rank 0's logits, after checking every rank gave the same."""
    got = [r[job]["runs"][run]["logits"] for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    return got[0]


def _held(a, b, bound: float, argmax: bool = True) -> None:
    for p in range(len(a)):
        assert cos(a[p], b[p]) > bound, (p, cos(a[p], b[p]))
        if argmax:
            assert int(np.argmax(a[p])) == int(np.argmax(b[p])), p


def test_tp_matches_single_device(ran):
    """Effort 1.0: the port's ranks on JAX's shards give JAX's logits (cos
    > 0.9999, argmax) and write the KV cache on every rank's heads; the
    port's own shards track its single-device model (> 0.999)."""
    _held(_logits(ran["ranks"], 0, 0), ran["jax_b4"][1.0][1], 0.9999)
    k_jax = ran["jax_b4"][0.5][2]       # the cache after the job's last run
    for r, res in enumerate(ran["ranks"]):
        kc = res[0]["cache"][0]
        assert np.abs(kc[0, 0]).sum() > 0
        np.testing.assert_allclose(kc[:, :len(TOKENS)],
                                   k_jax[:, :len(TOKENS), r:r + 1],
                                   rtol=2e-2, atol=2e-3)
    _held(_logits(ran["ranks"], 2, 0), port_single_logits(B4, 1.0,
                                                          "reference"),
          0.999, argmax=False)


def test_tp_effort_sweep_quality(ran):
    """Effort 0.5: JAX's logits on its shards; per-shard cutoffs track the
    single-device model (> 0.95)."""
    _held(_logits(ran["ranks"], 0, 1), ran["jax_b4"][0.5][1], 0.9999)
    _held(_logits(ran["ranks"], 2, 1), port_single_logits(B4, 0.5,
                                                          "reference"),
          0.95, argmax=False)


def test_tp_row_prefix_layout(ran):
    """The row-prefix layout (bucket_size 1) shards too: finite logits of
    the full vocabulary, JAX's on its shards."""
    lg = _logits(ran["ranks"], 1, 0)
    assert lg.shape == (len(TOKENS), tiny_test_model().vocab_size)
    assert np.isfinite(lg).all()
    _held(lg, ran["jax_b1"][1], 0.9999)


def test_tp_kernel_route_on_cpu(ran):
    """impl="kernel" on CPU tensors takes the kernels' plain versions (K4
    here) and tracks the single-device model on the same route (> 0.95,
    the JAX tests' low-effort bound)."""
    _held(_logits(ran["ranks"], 3, 0), port_single_logits(B4, 0.5,
                                                          "kernel"),
          0.95, argmax=False)
    assert all(r[3]["runs"][0]["launches"] == {} for r in ran["ranks"])


def test_hooks_over_one_rank_are_bit_for_bit(ran):
    """forward_token with tp over a 1-rank group, or with an ffn_fn that
    is the model's own FFN, and forward_seq with tp, give what they give
    with no hook, bit for bit (dense on the reference route, MoE on the
    kernels' plain versions)."""
    for res in ran["ranks"]:
        for job in (4, 5):
            assert res[job] == {"forward_token_tp": True,
                                "forward_token_ffn_fn": True,
                                "forward_seq_tp": True}, res[job]


@pytest.mark.parametrize("bk", [B4, B1], ids=["B4", "B1"])
def test_split_equals_rank_build(bk):
    """make_tp_weights(rank=None) split by tp_local equals rank=r's build,
    bit for bit, container by container."""
    cfg, bcfg = tiny_test_model(), BucketConfig(**bk)
    wg, _ = tp.make_tp_weights(cfg, bcfg, N_TP, 0, device="cpu")
    for r in range(N_TP):
        a = tp.tp_local(wg, N_TP, r)
        b, _ = tp.make_tp_weights(cfg, bcfg, N_TP, 0, rank=r, device="cpu")
        assert torch.equal(a.output, b.output)
        for f in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
            x, y = getattr(a.layers, f), getattr(b.layers, f)
            for t in ("vals", "pos", "stats", "probes", "probe_dims",
                      "scales"):
                u, v = getattr(x, t), getattr(y, t)
                assert (u is None) == (v is None)
                assert u is None or torch.equal(u, v), (f, t)
            assert (x.in_dim, x.out_dim, x.n_experts) == (y.in_dim, y.out_dim,
                                                          y.n_experts)


@pytest.mark.parametrize("axis", [2, 1], ids=["cols", "rows"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_shards_match_jax(axis, dtype):
    """The port's shard builder on JAX's raw weights equals JAX's
    _shard_and_bucketize, container for container: vals and pos exact,
    stats within 1e-6 relative."""
    rng = np.random.default_rng(5)
    wt = (rng.standard_normal((3, 64, 128)) * 0.02).astype(np.float32)
    jb = jax_tp._shard_and_bucketize(
        jnp.asarray(wt), N_TP, axis, JaxBucketConfig(dtype=dtype, **B4))
    rw = RawWeight.of(torch.from_numpy(wt))
    key = "cols" if axis == 2 else "rows"
    tb = tp.stack_shards([tp.bucketize_slices(
        rw, BucketConfig(dtype=dtype, **B4), [(0, 3)],
        **{key: tp.span(wt.shape[axis], N_TP, p)}) for p in range(N_TP)])
    jd = jax_bm_to_numpy(jb)
    for f in ("vals", "pos"):
        np.testing.assert_array_equal(torch_np(getattr(tb, f)), jd[f])
    np.testing.assert_allclose(tb.stats.numpy(), jd["stats"], rtol=1e-6)
    np.testing.assert_array_equal(tb.probe_dims.numpy(), jd["probe_dims"])
    assert (tb.in_dim, tb.out_dim, tb.n_experts) == (jb.in_dim, jb.out_dim,
                                                     jb.n_experts)
    assert np_of(jb.vals).shape == torch_np(tb.vals).shape
