"""Composed 2D parallelism in the port (effort_tpu_torch/parallel/
composed.py): tp x ep (MoE) and tp x sp (sequence-sharded cache over
tp-local heads), ranks spawned once a world size (4, and 8 for tp 2 x sp
4), against the JAX package's shard_map on the same shards and against the
port's single-device model (tests/test_composed.py's cases and bounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.parallel import composed as jax_composed
from effort_tpu.parallel import shard_map
from effort_tpu.parallel import tp as jax_tp
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.transformer import RawWeight
from effort_tpu_torch.parallel import _ranks, composed, ep, multihost, tp
from test_torch_bridge import cos, jax_bm_to_numpy, jax_weights_to_numpy
from test_torch_bridge import torch_np

torch.set_num_threads(2)

B4 = dict(bucket_size=4, chunk_rows=8)
B1 = dict(bucket_size=1, chunk_rows=8)
MOE = dict(n_experts=4, n_experts_per_tok=2)
TOKENS = [3, 5, 7, 100]
SP_TOKENS = [3, 5, 7, 11, 2, 9, 4, 8, 1, 6]      # 10 slots over 8 a rank
SHORT = dict(max_seq_len=16)


def jax_steps(fn, w, cfg, tokens) -> np.ndarray:
    kv = jnp.zeros((cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads,
                    cfg.head_dim), jnp.bfloat16)
    kc = vc = kv
    out = []
    for p, t in enumerate(tokens):
        lg, kc, vc = fn(w, jnp.asarray(t), jnp.asarray(p), kc, vc)
        out.append(np.asarray(lg))
    return np.stack(out)


def jax_tp_ep(effort: float):
    cfg = jax_tiny(**MOE)
    w, cfg_l = jax_composed.make_tp_ep_weights(cfg, JaxBucketConfig(**B4),
                                               2, 2, seed=0)
    kv = P(None, None, "tp", None)

    def step(w_local, tok, pos, kc, vc):
        return jax_composed.tp_ep_forward_token(w_local, cfg_l, tok, pos, kc,
                                                vc, effort=effort,
                                                impl="jnp")
    fn = jax.jit(shard_map(step, mesh=jax_composed.make_tp_ep_mesh(2, 2),
                           in_specs=(jax_composed.tp_ep_specs(w), P(), P(),
                                     kv, kv),
                           out_specs=(P(), kv, kv)))
    return jax_weights_to_numpy(w), jax_steps(fn, w, cfg, TOKENS)


def jax_tp_sp(n_tp: int, n_sp: int, bk: dict, seed: int, effort: float,
              tokens, cfg_kw: dict):
    cfg = jax_tiny(**cfg_kw)
    w, cfg_l = jax_tp.make_tp_weights(cfg, JaxBucketConfig(**bk), n_tp,
                                      seed=seed)
    ks, vs = jax_composed.tp_sp_cache_specs()

    def step(w_local, tok, pos, kc, vc):
        return jax_composed.tp_sp_forward_token(w_local, cfg_l, tok, pos, kc,
                                                vc, effort=effort,
                                                impl="jnp", n_sp=n_sp)
    fn = jax.jit(shard_map(step, mesh=jax_composed.make_tp_sp_mesh(n_tp,
                                                                   n_sp),
                           in_specs=(jax_tp.tp_specs(w), P(), P(), ks, vs),
                           out_specs=(P(), ks, vs)))
    return jax_weights_to_numpy(w), jax_steps(fn, w, cfg, tokens)


def job(mode, n, cfg, bk, weights, runs, **kw):
    return dict(mode=mode, n=n, cfg=cfg, bcfg=BucketConfig(**bk),
                weights=weights, impl="reference", runs=runs, **kw)


FILL = (6, 3)      # 6 seeded slots; decode from slot 6


@pytest.fixture(scope="module")
def ran():
    jx = dict(tp_ep={e: jax_tp_ep(e) for e in (1.0, 0.5)},
              tp_sp=jax_tp_sp(2, 2, B4, 0, 1.0, SP_TOKENS, SHORT),
              tp_sp8=jax_tp_sp(2, 4, B1, 1, 0.5, TOKENS, {}))
    moe, short = tiny_test_model(**MOE), tiny_test_model(**SHORT)
    windowed = tiny_test_model(max_seq_len=16, sliding_window=5)
    runs = [dict(effort=e, tokens=TOKENS) for e in (1.0, 0.5)]
    four = [
        job("tp_ep", (2, 2), moe, B4, ("numpy", jx["tp_ep"][1.0][0]), runs,
            return_cache=True),
        job("tp_ep", (2, 2), moe, B4, ("seed", 0), runs),
        job("tp_sp", (2, 2), short, B4, ("numpy", jx["tp_sp"][0]),
            [dict(effort=1.0, tokens=SP_TOKENS)]),
        job("tp_sp", (2, 2), short, B4, ("seed", 0),
            [dict(effort=1.0, tokens=SP_TOKENS)]),
        job("tp_sp", (2, 2), windowed, B4, ("seed", 0),
            [dict(effort=1.0, tokens=TOKENS, start=FILL[0], n_new=4)],
            fill=FILL),
    ]
    eight = [job("tp_sp", (2, 4), tiny_test_model(), B1,
                 ("numpy", jx["tp_sp8"][0]),
                 [dict(effort=0.5, tokens=TOKENS)])]
    ranks4 = multihost.spawn(_ranks.run_jobs, 4, "gloo", "cpu", four,
                             timeout=300)
    ranks8 = multihost.spawn(_ranks.run_jobs, 8, "gloo", "cpu", eight,
                             timeout=300)
    return dict(jax=jx, r4=ranks4, r8=ranks8)


def _logits(ranks, job: int, run: int = 0) -> np.ndarray:
    got = [r[job]["runs"][run]["logits"] for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    return got[0]


def _single(cfg, tokens, effort: float, fill=None) -> np.ndarray:
    """The port's single-device model of seed 0 teacher-forced over tokens
    (from slot fill[0], over the seeded rows, when given)."""
    w, _ = tp.make_tp_weights(cfg, BucketConfig(**B4), 1, 0, rank=0,
                              device="cpu")
    kc, vc = _ranks.global_caches(dict(cfg=cfg, fill=fill), "cpu")
    start = fill[0] if fill else 0
    return np.stack([port_tf.forward_token(w, cfg, t, start + p, kc, vc,
                                           effort=effort,
                                           impl="reference").numpy()
                     for p, t in enumerate(tokens)])


def _held(a, b, bound: float, argmax: bool = True) -> None:
    for p in range(len(a)):
        assert cos(a[p], b[p]) > bound, (p, cos(a[p], b[p]))
        if argmax:
            assert int(np.argmax(a[p])) == int(np.argmax(b[p])), p


def test_tp_ep_matches_single_device(ran):
    """tp 2 x ep 2 at 1.0: JAX's logits (cos > 0.9999, argmax), the KV rows
    written on every tp rank's heads; the port's shards against its
    single-device model (> 0.999)."""
    lg = _logits(ran["r4"], 0, 0)
    assert lg.shape == (len(TOKENS), tiny_test_model().vocab_size)
    _held(lg, ran["jax"]["tp_ep"][1.0][1], 0.9999)
    for res in ran["r4"]:
        assert np.abs(res[0]["cache"][0][0, 0]).sum() > 0
    _held(_logits(ran["r4"], 1, 0),
          _single(tiny_test_model(**MOE), TOKENS, 1.0), 0.999, argmax=False)


def test_tp_ep_low_effort(ran):
    """Effort 0.5: JAX's logits; per-(ep, tp) cutoffs track the single
    device (> 0.95)."""
    _held(_logits(ran["r4"], 0, 1), ran["jax"]["tp_ep"][0.5][1], 0.9999)
    _held(_logits(ran["r4"], 1, 1),
          _single(tiny_test_model(**MOE), TOKENS, 0.5), 0.95, argmax=False)


def test_tp_sp_matches_single_device(ran):
    """tp 2 x sp 2 over 10 slots (8 a rank: the rows cross the sp edge):
    JAX's logits at every step; the port's against its single-device
    model (> 0.999), also from slot 6 over seeded rows with a 5-slot
    window, 4 steps fed and 4 greedy."""
    _held(_logits(ran["r4"], 2), ran["jax"]["tp_sp"][1], 0.9999)
    short = tiny_test_model(**SHORT)
    _held(_logits(ran["r4"], 3), _single(short, SP_TOKENS, 1.0), 0.999,
          argmax=False)
    res = ran["r4"][0][4]["runs"][0]
    windowed = tiny_test_model(max_seq_len=16, sliding_window=5)
    _held(_logits(ran["r4"], 4),
          _single(windowed, res["fed"], 1.0, fill=FILL), 0.999,
          argmax=False)


def test_tp_sp_low_effort_runs(ran):
    """tp 2 x sp 4 (8 ranks), row-prefix, seed 1, effort 0.5: logits of
    the full vocabulary, finite, JAX's on its shards."""
    lg = _logits(ran["r8"], 0)
    assert lg.shape == (len(TOKENS), tiny_test_model().vocab_size)
    assert np.isfinite(lg).all()
    _held(lg, ran["jax"]["tp_sp8"][1], 0.9999)


@pytest.mark.parametrize("axis", [2, 1], ids=["cols", "rows"])
def test_shard2_experts_match_jax(axis):
    """The port's ep-major, tp-minor expert split on JAX's raw weights
    equals JAX's _shard2_experts; make_tp_ep_weights(rank=None) split by
    tp_ep_local equals rank=r's build."""
    rng = np.random.default_rng(11)
    L, E = 2, 4
    wt = (rng.standard_normal((L * E, 64, 128)) * 0.02).astype(np.float32)
    jb = jax_bm_to_numpy(jax_composed._shard2_experts(
        jnp.asarray(wt), L, 2, 2, axis, JaxBucketConfig(**B4)))
    rw = RawWeight.of(torch.from_numpy(wt))
    key = "cols" if axis == 2 else "rows"
    tb = tp.stack_shards([tp.bucketize_slices(
        rw, BucketConfig(**B4), ep.expert_groups(L, E, 2, e),
        **{key: tp.span(wt.shape[axis], 2, t)})
        for e in range(2) for t in range(2)])
    for f in ("vals", "pos"):
        np.testing.assert_array_equal(torch_np(getattr(tb, f)), jb[f])
    np.testing.assert_allclose(tb.stats.numpy(), jb["stats"], rtol=1e-6)
    cfg, bcfg = tiny_test_model(**MOE), BucketConfig(**B4)
    wg, _ = composed.make_tp_ep_weights(cfg, bcfg, 2, 2, 0, device="cpu")
    for r in range(4):
        a = composed.tp_ep_local(wg, 2, 2, r)
        b, cfg_l = composed.make_tp_ep_weights(cfg, bcfg, 2, 2, 0, rank=r,
                                               device="cpu")
        assert (cfg_l.n_experts, cfg_l.hidden_dim) == (2, cfg.hidden_dim // 2)
        assert torch.equal(a.output, b.output)
        for f in ("wq", "wo", "w1", "w2", "w3"):
            assert torch.equal(getattr(a.layers, f).vals,
                               getattr(b.layers, f).vals), f
