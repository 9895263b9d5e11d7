"""Expert-parallel MoE in the port (effort_tpu_torch/parallel/ep.py): four
ranks (gloo, CPU, spawned once for the file), decode (owner mask + psum)
and the all-to-all token batch, against the JAX package's shard_map on the
same shards (JAX's make_ep_weights carried across) and against the port's
single-device model, with tests/test_parallel_ep.py's cases and bounds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models.transformer import make_kv_cache as jax_kv_cache
from effort_tpu.parallel import ep as jax_ep
from effort_tpu.parallel import shard_map
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.transformer import RawWeight
from effort_tpu_torch.parallel import _ranks, ep, multihost, tp
from test_torch_bridge import cos, jax_bm_to_numpy, jax_weights_to_numpy
from test_torch_bridge import torch_np

torch.set_num_threads(2)

N_EP = 4
B4 = dict(bucket_size=4, chunk_rows=8)
MOE = dict(n_experts=4, n_experts_per_tok=2)
TOKENS = [3, 7, 100, 42]
T = 16
# (layer, capacity factor, X seed, zero gate): tests/test_parallel_ep.py's
# three token cases
CASES = {"tokens": (1, 4.0, 42, False), "drop": (0, 0.75, 1, False),
         "imbalance": (0, 1.0, 3, True)}


def _x(seed: int) -> np.ndarray:
    k = jax.random.normal(jax.random.key(seed), (T, jax_tiny().dim),
                          jnp.float32) * 0.05
    return np.asarray(k)


def jax_ep_side():
    """JAX's weights (numpy), decode logits at 1.0 and 0.5 over TOKENS,
    and each token case's (output, dropped per rank)."""
    cfg = jax_tiny(**MOE)
    jw, cfg_l = jax_ep.make_ep_weights(cfg, JaxBucketConfig(**B4), N_EP,
                                       seed=0)
    mesh = jax_ep.make_ep_mesh(N_EP)
    out = dict(w=jax_weights_to_numpy(jw))
    for effort in (1.0, 0.5):
        def step(w_local, tok, pos, kc, vc, effort=effort):
            return jax_ep.ep_forward_token(w_local, cfg_l, tok, pos, kc, vc,
                                           effort=effort, impl="jnp",
                                           n_ep=N_EP)
        fn = jax.jit(shard_map(step, mesh=mesh,
                               in_specs=(jax_ep.ep_specs(jw), P(), P(), P(),
                                         P()),
                               out_specs=(P(), P(), P())))
        kc, vc = jax_kv_cache(cfg)
        lg = []
        for p, t in enumerate(TOKENS):
            y, kc, vc = fn(jw, jnp.asarray(t), jnp.asarray(p), kc, vc)
            lg.append(np.asarray(y))
        out[effort] = np.stack(lg)
    for name, (l, cf, seed, zero) in CASES.items():
        w = jw
        if zero:
            w = dataclasses.replace(jw, layers=dataclasses.replace(
                jw.layers, ffn_gate=jnp.zeros_like(jw.layers.ffn_gate)))

        def ffn(w_local, xs, l=l, cf=cf):
            return jax_ep.ep_ffn_tokens(w_local.layers, jnp.asarray(l),
                                        xs, 1.0, cfg_l, N_EP, "jnp",
                                        capacity_factor=cf,
                                        return_stats=True)
        fn = jax.jit(shard_map(ffn, mesh=mesh,
                               in_specs=(jax_ep.ep_specs(w), P("ep")),
                               out_specs=(P("ep"), P("ep"))))
        y, dropped = fn(w, jnp.asarray(_x(seed)))
        out[name] = (np.asarray(y), np.asarray(dropped))
    return out


def _cases():
    return [dict(X=_x(seed), layer=l, capacity_factor=cf, zero_gate=zero)
            for l, cf, seed, zero in CASES.values()]


def _routing_of(seq, effort: float) -> np.ndarray:
    """The single-device model's experts over seq ([steps, layers, k])."""
    cfg, w = _single()
    seen, route0 = [], port_tf.route

    def record(*args):
        gates, idx = route0(*args)
        seen.append(idx.numpy())
        return gates, idx
    port_tf.route = record
    try:
        kc, vc = port_tf.make_kv_cache(cfg, "cpu")
        for p, t in enumerate(seq):
            port_tf.forward_token(w, cfg, t, p, kc, vc, effort=effort,
                                  impl="reference")
    finally:
        port_tf.route = route0
    return np.stack(seen).reshape(len(seq), cfg.n_layers, -1)


def decode(weights, impl="reference") -> dict:
    return dict(mode="ep", n=N_EP, cfg=tiny_test_model(**MOE),
                bcfg=BucketConfig(**B4), weights=weights, impl=impl,
                runs=[dict(effort=1.0, tokens=TOKENS, record_routing=True),
                      dict(effort=0.5, tokens=TOKENS)],
                ffn_tokens=_cases())


@pytest.fixture(scope="module")
def ran():
    jx = jax_ep_side()
    jobs = [decode(("numpy", jx["w"])), decode(("seed", 0))]
    ranks = multihost.spawn(_ranks.run_jobs, N_EP, "gloo", "cpu", jobs,
                            timeout=300)
    return dict(jax=jx, ranks=ranks)


def _logits(ranks, job: int, run: int) -> np.ndarray:
    got = [r[job]["runs"][run]["logits"] for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    return got[0]


def _tokens(ranks, job: int, case: int):
    """(every rank's outputs in token order, dropped per rank)."""
    res = [r[job]["ffn_tokens"][case] for r in ranks]
    return (np.concatenate([c["y"] for c in res]),
            np.array([c["dropped"] for c in res]))


def _single():
    cfg = tiny_test_model(**MOE)
    w, _ = tp.make_tp_weights(cfg, BucketConfig(**B4), 1, 0, rank=0,
                              device="cpu")
    return cfg, w


def _port_single_logits(effort: float) -> np.ndarray:
    cfg, w = _single()
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    return np.stack([port_tf.forward_token(w, cfg, t, p, kc, vc,
                                           effort=effort,
                                           impl="reference").numpy()
                     for p, t in enumerate(TOKENS)])


def _held(a, b, bound: float, argmax: bool = True) -> None:
    for p in range(len(a)):
        assert cos(a[p], b[p]) > bound, (p, cos(a[p], b[p]))
        if argmax:
            assert int(np.argmax(a[p])) == int(np.argmax(b[p])), p


def test_ep_decode_matches_single_device(ran):
    """Effort 1.0: JAX's logits (cos > 0.9999, argmax); the port's ranks
    against its single-device model (> 0.9999), with its experts."""
    _held(_logits(ran["ranks"], 0, 0), ran["jax"][1.0], 0.9999)
    _held(_logits(ran["ranks"], 1, 0), _port_single_logits(1.0), 0.9999,
          argmax=False)
    # the experts each step routed to, as a run records them, are the
    # single-device model's
    np.testing.assert_array_equal(ran["ranks"][0][1]["runs"][0]["routing"],
                                  _routing_of(TOKENS, 1.0))


def test_ep_decode_low_effort(ran):
    """Effort 0.5: the experts' containers are slices of the single-device
    model's, so the selection matches it (> 0.999); JAX's logits."""
    _held(_logits(ran["ranks"], 0, 1), ran["jax"][0.5], 0.9999)
    _held(_logits(ran["ranks"], 1, 1), _port_single_logits(0.5), 0.999,
          argmax=False)


def _per_token_ffn(l: int, X: np.ndarray, zero_gate: bool = False):
    """The single-device model's MoE FFN a token at a time (no capacity)."""
    cfg, w = _single()
    lw = w.layers
    if zero_gate:
        lw = dataclasses.replace(lw, ffn_gate=torch.zeros_like(lw.ffn_gate))
    pe = port_tf.proj_efforts(1.0, cfg)
    return np.stack([port_tf._ffn(lw, l, torch.tensor(x), pe, cfg,
                                  "reference").numpy() for x in X])


def test_ep_all_to_all_tokens(ran):
    """16 tokens, 4 a rank, capacity factor 4 (nothing dropped): JAX's
    outputs, and the port's against the per-token FFN (> 0.9999)."""
    y, dropped = _tokens(ran["ranks"], 0, 0)
    assert y.shape == (T, tiny_test_model().dim)
    assert cos(y.ravel(), ran["jax"]["tokens"][0].ravel()) > 0.9999
    assert (dropped == 0).all()
    y_own, _ = _tokens(ran["ranks"], 1, 0)
    ref = _per_token_ffn(1, _x(42))
    assert cos(y_own.ravel(), ref.ravel()) > 0.9999


def test_ep_all_to_all_capacity_drop(ran):
    """Capacity factor 0.75: JAX's drops, rank by rank, and its outputs;
    finite, and still near the undropped FFN (> 0.8)."""
    y, dropped = _tokens(ran["ranks"], 0, 1)
    jy, jd = ran["jax"]["drop"]
    np.testing.assert_array_equal(dropped, jd)
    assert dropped.sum() > 0
    assert np.isfinite(y).all()
    assert cos(y.ravel(), jy.ravel()) > 0.9999
    y_own, _ = _tokens(ran["ranks"], 1, 1)
    assert cos(y_own.ravel(), _per_token_ffn(0, _x(1)).ravel()) > 0.8


def test_ep_imbalance_drop_accounting(ran):
    """A zero gate sends every token to experts 0 and 1: exactly
    n_ep * 2 * (Tl - C) drops (JAX's, rank by rank), and the output is the
    capacity-bounded sum (the first C tokens of a rank keep both experts at
    gate 0.5, the rest get 0), for JAX's shards and the port's own."""
    Tl, k, E = T // N_EP, 2, MOE["n_experts"]
    C = -(-Tl * k // E)
    for job in (0, 1):
        y, dropped = _tokens(ran["ranks"], job, 2)
        assert dropped.sum() == N_EP * 2 * (Tl - C)
        if job == 0:
            np.testing.assert_array_equal(dropped, ran["jax"]["imbalance"][1])
            assert cos(y.ravel(),
                       ran["jax"]["imbalance"][0].ravel()) > 0.9999
        else:
            ref = _per_token_ffn(0, _x(3), zero_gate=True)
            ref[(np.arange(T) % Tl) >= C] = 0.0
            assert cos(y.ravel(), ref.ravel()) > 0.9999
            assert not y[(np.arange(T) % Tl) >= C].any()
        for r, res in enumerate(ran["ranks"]):
            experts = res[job]["ffn_tokens"][2]["experts"]
            assert (np.sort(experts, axis=1) == [0, 1]).all()


def test_split_experts_match_jax():
    """The port's expert split on JAX's raw weights equals JAX's
    _split_experts_and_bucketize, container for container."""
    rng = np.random.default_rng(7)
    L, E = 2, 4
    wt = (rng.standard_normal((L * E, 64, 128)) * 0.02).astype(np.float32)
    jb = jax_bm_to_numpy(jax_ep._split_experts_and_bucketize(
        jnp.asarray(wt), L, N_EP, JaxBucketConfig(dtype="int8", **B4)))
    rw = RawWeight.of(torch.from_numpy(wt))
    tb = tp.stack_shards([tp.bucketize_slices(
        rw, BucketConfig(dtype="int8", **B4), ep.expert_groups(L, E, N_EP, p))
        for p in range(N_EP)])
    for f in ("vals", "pos"):
        np.testing.assert_array_equal(torch_np(getattr(tb, f)), jb[f])
    np.testing.assert_allclose(tb.stats.numpy(), jb["stats"], rtol=1e-6)
    np.testing.assert_allclose(tb.scales.numpy(), jb["scales"], rtol=1e-6)
    assert tb.n_experts == jb["n_experts"] == L * E // N_EP


def test_split_equals_rank_build():
    """make_ep_weights(rank=None) split by ep_local equals rank=r's build
    bit for bit; each rank's expert containers are the single-device
    model's instances l * E + r * E_loc + j."""
    cfg, bcfg = tiny_test_model(**MOE), BucketConfig(**B4)
    wg, _ = ep.make_ep_weights(cfg, bcfg, N_EP, 0, device="cpu")
    _, w1 = _single()
    E_loc = MOE["n_experts"] // N_EP
    for r in range(N_EP):
        a = ep.ep_local(wg, N_EP, r)
        b, cfg_l = ep.make_ep_weights(cfg, bcfg, N_EP, 0, rank=r,
                                      device="cpu")
        assert cfg_l.n_experts == E_loc
        for f in ("wq", "wo", "w1", "w2", "w3"):
            assert torch.equal(getattr(a.layers, f).vals,
                               getattr(b.layers, f).vals), f
            assert torch.equal(getattr(a.layers, f).stats,
                               getattr(b.layers, f).stats), f
        inst = [l * MOE["n_experts"] + r * E_loc + j
                for l in range(cfg.n_layers) for j in range(E_loc)]
        assert torch.equal(b.layers.w2.stats, w1.layers.w2.stats[inst])
