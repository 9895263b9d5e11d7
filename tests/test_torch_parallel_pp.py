"""Pipeline-parallel decode in the port (effort_tpu_torch/parallel/pp.py):
four stages (gloo, CPU, spawned once for the file), M = 4 round-robin
microbatches, against the JAX package's shard_map step on the same stages
(JAX's make_pp_weights carried across) and against the port's
single-device model (tests/test_parallel_pp.py's cases and bounds), and
microbatches of different prompt lengths continued greedily, as chip_smoke
drives them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.parallel import pp as jax_pp
from effort_tpu.parallel import shard_map
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.transformer import RawWeight
from effort_tpu_torch.parallel import _ranks, multihost, pp, tp
from test_torch_bridge import cos, jax_bm_to_numpy, jax_weights_to_numpy
from test_torch_bridge import torch_np

torch.set_num_threads(2)

N_PP = 4
B4 = dict(bucket_size=4, chunk_rows=8)
CFG = dict(n_layers=4, max_seq_len=32)
SEQS = [[3, 1, 4], [1, 5, 9], [2, 6, 5], [8, 9, 7]]
LOW = [[1], [2], [3], [4]]
RAGGED = [[5], [6, 7], [8, 9, 10], [11, 12, 13, 14]]


def jax_pp_side():
    """JAX's weights (numpy) and its step's logits [steps, M, vocab] over
    SEQS at 1.0 and LOW at 0.5."""
    cfg = jax_tiny(**CFG)
    jw, cfg_l = jax_pp.make_pp_weights(cfg, JaxBucketConfig(**B4), N_PP,
                                       seed=0)
    ks, vs = jax_pp.pp_cache_specs()
    out = dict(w=jax_weights_to_numpy(jw))
    for effort, seqs in ((1.0, SEQS), (0.5, LOW)):
        def step(w_local, toks, pos, kc, vc, effort=effort):
            return jax_pp.pp_decode_step(w_local, cfg_l, toks, pos, kc, vc,
                                         effort=effort, impl="jnp",
                                         n_pp=N_PP)
        fn = jax.jit(shard_map(step, mesh=jax_pp.make_pp_mesh(N_PP),
                               in_specs=(jax_pp.pp_specs(jw), P(), P(), ks,
                                         vs),
                               out_specs=(P(), ks, vs)))
        kc, vc = jax_pp.make_pp_caches(cfg, N_PP)
        lg = []
        for t in range(len(seqs[0])):
            y, kc, vc = fn(jw, jnp.asarray([s[t] for s in seqs], jnp.int32),
                           jnp.full((N_PP,), t, jnp.int32), kc, vc)
            lg.append(np.asarray(y))
        out[effort] = np.stack(lg)
    return out


@pytest.fixture(scope="module")
def ran():
    jx = jax_pp_side()

    def job(weights, runs):
        return dict(mode="pp", n=N_PP, cfg=tiny_test_model(**CFG),
                    bcfg=BucketConfig(**B4), weights=weights,
                    impl="reference", runs=runs)
    jobs = [job(("numpy", jx["w"]), [dict(effort=1.0, tokens=SEQS),
                                     dict(effort=0.5, tokens=LOW)]),
            job(("seed", 0), [dict(effort=1.0, tokens=SEQS),
                              dict(effort=0.5, tokens=LOW),
                              dict(effort=1.0, tokens=RAGGED, n_new=2),
                              dict(effort=1.0, tokens=RAGGED, n_new=2,
                                   device_pos=True)])]
    ranks = multihost.spawn(_ranks.run_jobs, N_PP, "gloo", "cpu", jobs,
                            timeout=300)
    return dict(jax=jx, ranks=ranks)


def _logits(ranks, job: int, run: int) -> np.ndarray:
    got = [r[job]["runs"][run]["logits"] for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    return got[0]


def _single(seq, effort: float) -> np.ndarray:
    """The port's single-device model of seed 0 teacher-forced over seq."""
    cfg = tiny_test_model(**CFG)
    w, _ = tp.make_tp_weights(cfg, BucketConfig(**B4), 1, 0, rank=0,
                              device="cpu")
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    return np.stack([port_tf.forward_token(w, cfg, t, p, kc, vc,
                                           effort=effort,
                                           impl="reference").numpy()
                     for p, t in enumerate(seq)])


def test_pp_decode_matches_single_device(ran):
    """Effort 1.0, 3 steps of 4 microbatches: JAX's logits for each
    microbatch and step (cos > 0.9999, argmax); the port's stages against
    each sequence decoded alone on its single-device model (> 0.9999)."""
    got, want = _logits(ran["ranks"], 0, 0), ran["jax"][1.0]
    own = _logits(ran["ranks"], 1, 0)
    assert got.shape == (3, N_PP, tiny_test_model().vocab_size)
    for m, seq in enumerate(SEQS):
        ref = _single(seq, 1.0)
        for t in range(3):
            assert cos(got[t, m], want[t, m]) > 0.9999, (t, m)
            assert int(np.argmax(got[t, m])) == int(np.argmax(want[t, m]))
            assert cos(own[t, m], ref[t]) > 0.9999, (t, m)


def test_pp_low_effort_runs(ran):
    """Effort 0.5: finite, JAX's logits, and microbatch 1 against the
    single-device model (> 0.999)."""
    got = _logits(ran["ranks"], 0, 1)
    assert np.isfinite(got).all()
    for m in range(N_PP):
        assert cos(got[0, m], ran["jax"][0.5][0, m]) > 0.9999
    own = _logits(ran["ranks"], 1, 1)
    assert cos(own[0, 1], _single([2], 0.5)[0]) > 0.999


def test_pp_ragged_prompts_then_greedy(ran):
    """Prompts of 1 to 4 tokens, each continued greedily to 6 steps: every
    microbatch's fed tokens are its prompt then its own argmaxes, and its
    logits track its sequence decoded alone (> 0.9999); positions as
    device tensors give the same bits."""
    res = ran["ranks"][0][1]["runs"][2]
    got = _logits(ran["ranks"], 1, 2)
    assert res["steps"] == 6
    for m, prompt in enumerate(RAGGED):
        fed = res["fed"][m]
        assert fed[:len(prompt)] == prompt and len(fed) == 6
        for t in range(len(prompt), 6):
            assert fed[t] == int(np.argmax(got[t - 1, m]))
        ref = _single(fed, 1.0)
        for t in range(6):
            assert cos(got[t, m], ref[t]) > 0.9999, (t, m)
    np.testing.assert_array_equal(_logits(ran["ranks"], 1, 3), got)


def test_split_layers_match_jax():
    """The port's stage split on JAX's raw weights equals JAX's
    _split_layers_and_bucketize; make_pp_weights(rank=None) split by
    pp_local equals rank=r's build."""
    rng = np.random.default_rng(9)
    L, E = 4, 2
    wt = (rng.standard_normal((L * E, 64, 128)) * 0.02).astype(np.float32)
    jb = jax_bm_to_numpy(jax_pp._split_layers_and_bucketize(
        jnp.asarray(wt), L, N_PP, E, JaxBucketConfig(**B4)))
    rw = RawWeight.of(torch.from_numpy(wt))
    Lh = L // N_PP
    tb = tp.stack_shards([tp.bucketize_slices(
        rw, BucketConfig(**B4), [(p * Lh * E, Lh * E)]) for p in range(N_PP)])
    for f in ("vals", "pos"):
        np.testing.assert_array_equal(torch_np(getattr(tb, f)), jb[f])
    np.testing.assert_allclose(tb.stats.numpy(), jb["stats"], rtol=1e-6)
    cfg, bcfg = tiny_test_model(**CFG), BucketConfig(**B4)
    wg, _ = pp.make_pp_weights(cfg, bcfg, N_PP, 0, device="cpu")
    for r in range(N_PP):
        a = pp.pp_local(wg, N_PP, r)
        b, cfg_l = pp.make_pp_weights(cfg, bcfg, N_PP, 0, rank=r,
                                      device="cpu")
        assert cfg_l.n_layers == 1
        assert torch.equal(a.layers.attn_norm, b.layers.attn_norm)
        for f in ("wq", "wo", "w1", "w2"):
            assert torch.equal(getattr(a.layers, f).vals,
                               getattr(b.layers, f).vals), f
