"""Sequence-parallel decode in the port (effort_tpu_torch/parallel/sp.py):
four ranks (gloo, CPU, spawned once for the file) with the KV cache's slots
sharded, against the JAX package's shard_map step on the same weights
(tests/test_parallel_sp.py's cases: 10 steps crossing three shard edges at
effort 1.0, 3 at 0.4; and one with a sliding window), and against the
port's single-device model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models.transformer import init_random_weights
from effort_tpu.models.transformer import make_kv_cache as jax_kv_cache
from effort_tpu.parallel import shard_map
from effort_tpu.parallel import sp as jax_sp
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.parallel import _ranks, multihost, tp
from test_torch_bridge import cos, jax_weights_to_numpy

torch.set_num_threads(2)

N_SP = 4
B4 = dict(bucket_size=4, chunk_rows=8)
TOKENS = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
LOW = [7, 3, 11]
CFG = dict(max_seq_len=16)
WINDOWED = dict(max_seq_len=16, sliding_window=6)
FILL = (6, 3)      # 6 seeded slots; decode from slot 6


def jax_sp_run(cfg_kw: dict, tokens, effort: float):
    """JAX's sp_forward_token in shard_map over tokens ("jnp"): (logits
    [steps, vocab], the global k cache)."""
    cfg = jax_tiny(**cfg_kw)
    w = init_random_weights(cfg, JaxBucketConfig(**B4), seed=0)
    ks, vs = jax_sp.sp_cache_specs()

    def step(w_rep, tok, pos, kc, vc):
        return jax_sp.sp_forward_token(w_rep, cfg, tok, pos, kc, vc,
                                       effort=effort, impl="jnp", n_sp=N_SP)
    fn = jax.jit(shard_map(step, mesh=jax_sp.make_sp_mesh(N_SP),
                           in_specs=(jax_sp.sp_weight_specs(w), P(), P(),
                                     ks, vs),
                           out_specs=(P(), ks, vs)))
    kc, vc = jax_kv_cache(cfg)
    out = []
    for t, tok in enumerate(tokens):
        lg, kc, vc = fn(w, jnp.asarray(tok, jnp.int32),
                        jnp.asarray(t, jnp.int32), kc, vc)
        out.append(np.asarray(lg))
    return np.stack(out), np.asarray(kc.astype(jnp.float32))


def decode(weights, cfg_kw, runs, **kw) -> dict:
    return dict(mode="sp", n=N_SP, cfg=tiny_test_model(**cfg_kw),
                bcfg=BucketConfig(**B4), weights=weights, impl="reference",
                runs=runs, **kw)


@pytest.fixture(scope="module")
def ran():
    jw = jax_weights_to_numpy(init_random_weights(
        jax_tiny(**CFG), JaxBucketConfig(**B4), seed=0))
    jax_out = dict(main=jax_sp_run(CFG, TOKENS, 1.0),
                   low=jax_sp_run(CFG, LOW, 0.4),
                   windowed=jax_sp_run(WINDOWED, TOKENS, 1.0))
    jobs = [
        decode(("numpy", jw), CFG, [dict(effort=1.0, tokens=TOKENS)],
               return_cache=True),
        decode(("numpy", jw), CFG, [dict(effort=0.4, tokens=LOW)]),
        decode(("numpy", jw), WINDOWED, [dict(effort=1.0, tokens=TOKENS)]),
        decode(("seed", 0), CFG, [dict(effort=1.0, tokens=TOKENS),
                                  dict(effort=0.4, tokens=LOW),
                                  dict(effort=0.4, tokens=LOW,
                                       device_pos=True)]),
        decode(("seed", 0), WINDOWED, [dict(effort=1.0, tokens=LOW,
                                            start=FILL[0], n_new=3)],
               fill=FILL),
    ]
    ranks = multihost.spawn(_ranks.run_jobs, N_SP, "gloo", "cpu", jobs,
                            timeout=300)
    return dict(jax=jax_out, ranks=ranks)


def _logits(ranks, job: int, run: int = 0) -> np.ndarray:
    got = [r[job]["runs"][run]["logits"] for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    return got[0]


def _port_single(cfg_kw: dict, tokens, effort: float,
                 fill=None) -> np.ndarray:
    """The port's single-device model of seed 0 teacher-forced over tokens
    (from slot fill[0], over the seeded rows, when given)."""
    cfg = tiny_test_model(**cfg_kw)
    w, _ = tp.make_tp_weights(cfg, BucketConfig(**B4), 1, 0, rank=0,
                              device="cpu")
    kc, vc = _ranks.global_caches(dict(cfg=cfg, fill=fill), "cpu")
    start = fill[0] if fill else 0
    return np.stack([port_tf.forward_token(w, cfg, t, start + p, kc, vc,
                                           effort=effort,
                                           impl="reference").numpy()
                     for p, t in enumerate(tokens)])


def test_sp_decode_matches_single_device(ran):
    """Effort 1.0 over 10 steps (slots in every shard): JAX's logits at
    every step (cos > 0.9999, argmax), the rows on their owners' shards
    (JAX's global cache within rtol 2e-2, atol 2e-3); the port's own
    model against its single-device decode (> 0.9999)."""
    lg, k_jax = ran["jax"]["main"]
    got = _logits(ran["ranks"], 0)
    for t in range(len(TOKENS)):
        assert cos(got[t], lg[t]) > 0.9999, (t, cos(got[t], lg[t]))
        assert int(np.argmax(got[t])) == int(np.argmax(lg[t])), t
    k_port = np.concatenate([r[0]["cache"][0] for r in ran["ranks"]], axis=1)
    np.testing.assert_allclose(k_port[:, :len(TOKENS)],
                               k_jax[:, :len(TOKENS)], rtol=2e-2, atol=2e-3)
    assert not k_port[:, len(TOKENS):].any()
    ref = _port_single(CFG, TOKENS, 1.0)
    own = _logits(ran["ranks"], 3, 0)
    for t in range(len(TOKENS)):
        assert cos(own[t], ref[t]) > 0.9999, (t, cos(own[t], ref[t]))


def test_sp_low_effort(ran):
    """Effort 0.4: replicated weights and local dispatch select as one
    device does: JAX's logits, and the port's single-device ones; a step
    at a 0-d device position gives the int position's logits bit for
    bit."""
    lg, _ = ran["jax"]["low"]
    got = _logits(ran["ranks"], 1)
    for t in range(len(LOW)):
        assert cos(got[t], lg[t]) > 0.9999
        assert int(np.argmax(got[t])) == int(np.argmax(lg[t]))
    ref = _port_single(CFG, LOW, 0.4)
    assert cos(_logits(ran["ranks"], 3, 1)[-1], ref[-1]) > 0.9999
    np.testing.assert_array_equal(_logits(ran["ranks"], 3, 2),
                                  _logits(ran["ranks"], 3, 1))


def test_sp_sliding_window(ran):
    """A 6-slot window over 4-slot shards: JAX's logits at every step (the
    window's edge moving through the shards, a shard fully masked)."""
    lg, _ = ran["jax"]["windowed"]
    got = _logits(ran["ranks"], 2)
    for t in range(len(TOKENS)):
        assert cos(got[t], lg[t]) > 0.9999, (t, cos(got[t], lg[t]))
        assert int(np.argmax(got[t])) == int(np.argmax(lg[t])), t


def test_sp_over_seeded_rows(ran):
    """From slot 6 over 6 seeded rows (the fill chip_smoke uses at full
    size), a 6-slot window, 3 tokens fed and 3 greedy: each step against
    the single-device model over the same rows (> 0.9999)."""
    res = ran["ranks"][0][4]["runs"][0]
    assert res["fed"][:len(LOW)] == LOW and res["steps"] == 6
    ref = _port_single(WINDOWED, res["fed"], 1.0, fill=FILL)
    got = _logits(ran["ranks"], 4)
    for t in range(6):
        assert cos(got[t], ref[t]) > 0.9999, (t, cos(got[t], ref[t]))
