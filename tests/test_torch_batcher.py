"""Continuous batching in the port: the batched decode step and the
BatchEngine + ContinuousBatcher scheduler, held against the JAX package on
tiny_test_model (the same weights, carried across by the bridge) and
against the port's own single-request engine.

The JAX BatchEngine runs its "jnp" route on the CPU; the port's
counterpart is "reference" (every weight read). On the "kernel" route (K2's
plain version on the CPU) a batch streams the longest slot's prefix, so it
equals single-request decode only at tau = 1, where the extra chunks carry
u = 0; those tests set tau = 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models import transformer as jax_tf
from effort_tpu.serving.batcher import BatchEngine as JaxBatchEngine
from effort_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from effort_tpu_torch.config import tiny_test_model
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels import fused_stream as port_fs
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.ops.effort import effort_q16
from effort_tpu_torch.serving.batcher import BatchEngine, ContinuousBatcher
from effort_tpu_torch.utils import profiling
from test_torch_bridge import cos, jax_weights_to_numpy

torch.set_num_threads(2)

PAD = 8
PROMPTS = [[1, 5, 9], [4, 8, 15, 16, 23], [7, 7, 7, 3]]


def _cfg():
    return tiny_test_model(max_seq_len=64)


@pytest.fixture(scope="module")
def model():
    jw = jax_tf.quantize_head(jax_tf.init_random_weights(
        jax_tiny(max_seq_len=64), JaxBucketConfig(
            bucket_size=1, chunk_rows=128, dtype="int8"),
        calibrate=True, fuse=True, keep_dense=True))
    return jw, model_weights_from_numpy(jax_weights_to_numpy(jw))


@pytest.fixture
def full_tau(monkeypatch):
    monkeypatch.setattr(port_fs, "_TAU", 1.0)


def _serve(tw, prompts, efforts, n_new, batch_size=4, impl="kernel",
           streamed=None):
    """Requests through a port BatchEngine + ContinuousBatcher; returns
    {request index: token ids}."""
    be = BatchEngine(tw, _cfg(), batch_size=batch_size, pad_to=PAD,
                     impl=impl, prefill_impl=impl, device="cpu")
    cb = ContinuousBatcher(be)
    out = {}
    for i, (p, e) in enumerate(zip(prompts, efforts)):
        on_tok = None if streamed is None else streamed.setdefault(
            i, []).append
        cb.submit(p, n_new, e, lambda toks, i=i: out.__setitem__(i, toks),
                  on_token=on_tok)
    cb.run_until_drained()
    return out


def test_forward_token_batch_matches_jax(model):
    """One batched decode step of three slots (own positions, left-pad
    offsets and efforts) against JAX's on the reference / jnp route: logits
    at cos >= 0.9999 per slot with equal argmax (the int8 head on both
    sides), cache rows within 0.02 (bf16, 1 unit in the last place)."""
    jw, tw = model
    cfg, jcfg = _cfg(), jax_tiny(max_seq_len=64)
    toks, pos, offs = [3, 7, 11], [0, 2, 1], [0, 1, 0]
    efforts = np.asarray([1.0, 0.5, 0.25], np.float32)
    L, S, KV, D = cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim
    kb = jnp.zeros((L, 3, S, KV, D), jnp.bfloat16)
    lj, kj, _ = jax_tf.forward_token_batch(
        jw, jcfg, jnp.asarray(toks), jnp.asarray(pos), kb, jnp.zeros_like(kb),
        jnp.asarray(efforts), offs=jnp.asarray(offs), impl="jnp")
    kc, vc = port_tf.make_batch_kv_cache(cfg, 3, "cpu")
    lt = port_tf.forward_token_batch(
        tw, cfg, torch.tensor(toks), torch.tensor(pos), kc, vc,
        torch.from_numpy(efforts), offs=torch.tensor(offs),
        impl="reference")
    lj = np.asarray(lj)
    for s in range(3):
        assert cos(lj[s], lt[s].numpy()) >= 0.9999, s
        assert int(np.argmax(lj[s])) == int(lt[s].argmax())
    np.testing.assert_allclose(kc.float().numpy(),
                               np.asarray(kj.astype(jnp.float32)), atol=0.02)


def test_forward_token_batch_matches_single_stream(model, full_tau):
    """On the kernel route at tau = 1, each slot of a batched step (K2)
    equals forward_token on the single-stream route (K1) at the slot's
    effort over the same cache: cos >= 0.9999 per slot, equal argmax."""
    _, tw = model
    cfg = _cfg()
    toks, pos, offs = [3, 7, 11, 5], [0, 2, 1, 4], [0, 1, 0, 2]
    efforts = [0.25, 0.5, 1.0, 0.0]
    kc, vc = port_tf.make_batch_kv_cache(cfg, 4, "cpu")
    g = torch.Generator().manual_seed(0)
    kc.copy_(torch.randn(kc.shape, generator=g).to(torch.bfloat16))
    vc.copy_(torch.randn(vc.shape, generator=g).to(torch.bfloat16))
    k0, v0 = kc.clone(), vc.clone()
    lb = port_tf.forward_token_batch(tw, cfg, torch.tensor(toks),
                                     torch.tensor(pos), kc, vc,
                                     torch.tensor(efforts),
                                     offs=torch.tensor(offs), impl="kernel")
    for s in range(4):
        ks, vs = k0[:, s].clone(), v0[:, s].clone()
        ls = port_tf.forward_token(tw, cfg, toks[s], pos[s], ks, vs,
                                   effort=effort_q16(efforts[s], "cpu"),
                                   impl="kernel", rope_offset=offs[s],
                                   mask_from=offs[s])
        assert cos(lb[s].numpy(), ls.numpy()) >= 0.9999, s
        assert int(lb[s].argmax()) == int(ls.argmax()), s
        torch.testing.assert_close(kc[:, s], ks, rtol=0, atol=0)


def test_batch_engine_matches_jax(model):
    """Three requests, mixed efforts, through four slots: the tokens equal
    JAX's BatchEngine(impl="jnp", prefill_impl="jnp") on the port's
    reference route."""
    jw, tw = model
    efforts = [1.0, 1.0, 0.6]
    jbe = JaxBatchEngine(jw, jax_tiny(max_seq_len=64), batch_size=4,
                         pad_to=PAD, impl="jnp", prefill_impl="jnp")
    jcb = JaxBatcher(jbe)
    ref = {}
    for i, (p, e) in enumerate(zip(PROMPTS, efforts)):
        jcb.submit(p, 6, e, lambda toks, i=i: ref.__setitem__(i, toks))
    jcb.run_until_drained()
    got = _serve(tw, PROMPTS, efforts, 6, impl="reference")
    assert got == ref


def test_batch_engine_matches_single_requests(model, full_tau):
    """On the kernel route at tau = 1: batched tokens equal single-request
    Engine(prefill=True) tokens at each request's effort, and each token
    is streamed as it lands. CPU tensors count no launch."""
    _, tw = model
    efforts = [0.25, 1.0, 0.5]
    launches = dict(LAUNCHES)
    streamed = {}
    got = _serve(tw, PROMPTS, efforts, 6, streamed=streamed)
    eng = Engine(tw, _cfg(), impl="kernel", prefill=True,
                 prefill_impl="kernel", pad_to=PAD, device="cpu")
    for i, (p, e) in enumerate(zip(PROMPTS, efforts)):
        assert got[i] == eng.generate(p, n_new=6, effort=e).token_ids, i
        assert streamed[i] == got[i]
    assert LAUNCHES == launches


def test_continuous_admission_recycles_slots(model, full_tau):
    """Five requests through two slots: every request completes, and the
    last one, admitted into a recycled slot, equals a fresh single-request
    run."""
    _, tw = model
    prompts = [[1 + i, 2 + i, 3] for i in range(5)]
    got = _serve(tw, prompts, [0.5] * 5, 4, batch_size=2)
    assert sorted(got) == list(range(5))
    assert all(len(t) == 4 for t in got.values())
    ref = Engine(tw, _cfg(), impl="kernel", prefill=True,
                 prefill_impl="kernel", pad_to=PAD, device="cpu").generate(
        prompts[4], n_new=4, effort=0.5).token_ids
    assert got[4] == ref


def test_batch_matches_single_with_window(model, full_tau):
    """A 6-slot sliding window, crossed by prompt plus generation: batched
    tokens equal single-request Engine(prefill=True) tokens (the window
    binds in the batched step's attention and in forward_seq's)."""
    _, tw = model
    cfg = tiny_test_model(max_seq_len=64, sliding_window=6)
    prompts = [[1, 5, 9, 2, 7, 4, 6], [4, 8, 15]]
    be = BatchEngine(tw, cfg, batch_size=2, pad_to=PAD, impl="kernel",
                     prefill_impl="kernel", device="cpu")
    cb = ContinuousBatcher(be)
    got = {}
    for i, p in enumerate(prompts):
        cb.submit(p, 8, 0.5, lambda toks, i=i: got.__setitem__(i, toks))
    cb.run_until_drained()
    eng = Engine(tw, cfg, impl="kernel", prefill=True, prefill_impl="kernel",
                 pad_to=PAD, device="cpu")
    for i, p in enumerate(prompts):
        assert got[i] == eng.generate(p, n_new=8, effort=0.5).token_ids, i


def test_batch_engine_guards(model):
    """kv_dtype="int8" builds the int8 cache; speculative batching
    (spec_k) runs on the bf16 cache and refuses the int8 one (ValueError
    where the JAX package asserts), and counts spec_k positions more
    against the cache; a request longer than the cache is refused, and an
    idle engine's step is a no-op."""
    _, tw = model
    be8 = BatchEngine(tw, _cfg(), kv_dtype="int8", device="cpu")
    assert be8.kv_quant and be8.k_cache[0].dtype == torch.int8
    with pytest.raises(ValueError, match="bf16"):
        BatchEngine(tw, _cfg(), spec_k=4, kv_dtype="int8", device="cpu")
    bs = BatchEngine(tw, _cfg(), batch_size=2, pad_to=PAD, spec_k=4,
                     device="cpu")
    assert bs.spec_k == 4 and bs.spec_out.shape == (2, 5)
    assert bs.step() == []
    with pytest.raises(ValueError, match="spec_k"):
        bs.admit(0, 0, [1, 2, 3], n_new=54)
    be = BatchEngine(tw, _cfg(), batch_size=2, pad_to=PAD, device="cpu")
    assert be.step() == [] and be.free_slots() == [0, 1]
    with pytest.raises(ValueError):
        be.admit(0, 0, [1, 2, 3], n_new=60)


# ---- speculative batching (spec_k > 0) --------------------------------------

SPEC_PROMPTS = [[1, 5, 9], [4, 8, 15, 16, 23]]
SPEC_EFFORTS = [1.0, 0.6]


@pytest.fixture(scope="module")
def rank_model():
    """The JAX package's tests/test_batcher.py model: tiny_test_model
    (max_seq_len=64), BucketConfig(bucket_size=4, chunk_rows=8), seed 0."""
    jw = jax_tf.init_random_weights(
        jax_tiny(max_seq_len=64), JaxBucketConfig(bucket_size=4,
                                                  chunk_rows=8), seed=0)
    return jw, model_weights_from_numpy(jax_weights_to_numpy(jw))


def _serve_jax(jw, **kw):
    jcb, out, streamed = JaxBatcher(JaxBatchEngine(
        jw, jax_tiny(max_seq_len=64), batch_size=2, pad_to=PAD, impl="jnp",
        prefill_impl="jnp", **kw)), {}, {}
    for i, (p, e) in enumerate(zip(SPEC_PROMPTS, SPEC_EFFORTS)):
        jcb.submit(p, 8, e, lambda toks, i=i: out.__setitem__(i, toks),
                   on_token=streamed.setdefault(i, []).append)
    jcb.run_until_drained()
    return out, streamed


def _serve_spec(tw, impl, **kw):
    cb, out, streamed = ContinuousBatcher(BatchEngine(
        tw, _cfg(), batch_size=2, pad_to=PAD, impl=impl, prefill_impl=impl,
        device="cpu", **kw)), {}, {}
    for i, (p, e) in enumerate(zip(SPEC_PROMPTS, SPEC_EFFORTS)):
        cb.submit(p, 8, e, lambda toks, i=i: out.__setitem__(i, toks),
                  on_token=streamed.setdefault(i, []).append)
    cb.run_until_drained()
    return out, streamed


@pytest.mark.parametrize("which", ["rank", "row"])
def test_speculative_batching_matches_plain(model, rank_model, which):
    """The JAX package's test_speculative_batching_matches_plain: with
    spec_k = 4 drafts at 0.3, each slot emits what plain batched decode
    emits at its own effort. The port's reference route gives JAX's
    BatchEngine(spec_k=4, spec_draft_effort=0.3) tokens on the same
    inputs, which are JAX's plain ones, on a rank-prefix and a row-prefix
    model."""
    jw, tw = rank_model if which == "rank" else model
    plain, _ = _serve_jax(jw)
    jspec, _ = _serve_jax(jw, spec_k=4, spec_draft_effort=0.3)
    assert jspec == plain
    got, streamed = _serve_spec(tw, "reference", spec_k=4,
                                spec_draft_effort=0.3)
    assert got == jspec
    assert streamed == got


def test_speculative_batching_kernel_route(model, full_tau):
    """On the kernel route (K2's plain version: drafts over the B slots,
    the verify over the B * spec_k rows) at tau = 1, speculative batching
    gives the plain batched tokens at each slot's effort; CPU tensors
    count no launch."""
    _, tw = model
    launches = dict(LAUNCHES)
    plain, _ = _serve_spec(tw, "kernel")
    for k, de in ((4, 0.3), (3, 1.0)):
        got, streamed = _serve_spec(tw, "kernel", spec_k=k,
                                    spec_draft_effort=de)
        assert got == plain, (k, de)
        assert streamed == got
    assert LAUNCHES == launches


def test_speculative_batching_streams_all_tokens(rank_model):
    """The JAX package's test_speculative_batching_streams_all_tokens:
    every token a speculative step lands is streamed (several a step),
    and the stream is the result, JAX's."""
    jw, tw = rank_model
    jbe = JaxBatchEngine(jw, jax_tiny(max_seq_len=64), batch_size=2,
                         pad_to=PAD, impl="jnp", prefill_impl="jnp",
                         spec_k=4)
    jcb, jstream, jres = JaxBatcher(jbe), [], {}
    jcb.submit([1, 5, 9], 6, 1.0, lambda o: jres.__setitem__(0, o),
               on_token=jstream.append)
    jcb.run_until_drained()
    be = BatchEngine(tw, _cfg(), batch_size=2, pad_to=PAD, impl="reference",
                     prefill_impl="reference", spec_k=4, device="cpu")
    cb, streamed, res, steps = ContinuousBatcher(be), [], {}, [0]
    cb.submit([1, 5, 9], 6, 1.0, lambda o: res.__setitem__(0, o),
              on_token=streamed.append)
    while cb.has_work():
        cb.tick()
        steps[0] += 1
    assert streamed == res[0] == jres[0] == jstream
    assert len(res[0]) == 6 and steps[0] < 5


def test_scheduler_spans_and_counts(model, monkeypatch):
    """Five requests through two slots under recording(): every span of
    the scheduler, with its request's id where it serves one; the
    counts agree with the requests run."""
    monkeypatch.setattr(profiling, "_LOG", profiling._Log())
    _, tw = model
    be = BatchEngine(tw, _cfg(), batch_size=2, pad_to=PAD, device="cpu")
    cb = ContinuousBatcher(be)
    prompts = [[1 + i, 2 + i, 3] + [4] * i for i in range(5)]
    out, rids = {}, []
    with profiling.recording():
        for i, p in enumerate(prompts):
            rids.append(cb.submit(p, 3 + i % 2, 0.5,
                                  lambda t, i=i: out.__setitem__(i, t)))
        cb.run_until_drained()
    spans = profiling.recorded()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert set(by) == {"batcher.tick", "batcher.queued", "batcher.admit",
                       "batcher.admit.launch", "batcher.admit.read",
                       "batcher.step", "batcher.step.launch",
                       "batcher.step.read", "batcher.callback"}
    for name in ("batcher.queued", "batcher.admit", "batcher.admit.launch",
                 "batcher.admit.read"):
        assert sorted(s.rid for s in by[name]) == rids, name
    for s in spans:
        if s.name != "batcher.tick":
            top = s
            while top.parent is not None:
                top = spans[top.parent]
            assert top.name == "batcher.tick", s
    for s in by["batcher.admit.launch"] + by["batcher.admit.read"]:
        assert spans[s.parent].name == "batcher.admit"
    c = cb.counts
    assert c["submitted"] == c["admitted"] == 5
    assert c["prompt_tokens"] == sum(map(len, prompts))
    assert c["tokens"] == sum(len(t) for t in out.values())
    assert c["steps"] == len(by["batcher.step"])
    assert c["live_slot_steps"] == sum(s.attrs["live_slots"]
                                       for s in by["batcher.step"])
    assert c["live_positions"] == sum(s.attrs["live_positions"]
                                      for s in by["batcher.step"])
    assert c["read_positions"] == c["steps"] * 2 * _cfg().max_seq_len
    assert 0 < c["live_positions"] < c["read_positions"]
    waits = [s.t1 - s.t0 for s in by["batcher.queued"]]
    assert min(waits) >= 0
    assert c["queue_wait_s"] == pytest.approx(sum(waits))


def test_scheduler_counts_without_spans(model):
    """With spans off the counts are kept all the same, and nothing is
    logged."""
    _, tw = model
    before = profiling._LOG.added
    be = BatchEngine(tw, _cfg(), batch_size=2, pad_to=PAD, device="cpu")
    cb = ContinuousBatcher(be)
    got = []
    for p in PROMPTS:
        cb.submit(p, 2, 0.5, got.append)
    cb.run_until_drained()
    assert profiling._LOG.added == before
    assert cb.counts["admitted"] == 3 and cb.counts["queue_wait_s"] >= 0
    assert cb.counts["tokens"] == sum(map(len, got)) == 6


def test_step_positions_leave_out_the_left_pad(model, monkeypatch):
    """BatchEngine.positions: each live slot's position + 1 less its left
    pad, over every slot's whole cache; the step span carries the same."""
    monkeypatch.setattr(profiling, "_LOG", profiling._Log())
    _, tw = model
    be = BatchEngine(tw, _cfg(), batch_size=3, pad_to=PAD, device="cpu")
    be.admit(0, 0, [1, 2, 3], 4, 0.5)
    be.admit(2, 1, [4, 5, 6, 7, 8], 4, 0.5)
    want = ((3 + 1) + (5 + 1), 3 * _cfg().max_seq_len)
    assert be.positions(be.active()) == want
    with profiling.recording():
        be.step()
    (step,) = [s for s in profiling.recorded() if s.name == "batcher.step"]
    assert step.attrs == {"live_slots": 2, "live_positions": want[0],
                          "read_positions": want[1]}
    assert be.positions(be.active())[0] == want[0] + 2
