"""The port's decode engine held against the JAX package's on
tiny_test_model: device-tensor positions, the ring and int8 KV caches,
sampling, penalties, logprobs, dynamic effort and the graph bookkeeping.

The port's "reference" route pairs with JAX's "jnp" (both read every
weight); weights cross from JAX by the bridge. On the CPU the engine
runs its steps eagerly: it never captures a graph (the card tests in
test_torch_cuda.py hold the captured step against the eager one).
Tolerances: logits cos >= 0.9999 between the frameworks (f32 sums in
another order), tokens and predictions equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models import transformer as jax_tf
from effort_tpu.models.generate import Engine as JaxEngine
from effort_tpu.serving.batcher import BatchEngine as JaxBatchEngine
from effort_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from effort_tpu_torch.config import tiny_test_model
from effort_tpu_torch.kernels import (LAUNCHES, add_launches,
                                      launches_since)
from effort_tpu_torch.models import generate as port_gen
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.serving.batcher import BatchEngine, ContinuousBatcher
from test_torch_bridge import cos, jax_weights_to_numpy

# the module (effort_tpu.models exports a function of the same name)
jax_gen = importlib.import_module("effort_tpu.models.generate")
torch.set_num_threads(2)

PROMPT = [1, 5, 9]
TOKENS = [1, 5, 9, 33, 7, 100, 200, 3, 17, 250, 4, 61]
PAD = 8


@pytest.fixture(scope="module")
def model():
    """(JAX weights, port weights): int8 row-prefix, fused, dense copies,
    int8 head. They do not depend on max_seq_len or sliding_window, so
    every config below shares them."""
    jw = jax_tf.quantize_head(jax_tf.init_random_weights(
        jax_tiny(), JaxBucketConfig(bucket_size=1, chunk_rows=128,
                                    dtype="int8"),
        calibrate=True, fuse=True, keep_dense=True))
    return jw, model_weights_from_numpy(jax_weights_to_numpy(jw))


def _jax_steps(jw, jcfg, tokens, kc, vc, hooks=(None, None), effort=0.5):
    out = []
    for p, t in enumerate(tokens):
        lg, kc, vc = jax_tf.forward_token(
            jw, jcfg, jnp.int32(t), jnp.int32(p), kc, vc, effort=effort,
            impl="jnp", kv_update_fn=hooks[0], attn_fn=hooks[1])
        out.append(np.asarray(lg))
    return np.stack(out), kc, vc


def _port_steps(tw, cfg, tokens, kc, vc, hooks=(None, None), effort=0.5,
                as_tensor=False, offset=0):
    """forward_token over tokens at cache slots offset, offset + 1, ...
    (rotary positions 0, 1, ...; slots < offset masked), the position,
    token and offset as ints or as 0-d int32 tensors."""
    def arg(x):
        return torch.tensor(x, dtype=torch.int32) if as_tensor else x
    return torch.stack([port_tf.forward_token(
        tw, cfg, arg(t), arg(p + offset), kc, vc, effort=effort,
        impl="reference", rope_offset=arg(offset), mask_from=arg(offset),
        kv_update_fn=hooks[0], attn_fn=hooks[1])
        for p, t in enumerate(tokens)])


def test_forward_token_tensor_position_matches_int_and_jax(model):
    """A 0-d int32 position (and token, rope_offset, mask_from) gives the
    same bits as ints, logits and cache rows; and JAX's logits at cos >=
    0.9999 a step."""
    jw, tw = model
    cfg = tiny_test_model()
    for offset in (0, 2):
        runs = []
        for as_tensor in (False, True):
            kc, vc = port_tf.make_kv_cache(cfg, "cpu")
            lg = _port_steps(tw, cfg, TOKENS, kc, vc, as_tensor=as_tensor,
                             offset=offset)
            runs.append((lg, kc, vc))
        for a, b in zip(runs[0], runs[1]):
            assert torch.equal(a, b), offset
    lj, _, _ = _jax_steps(jw, jax_tiny(), TOKENS,
                          *jax_tf.make_kv_cache(jax_tiny()))
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    lt = _port_steps(tw, cfg, TOKENS, kc, vc, as_tensor=True).numpy()
    for p in range(len(TOKENS)):
        assert cos(lj[p], lt[p]) >= 0.9999, p


def test_quantize_kv_rows_bit_equal_to_jax():
    """int8 data and f32 scales equal JAX's bit for bit, an all-zero row
    and rows at exact .5 ratios included."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 3, 64))
         * np.exp(rng.standard_normal((6, 3, 1)))).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1] = np.arange(64, dtype=np.float32) - 31.5     # ties at .5
    jq, js = jax_tf.quantize_kv_rows(jnp.asarray(x))
    tq, ts = port_tf.quantize_kv_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_kv_hooks_match_jax(model):
    """The int8 cache's hooks against JAX's, step by step at effort 1.0
    and 0.5 (JAX's tests/test_quant_kv.py is the spec): logits at cos >=
    0.9999 against JAX's int8 steps, and as close to the bf16 cache's as
    JAX's int8 steps are to JAX's bf16 ones (cos within 1e-4); scales
    within 1e-5 and data within one step (the rows come from f32 sums in
    another order) of JAX's; the cache under 0.6x the bf16 bytes."""
    jw, tw = model
    cfg, jcfg = tiny_test_model(max_seq_len=24), jax_tiny(max_seq_len=24)
    ids = list((np.arange(20) * 7 + 3) % cfg.vocab_size)
    for effort in (1.0, 0.5):
        (kq, vq), hooks = (port_tf.make_quant_kv_cache(cfg, "cpu"),
                           port_tf.quant_kv_hooks(cfg))
        lq = _port_steps(tw, cfg, ids, kq, vq, hooks, effort=effort,
                         as_tensor=True).numpy()
        kc, vc = port_tf.make_kv_cache(cfg, "cpu")
        lf = _port_steps(tw, cfg, ids, kc, vc, effort=effort).numpy()
        jkq, jvq = jax_tf.make_quant_kv_cache(jcfg)
        lj, jkq, _ = _jax_steps(jw, jcfg, ids, jkq, jvq,
                                jax_tf.quant_kv_hooks(jcfg), effort=effort)
        ljf, _, _ = _jax_steps(jw, jcfg, ids, *jax_tf.make_kv_cache(jcfg),
                               effort=effort)
        for p in range(len(ids)):
            assert cos(lq[p], lj[p]) >= 0.9999, (effort, p)
            assert cos(lq[p], lf[p]) >= cos(lj[p], ljf[p]) - 1e-4, (
                effort, p)
        np.testing.assert_allclose(kq[1].numpy(), np.asarray(jkq[1]),
                                   rtol=1e-5)
        assert np.abs(kq[0].numpy().astype(np.int32)
                      - np.asarray(jkq[0]).astype(np.int32)).max() <= 1
    assert kq[0].dtype == torch.int8
    q_bytes = kq[0].numel() + kq[1].numel() * 4
    assert q_bytes < 0.6 * kc.numel() * 2


def test_quant_kv_engines_match_jax(model):
    """Engine(quant_kv=True) and BatchEngine(kv_dtype="int8") give JAX's
    tokens (and the engine JAX's per-step predictions) on the same
    requests, on the reference / jnp route at efforts 0.5 and 1.0."""
    jw, tw = model
    cfg, jcfg = tiny_test_model(max_seq_len=64), jax_tiny(max_seq_len=64)
    je = JaxEngine(jw, jcfg, impl="jnp", pad_to=PAD, quant_kv=True,
                   dynamic_effort=True)
    te = Engine(tw, cfg, impl="reference", pad_to=PAD, quant_kv=True,
                device="cpu")
    assert te.kv_mode == "int8"
    for effort in (0.5, 1.0):
        rj = je.generate(PROMPT, n_new=8, effort=effort)
        rt = te.generate(PROMPT, n_new=8, effort=effort)
        assert rt.token_ids == rj.token_ids, effort
        assert rt.predictions == rj.predictions, effort
    prompts, efforts = [[1, 5, 9], [4, 8, 15, 16, 23], [7, 7, 3]], [
        1.0, 0.5, 0.25]
    got = {}
    for kind in ("jax", "port"):
        if kind == "jax":
            be = JaxBatchEngine(jw, jcfg, batch_size=2, pad_to=PAD,
                                impl="jnp", prefill_impl="jnp",
                                kv_dtype="int8")
            cb = JaxBatcher(be)
        else:
            be = BatchEngine(tw, cfg, batch_size=2, pad_to=PAD,
                             impl="reference", prefill_impl="reference",
                             kv_dtype="int8", device="cpu")
            cb = ContinuousBatcher(be)
        res = got.setdefault(kind, {})
        for i, (p, e) in enumerate(zip(prompts, efforts)):
            cb.submit(p, 6, e, lambda toks, i=i, r=res: r.__setitem__(
                i, [int(t) for t in toks]))
        cb.run_until_drained()
    assert got["port"] == got["jax"]


def test_ring_kv_hooks_match_jax(model):
    """The ring cache's hooks step by step past the window (max_seq_len 24,
    window 6, 20 positions; JAX's tests/test_sliding_window.py:152 is the
    spec): logits at cos >= 0.9999 against JAX's ring steps, and within
    2e-3 of the port's full windowed cache; the cache holds the window
    only."""
    jw, tw = model
    cfg = tiny_test_model(max_seq_len=24, sliding_window=6)
    jcfg = jax_tiny(max_seq_len=24, sliding_window=6)
    ids = list((np.arange(20) * 5 + 2) % cfg.vocab_size)
    kr, vr = port_tf.make_ring_kv_cache(cfg, "cpu")
    assert kr.shape[1] == cfg.sliding_window
    lr = _port_steps(tw, cfg, ids, kr, vr, port_tf.ring_kv_hooks(cfg),
                     effort=1.0, as_tensor=True).numpy()
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    lf = _port_steps(tw, cfg, ids, kc, vc, effort=1.0).numpy()
    lj, _, _ = _jax_steps(jw, jcfg, ids, *jax_tf.make_ring_kv_cache(jcfg),
                          jax_tf.ring_kv_hooks(jcfg), effort=1.0)
    for p in range(len(ids)):
        assert cos(lr[p], lj[p]) >= 0.9999, p
    np.testing.assert_allclose(lr, lf, rtol=2e-3, atol=2e-3)


def test_ring_kv_engine_decodes_past_max_seq_len(model):
    """Engine(ring_kv=True) decodes 4 + 24 tokens over max_seq_len 16
    (window 8): JAX's ring engine's tokens and predictions, and those of a
    full-cache engine big enough to hold them; ring_kv needs a window and
    the token loop, and the full cache still refuses the length."""
    jw, tw = model
    small = dict(max_seq_len=16, sliding_window=8)
    big = dict(max_seq_len=64, sliding_window=8)
    prompt = [1, 5, 9, 2]
    rj = JaxEngine(jw, jax_tiny(**small), impl="jnp", pad_to=PAD,
                   ring_kv=True, dynamic_effort=True).generate(
        prompt, n_new=24, effort=1.0)
    ring = Engine(tw, tiny_test_model(**small), impl="reference",
                  pad_to=PAD, ring_kv=True, device="cpu")
    rt = ring.generate(prompt, n_new=24, effort=1.0)
    rf = Engine(tw, tiny_test_model(**big), impl="reference", pad_to=PAD,
                device="cpu").generate(prompt, n_new=24, effort=1.0)
    assert rt.token_ids == rj.token_ids == rf.token_ids
    assert rt.predictions == [int(p) for p in rj.predictions]
    with pytest.raises(ValueError, match="sliding_window"):
        Engine(tw, tiny_test_model(), ring_kv=True, device="cpu")
    with pytest.raises(ValueError, match="token-loop"):
        Engine(tw, tiny_test_model(**small), ring_kv=True, prefill=True,
               device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        Engine(tw, tiny_test_model(**small), device="cpu").generate(
            prompt, n_new=24)


def test_penalties_and_logprobs_match_jax(model):
    """Greedy decode under presence and frequency penalties gives JAX's
    tokens; zero penalties are plain greedy; a huge presence penalty never
    repeats a token; logprobs=3 gives JAX's top-3 ids a token with values
    within 1e-5."""
    jw, tw = model
    cfg, jcfg = tiny_test_model(), jax_tiny()
    je = JaxEngine(jw, jcfg, impl="jnp", pad_to=PAD, dynamic_effort=True)
    te = Engine(tw, cfg, impl="reference", pad_to=PAD, device="cpu")
    for pres, freq in ((0.5, 0.0), (0.3, 0.7), (1e9, 0.0)):
        rj = je.generate(PROMPT, n_new=12, effort=0.5,
                         presence_penalty=pres, frequency_penalty=freq)
        rt = te.generate(PROMPT, n_new=12, effort=0.5,
                         presence_penalty=pres, frequency_penalty=freq)
        assert rt.token_ids == [int(t) for t in rj.token_ids], (pres, freq)
    seen = set(PROMPT)
    for t in rt.token_ids:
        assert t not in seen
        seen.add(t)
    greedy = te.generate(PROMPT, n_new=12, effort=0.5)
    assert te.generate(PROMPT, n_new=12, effort=0.5, presence_penalty=0.0,
                       frequency_penalty=0.0).token_ids == greedy.token_ids
    rj = je.generate(PROMPT, n_new=6, effort=0.5, logprobs=3)
    rt = te.generate(PROMPT, n_new=6, effort=0.5, logprobs=3)
    assert rt.token_ids == [int(t) for t in rj.token_ids]
    assert len(rt.logprobs) == len(rj.logprobs) == 6
    for dt, dj in zip(rt.logprobs, rj.logprobs):
        assert list(dt) == list(dj)
        np.testing.assert_allclose(list(dt.values()), list(dj.values()),
                                   rtol=0, atol=1e-5)


def test_sampling_equivalences_and_seeds(model):
    """temperature 0, top_k=1 and a tiny top_p give the greedy tokens; the
    same seed gives the same tokens; the prefill engine samples too (same
    seed, same tokens; top_k=1 is greedy); new values of temperature,
    top_p and the penalties make no new step key (JAX:
    test_sampling_params_do_not_recompile)."""
    _, tw = model
    cfg = tiny_test_model()
    for prefill in (False, True):
        te = Engine(tw, cfg, pad_to=PAD, prefill=prefill, device="cpu")
        g = te.generate(PROMPT, n_new=8, effort=0.5).token_ids
        assert te.generate(PROMPT, n_new=8, effort=0.5,
                           temperature=0.0).token_ids == g
        assert te.generate(PROMPT, n_new=8, effort=0.5, temperature=1.5,
                           top_k=1, seed=3).token_ids == g
        assert te.generate(PROMPT, n_new=8, effort=0.5, temperature=1.5,
                           top_p=1e-9, seed=3).token_ids == g
        a = te.generate(PROMPT, n_new=8, temperature=0.8, seed=7)
        b = te.generate(PROMPT, n_new=8, temperature=0.8, seed=7)
        assert a.token_ids == b.token_ids and len(a.token_ids) == 8
        n_keys = len(te._states)
        te.generate(PROMPT, n_new=8, temperature=1.3, top_p=0.5, seed=3)
        assert len(te._states) == n_keys
    te = Engine(tw, cfg, pad_to=PAD, device="cpu")
    te.generate(PROMPT, n_new=4, presence_penalty=0.5)
    n_keys = len(te._states)
    te.generate(PROMPT, n_new=4, presence_penalty=0.7, frequency_penalty=0.2)
    assert len(te._states) == n_keys


@pytest.mark.parametrize("top_k", [0, 1, 5, 20])
def test_truncation_matches_jax(monkeypatch, top_k):
    """The kept set after top-k and top-p equals JAX's _pick_token's (its
    categorical draw is patched to record the logits it samples from), on
    a grid of logits, temperatures and top_p."""
    seen = {}

    def record(key, lg):
        seen["lg"] = np.asarray(lg)
        return jnp.argmax(lg)
    monkeypatch.setattr(jax_gen.jax.random, "categorical", record)
    rng = np.random.default_rng(top_k)
    for _ in range(4):
        logits = (rng.standard_normal(64) * rng.uniform(0.5, 4)).astype(
            np.float32)
        for temp in (0.5, 1.3):
            for top_p in (0.3, 0.9, 1.0):
                jax_gen._pick_token(jnp.asarray(logits), jax.random.key(0),
                                    True, top_k, temp, top_p)
                kept = np.isfinite(port_gen._truncated(
                    torch.from_numpy(logits), temp, top_k, top_p).numpy())
                np.testing.assert_array_equal(
                    kept, np.isfinite(seen["lg"]),
                    err_msg=f"{temp} {top_p}")


def _oracle(logits, temp, top_k, top_p):
    """numpy: the truncated softmax _pick_token samples from."""
    lg = logits.astype(np.float64) / temp
    if top_k:
        lg = np.where(lg >= np.sort(lg)[::-1][top_k - 1], lg, -np.inf)
    srt = np.sort(lg)[::-1]
    p = np.exp(srt - srt[0])
    p /= p.sum()
    keep = np.cumsum(p) - p < top_p
    lg = np.where(lg >= srt[keep].min(), lg, -np.inf)
    p = np.exp(lg - lg.max())
    return p / p.sum()


def test_draw_frequencies_match_oracle():
    """4000 draws of the port's _pick_token (one seeded generator) and of
    JAX's (4000 keys) from one logits vector at temperature 0.8, top_k 6,
    top_p 0.9: each within 0.03 total variation of the numpy oracle's
    truncated softmax (the expected distance at 4000 draws is about
    0.01)."""
    logits = np.asarray([2.0, 1.5, 1.4, 1.0, 0.3, 0.2, 0.1, -1.0,
                         -2.0, 0.0, 0.5, 1.2, -0.5, 0.9, 1.9, -3.0],
                        np.float32)
    want = _oracle(logits, 0.8, 6, 0.9)
    n = 4000
    g = torch.Generator().manual_seed(0)
    lt = torch.from_numpy(logits)
    port = [int(port_gen._pick_token(lt, g, True, 6, 0.8, 0.9))
            for _ in range(n)]
    keys = jax.random.split(jax.random.key(0), n)
    draws = jax.vmap(lambda k: jax_gen._pick_token(
        jnp.asarray(logits), k, True, 6, 0.8, 0.9))(keys)
    for name, d in (("port", port), ("jax", np.asarray(draws))):
        freq = np.bincount(np.asarray(d), minlength=len(logits)) / n
        assert 0.5 * np.abs(freq - want).sum() <= 0.03, name
        assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(want)), name


def test_dynamic_effort_engine(model):
    """Engine(dynamic_effort=True): one step key serves every effort (the
    effort always rides as the device tensor); its tokens equal the
    default engine's below the dense switch, and at 1.0 the kernel
    route's, where the default engine takes the dense copies (JAX's
    tests/test_model.py:100); prefill refuses it."""
    _, tw = model
    cfg = tiny_test_model()
    dyn = Engine(tw, cfg, pad_to=PAD, dynamic_effort=True, device="cpu")
    std = Engine(tw, cfg, pad_to=PAD, device="cpu")
    for effort in (0.3, 0.5, 1.0):
        want = (std if effort < 0.999 else Engine(
            tw, cfg, impl="kernel", pad_to=PAD, device="cpu"))
        assert (dyn.generate(PROMPT, n_new=6, effort=effort).token_ids
                == want.generate(PROMPT, n_new=6, effort=effort).token_ids)
    assert len(dyn._states) == 1
    assert (std.generate(PROMPT, n_new=6, effort=1.0).token_ids
            == Engine(tw, cfg, impl="dense", pad_to=PAD,
                      device="cpu").generate(PROMPT, n_new=6).token_ids)
    with pytest.raises(ValueError, match="token-loop"):
        Engine(tw, cfg, dynamic_effort=True, prefill=True, device="cpu")


def test_cpu_engine_never_captures(model):
    """On the CPU the engines run their steps eagerly: no graph, and
    capture=True is refused; the teacher-forced logits of the token loop
    equal forward_token's bit for bit."""
    _, tw = model
    cfg = tiny_test_model()
    te = Engine(tw, cfg, pad_to=PAD, device="cpu")
    te.generate(PROMPT, n_new=4, effort=0.5, temperature=0.7)
    assert te.capture is False and te._graphs == {}
    be = BatchEngine(tw, cfg, batch_size=2, pad_to=PAD, device="cpu")
    be.admit(0, 0, PROMPT, 4, 0.5)
    be.step()
    assert be.capture is False and be._graph is None
    for cls in (Engine, BatchEngine):
        with pytest.raises(ValueError, match="capture"):
            cls(tw, cfg, device="cpu", capture=True)
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    eq = torch.tensor([port_gen._q16(0.5)], dtype=torch.int32)
    want = torch.stack([port_tf.forward_token(tw, cfg, t, p, kc, vc,
                                              effort=eq)
                        for p, t in enumerate(TOKENS)])
    assert torch.equal(te.token_logits(TOKENS, 0.5), want)


def test_launch_bookkeeping():
    """launches_since gives a snapshot's per-kernel delta (kernels with none
    left out) and add_launches counts it again, as a replayed graph does
    once a replay."""
    saved = dict(LAUNCHES)
    try:
        before = dict(LAUNCHES)
        LAUNCHES["mxu_matvec"] += 3
        LAUNCHES["fused_matvec"] += 1
        delta = launches_since(before)
        assert delta == {"mxu_matvec": 3, "fused_matvec": 1}
        LAUNCHES.update(before)
        for _ in range(4):
            add_launches(delta)
        assert LAUNCHES["mxu_matvec"] == before["mxu_matvec"] + 12
        assert LAUNCHES["fused_matvec"] == before["fused_matvec"] + 4
        assert launches_since(dict(LAUNCHES)) == {}
    finally:
        LAUNCHES.update(saved)
