"""The port's ChatSession held against the JAX package's on tiny_test_model:
the eight behaviours of JAX's tests/test_session.py, then parity: greedy
and penalized tokens, positions and history equal JAX's over three turns
(row-prefix int8 and B = 4), the ring session across its wrap, session
files read across the two packages, and sampled turns by kept set and
draw frequencies (torch's Philox draws are not JAX's threefry draws).

The port's "reference" route pairs with JAX's "jnp"; weights cross by the
bridge. On the CPU every step runs eagerly; the card test at the end holds
the captured turn against capture=False. Tolerances: tokens, positions and
history equal (exact); session files carry the caches bit for bit.
"""

import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models import transformer as jax_tf
from effort_tpu.models.session import ChatSession as JaxSession
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.models.session import ChatSession, live_positions
from effort_tpu_torch.models.transformer import init_random_weights
from effort_tpu_torch.utils import profiling
from test_torch_bridge import jax_weights_to_numpy

torch.set_num_threads(2)

TURNS = ([1, 5, 9], [7, 2], [3, 3, 4, 8, 11])
CPU = dict(impl="reference", device="cpu")


@pytest.fixture(scope="module")
def model():
    """The port's own B = 4 model (JAX's test_session fixture's config)."""
    cfg = tiny_test_model(max_seq_len=96)
    w = init_random_weights(cfg, BucketConfig(bucket_size=4, chunk_rows=8),
                            seed=0, device="cpu")
    return cfg, w


def _pair(B: int):
    """(JAX weights, port weights) of one int8 model: row-prefix fused and
    calibrated (B = 1) or rank-prefix (B = 4); keep_dense, so effort 1.0
    takes the dense copies under "auto". The weights do not depend on
    max_seq_len or sliding_window, so every config below shares them."""
    bc = JaxBucketConfig(bucket_size=B, chunk_rows=128 if B == 1 else 8,
                         dtype="int8")
    jw = jax_tf.init_random_weights(jax_tiny(), bc, calibrate=B == 1,
                                    fuse=B == 1, keep_dense=True)
    return jw, model_weights_from_numpy(jax_weights_to_numpy(jw))


@pytest.fixture(scope="module")
def pairs():
    return {B: _pair(B) for B in (1, 4)}


# ---- JAX's tests/test_session.py, on the port --------------------------

def test_turn_spans(model, monkeypatch):
    """A turn and a continue_turn under recording(): session.turn with
    session.launch and session.read inside; its live positions the sum of
    each step's position + 1 from the turn's first position, its read
    positions every slot of the cache each step."""
    monkeypatch.setattr(profiling, "_LOG", profiling._Log())
    cfg, w = model
    s = ChatSession(w, cfg, pad_to=4, **CPU)
    s.turn([1, 5, 9], n_new=4, effort=0.6)
    pos0 = s.pos
    with profiling.recording():
        s.turn([7, 2], n_new=3, effort=0.6)
        s.continue_turn(n_new=2, effort=0.6)
    spans = profiling.recorded()
    assert [(x.name, x.parent) for x in spans] == [
        ("session.turn", None), ("session.launch", 0), ("session.read", 0),
        ("session.turn", None), ("session.launch", 3), ("session.read", 3)]
    slots = cfg.max_seq_len
    first, cont = spans[0].attrs, spans[3].attrs
    assert first == {
        "live_positions": sum(p + 1 for p in range(pos0, pos0 + 5)),
        "read_positions": 5 * slots}
    assert cont == {
        "live_positions": sum(p + 1 for p in range(pos0 + 5, pos0 + 7)),
        "read_positions": 2 * slots}


@pytest.mark.parametrize("pos0,n,slots", [(0, 1, 8), (0, 8, 8), (3, 4, 8),
                                          (5, 9, 8), (9, 3, 8), (7, 1, 8)])
def test_live_positions_closed_form(pos0, n, slots):
    """The closed form against the sum it stands for (a ring of `slots`
    holds at most that many)."""
    assert live_positions(pos0, n, slots) == sum(
        min(pos0 + i + 1, slots) for i in range(n))


def test_pad_invariance(model):
    """Outputs do not depend on the prompt padding bucket."""
    cfg, w = model
    outs = [ChatSession(w, cfg, pad_to=p, **CPU).turn([1, 5, 9], n_new=5,
                                                      effort=0.6)
            for p in (4, 16)]
    assert outs[0] == outs[1], outs


def test_multi_turn_positions(model):
    """Turn 2 continues from the cache; positions advance by every
    consumed and generated token."""
    cfg, w = model
    s = ChatSession(w, cfg, pad_to=4, **CPU)
    s.turn([1, 5, 9], n_new=4, effort=1.0)
    assert s.pos == 3 + 4
    out2 = s.turn([7, 2], n_new=4, effort=1.0)
    assert s.pos == 3 + 4 + 2 + 4
    assert len(out2) <= 4


def test_save_resume(tmp_path, model):
    cfg, w = model
    s = ChatSession(w, cfg, pad_to=4, **CPU)
    s.turn([1, 5, 9], n_new=4, effort=1.0)
    s.save(str(tmp_path / "sess"))
    s2 = ChatSession.load(str(tmp_path / "sess"), w, cfg, pad_to=4, **CPU)
    assert s2.pos == s.pos and s2.history == s.history
    assert s.turn([7, 2], n_new=4, effort=1.0) == s2.turn([7, 2], n_new=4,
                                                          effort=1.0)


def test_ring_session_matches_full_cache():
    """A ring_kv session equals a full-cache session under the same window
    while it runs past max_seq_len; the ring holds sliding_window slots."""
    bcfg = BucketConfig(bucket_size=4, chunk_rows=8)
    cfg_ring = tiny_test_model(max_seq_len=16, sliding_window=8)
    cfg_full = tiny_test_model(max_seq_len=96, sliding_window=8)
    w = init_random_weights(cfg_ring, bcfg, seed=0, device="cpu")
    s_ring = ChatSession(w, cfg_ring, pad_to=4, ring_kv=True, **CPU)
    s_full = ChatSession(w, cfg_full, pad_to=4, **CPU)
    for turn in ([1, 5, 9], [7, 2], [3, 3, 4, 8]):
        assert s_ring.turn(turn, n_new=6) == s_full.turn(turn, n_new=6)
    assert s_ring.pos > cfg_ring.max_seq_len
    assert s_ring.k_cache.shape[1] == cfg_ring.sliding_window


def test_ring_session_save_resume(tmp_path):
    cfg = tiny_test_model(max_seq_len=16, sliding_window=8)
    w = init_random_weights(cfg, BucketConfig(bucket_size=4, chunk_rows=8),
                            seed=0, device="cpu")
    s = ChatSession(w, cfg, pad_to=4, ring_kv=True, **CPU)
    s.turn([1, 5, 9, 2, 6], n_new=8)              # wraps the ring
    s.save(str(tmp_path / "rs"))
    s2 = ChatSession.load(str(tmp_path / "rs"), w, cfg, pad_to=4, **CPU)
    assert s2.ring_kv and s2.pos == s.pos
    assert s.turn([7, 2], n_new=4) == s2.turn([7, 2], n_new=4)


def test_session_sampling_and_penalties(model):
    cfg, w = model
    a = ChatSession(w, cfg, pad_to=4, **CPU).turn(
        [1, 5, 9], n_new=8, temperature=0.8, seed=3)
    b = ChatSession(w, cfg, pad_to=4, **CPU).turn(
        [1, 5, 9], n_new=8, temperature=0.8, seed=3)
    assert a == b and len(a) == 8                 # deterministic per seed
    pen = ChatSession(w, cfg, pad_to=4, **CPU).turn(
        [1, 5, 9], n_new=10, presence_penalty=1e9)
    # all generated tokens distinct (the greedy turn-boundary token is
    # counted too before the penalized steps)
    assert len(set(pen)) == len(pen), pen


def test_turn_stream_matches_turn(model):
    """Chunked streaming yields exactly the unsplit turn's tokens."""
    cfg, w = model
    s1 = ChatSession(w, cfg, pad_to=4, **CPU)
    full = s1.turn([1, 5, 9], n_new=12)
    s2 = ChatSession(w, cfg, pad_to=4, **CPU)
    chunks = list(s2.turn_stream([1, 5, 9], n_new=12, chunk=5))
    assert [len(c) for c in chunks] == [5, 5, 2]
    assert [t for c in chunks for t in c] == full
    assert s2.pos == s1.pos and s2.history == s1.history


def test_session_reset(model):
    cfg, w = model
    s = ChatSession(w, cfg, pad_to=4, **CPU)
    a = s.turn([1, 5, 9], n_new=6)
    s.turn([7, 2], n_new=4)
    s.reset()
    assert s.pos == 0 and s.history == []
    assert s.turn([1, 5, 9], n_new=6) == a   # a fresh conversation


# ---- parity with the JAX package ---------------------------------------

@pytest.mark.parametrize("B", [1, 4])
def test_turns_match_jax(pairs, B):
    """Three turns: greedy at 0.5, greedy at 1.0 (the dense copies under
    "auto"), then with presence and frequency penalties at 0.5 (counts
    over the whole history plus the boundary token), and a penalized
    continue_turn: tokens, pos and history equal JAX's after each."""
    jw, tw = pairs[B]
    pen = dict(presence_penalty=0.5, frequency_penalty=0.3)
    js = JaxSession(jw, jax_tiny(max_seq_len=96), impl="jnp", pad_to=8)
    ts = ChatSession(tw, tiny_test_model(max_seq_len=96), pad_to=8, **CPU)
    for turn, effort, kw in zip(TURNS, (0.5, 1.0, 0.5), ({}, {}, pen)):
        a = js.turn(turn, n_new=6, effort=effort, **kw)
        b = ts.turn(turn, n_new=6, effort=effort, **kw)
        assert a == b, (turn, effort, kw, a, b)
        assert ts.pos == js.pos and ts.history == js.history
    a = js.continue_turn(n_new=6, effort=0.5, **pen)
    assert ts.continue_turn(n_new=6, effort=0.5, **pen) == a
    assert ts.pos == js.pos and ts.history == js.history


def test_eos_cut_matches_jax(pairs):
    """Generation does not stop at EOS: pos advances by the full n_new
    while the tokens and the history are cut after EOS (eos_id set to a
    token the model emits)."""
    jw, tw = pairs[1]
    probe = JaxSession(jw, jax_tiny(max_seq_len=96), impl="jnp", pad_to=8)
    eos = probe.turn([1, 5, 9], n_new=6, effort=0.5)[2]
    js = JaxSession(jw, jax_tiny(max_seq_len=96), impl="jnp", pad_to=8,
                    eos_id=eos)
    ts = ChatSession(tw, tiny_test_model(max_seq_len=96), pad_to=8,
                     eos_id=eos, **CPU)
    a = js.turn([1, 5, 9], n_new=6, effort=0.5)
    assert ts.turn([1, 5, 9], n_new=6, effort=0.5) == a
    assert a[-1] == eos and len(a) < 6
    assert ts.pos == js.pos == 3 + 6 and ts.history == js.history
    b = js.continue_turn(n_new=3, effort=0.5)
    assert ts.continue_turn(n_new=3, effort=0.5) == b


def test_ring_session_matches_jax(pairs):
    """A ring session over a 8-slot window crosses its wrap (and
    max_seq_len 16) with JAX's tokens and positions."""
    jw, tw = pairs[4]
    js = JaxSession(jw, jax_tiny(max_seq_len=16, sliding_window=8),
                    impl="jnp", pad_to=8, ring_kv=True)
    ts = ChatSession(tw, tiny_test_model(max_seq_len=16, sliding_window=8),
                     pad_to=8, ring_kv=True, **CPU)
    for turn in TURNS:
        assert ts.turn(turn, n_new=5, effort=0.5) == js.turn(
            turn, n_new=5, effort=0.5)
        assert ts.pos == js.pos
    assert ts.pos > 16


@pytest.mark.parametrize("ring", [False, True])
def test_session_files_cross_packages(tmp_path, pairs, ring):
    """A session saved by JAX loads in the port (and one saved by the port
    in JAX): the cache rows bit for bit, pos and history equal, and the
    next turn gives the other package's tokens."""
    kw = dict(max_seq_len=16, sliding_window=8) if ring else dict(
        max_seq_len=96)
    jw, tw = pairs[4]
    jcfg, cfg = jax_tiny(**kw), tiny_test_model(**kw)
    js = JaxSession(jw, jcfg, impl="jnp", pad_to=8, ring_kv=ring)
    js.turn([1, 5, 9, 2, 6], n_new=6, effort=0.5)
    js.save(str(tmp_path / "jax"))
    ts = ChatSession.load(str(tmp_path / "jax"), tw, cfg, pad_to=8, **CPU)
    assert ts.ring_kv == ring and ts.pos == js.pos
    assert ts.history == js.history
    rows = ts.k_cache.shape[1] if ring else js.pos + 1
    np.testing.assert_array_equal(
        ts.k_cache[:, :rows].view(torch.uint16).numpy(),
        np.asarray(js.k_cache[:, :rows]).view(np.uint16))
    ts.save(str(tmp_path / "port"))
    js2 = JaxSession.load(str(tmp_path / "port"), jw, jcfg, impl="jnp",
                          pad_to=8)
    assert js2.ring_kv == ring and js2.pos == js.pos
    a = js.turn([7, 2], n_new=6, effort=0.5)
    assert ts.turn([7, 2], n_new=6, effort=0.5) == a
    assert js2.turn([7, 2], n_new=6, effort=0.5) == a


def test_sampled_turns_kept_set_and_frequencies(pairs):
    """Sampled turns (top_k 3, temperature 1): the first token is the
    greedy one, as in JAX; every later token lies in the top 3 of its
    step's logits (teacher-forced through Engine.token_logits over the
    session's tokens); 400 one-token continuations from one state draw
    each kept token with the softmax frequency of the top 3 (total
    variation <= 0.08; 400 draws of 3 outcomes: ~4 sigma); seeds repeat."""
    jw, tw = pairs[1]
    cfg = tiny_test_model(max_seq_len=96)
    js = JaxSession(jw, jax_tiny(max_seq_len=96), impl="jnp", pad_to=8)
    ts = ChatSession(tw, cfg, pad_to=8, **CPU)
    samp = dict(temperature=1.0, top_k=3, seed=5)
    a = js.turn([1, 5, 9], n_new=8, effort=0.5, **samp)
    b = ts.turn([1, 5, 9], n_new=8, effort=0.5, **samp)
    assert a[0] == b[0]                           # greedy boundary token
    eng = Engine(tw, cfg, impl="reference", device="cpu")
    logits = eng.token_logits([1, 5, 9] + b, effort=0.5).numpy()
    for i, t in enumerate(b[1:]):
        top3 = np.argsort(-logits[3 + i])[:3]
        assert t in top3, (i, t, top3)
    s2 = ChatSession(tw, cfg, pad_to=8, **CPU)
    assert s2.turn([1, 5, 9], n_new=8, effort=0.5, **samp) == b
    # frequencies: one state, 400 draws of the step after the boundary
    first = ts.engine.generate([1], n_new=1, effort=0.5).token_ids[0]
    lg = eng.token_logits([1, first], effort=0.5).numpy()[-1]
    top3 = np.argsort(-lg)[:3]
    p = np.exp(lg[top3] - lg[top3].max())
    p /= p.sum()
    counts = dict.fromkeys(top3.tolist(), 0)
    for seed in range(400):
        s2.reset()
        t = s2.turn([1], n_new=2, effort=0.5, temperature=1.0, top_k=3,
                    seed=seed)[1]
        counts[t] += 1
    freq = np.array([counts[t] for t in top3.tolist()]) / 400
    assert 0.5 * np.abs(freq - p).sum() <= 0.08, (freq, p)


def test_capture_needs_a_card(model):
    """On the CPU the session never captures, and capture=True raises."""
    cfg, w = model
    s = ChatSession(w, cfg, pad_to=8, **CPU)
    s.turn([1, 5, 9], n_new=3)
    assert not s.engine._graphs
    with pytest.raises(ValueError):
        ChatSession(w, cfg, pad_to=4, capture=True, **CPU)

