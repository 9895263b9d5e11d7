"""The port's prefill path held against the JAX package on tiny_test_model:
forward_seq logits, Engine(prefill=True) generation, and the
teacher-forced surfaces (prompt_logits, position_logits, score), on the
same weights (JAX init_random_weights carried across by the bridge).

Routes pair up as in tests/test_torch_model.py: port "reference" with JAX
"jnp", port "kernel" and "plain" (K2's plain version on the CPU) with JAX
"pallas" (K2 in interpret mode), and "dense" with "dense". JAX's
forward_seq takes its "xla" attention on the CPU; the port's "xla" route
pairs with it exactly, and the port's "flash" route (K3's plain version on
the CPU) rounds Q to bf16 as K3 does, so it is held at a looser cosine.
Both engines pad prompts to 8 positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import effort_tpu.kernels.fused_stream as jax_fused_stream
from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models import transformer as jax_tf
from effort_tpu.models.generate import Engine as JaxEngine
from effort_tpu_torch.config import tiny_test_model
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from test_torch_bridge import cos, jax_weights_to_numpy

torch.set_num_threads(2)

PAD = 8
PROMPT = [4, 8, 15, 16, 23]            # left-padded to 8: 3 pad slots
TEXT = [1, 5, 9, 33, 7, 100, 200, 3, 42, 17]
# (JAX impl, port impl, cosine each position's logits must reach)
ROUTES = (("jnp", "reference", 0.9999), ("pallas", "kernel", 0.999),
          ("pallas", "plain", 0.999))
# the port's flash route against JAX's xla attention: Q rounded to bf16
FLASH_COS = 0.999


@pytest.fixture(scope="module")
def model():
    jw = jax_tf.quantize_head(jax_tf.init_random_weights(
        jax_tiny(), JaxBucketConfig(bucket_size=1, chunk_rows=128,
                                    dtype="int8"),
        calibrate=True, fuse=True, keep_dense=True))
    return jw, model_weights_from_numpy(jax_weights_to_numpy(jw))


@pytest.fixture
def interpret(monkeypatch):
    """Run JAX's Pallas kernels in interpret mode, as its CPU tests do."""
    monkeypatch.setattr(jax_fused_stream, "_INTERPRET", True)


def _left_padded(prompt):
    off = PAD - len(prompt)
    return [0] * off + list(prompt), off


def _jax_seq(jw, impl, effort):
    ids, off = _left_padded(PROMPT)
    kc, vc = jax_tf.make_kv_cache(jax_tiny())
    lg, kc, _ = jax_tf.forward_seq(jw, jax_tiny(), jnp.asarray(ids), kc, vc,
                                   rope_offset=off, mask_from=off,
                                   effort=effort, impl=impl,
                                   attn_impl="xla")
    return np.asarray(lg), np.asarray(kc.astype(jnp.float32))


def _port_seq(tw, impl, effort, attn_impl="xla"):
    ids, off = _left_padded(PROMPT)
    kc, vc = port_tf.make_kv_cache(tiny_test_model(), "cpu")
    lg = port_tf.forward_seq(tw, tiny_test_model(), torch.tensor(ids), kc,
                             vc, rope_offset=off, mask_from=off,
                             effort=effort, impl=impl, attn_impl=attn_impl)
    return lg.numpy(), kc.float().numpy()


def _min_cos(a, b):
    return min(cos(x, y) for x, y in zip(a, b))


def test_forward_seq_matches_jax(model, interpret):
    """Every route's logits at every position of a left-padded prompt at
    effort 0.5 (dense at 1.0), and the K rows written into the cache: bf16
    rows, where a last-bit f32 difference in layer 0's output can cross a
    rounding boundary of layer 1's, so rtol 2e-2 and atol 1e-2."""
    jw, tw = model
    pairs = [(j, t, tol, 0.5) for j, t, tol in ROUTES]
    pairs.append(("dense", "dense", 0.9999, 1.0))
    launches = dict(LAUNCHES)
    for jimpl, timpl, tol, effort in pairs:
        lj, kj = _jax_seq(jw, jimpl, effort)
        lt, kt = _port_seq(tw, timpl, effort)
        assert _min_cos(lj, lt) >= tol, (timpl, _min_cos(lj, lt))
        np.testing.assert_allclose(kt, kj, rtol=2e-2, atol=1e-2)
        lf, _ = _port_seq(tw, timpl, effort, attn_impl="flash")
        assert _min_cos(lj, lf) >= min(tol, FLASH_COS), (timpl, "flash")
        lp, _ = _port_seq(tw, timpl, effort, attn_impl="plain")
        np.testing.assert_array_equal(lp, lf)
    assert LAUNCHES == launches


def test_forward_seq_window_matches_jax(model):
    """A 6-slot sliding window over 20 tokens (the weights do not depend
    on the window): the port's reference route with "xla" attention
    against JAX's jnp route at cos >= 0.9999 per position, the flash
    route (K3's plain version, Q rounded to bf16) at 0.999, and
    forward_seq against forward_token steps on the reference route at
    effort 1 (f32 activations, as JAX's jnp route) at 2e-3, as
    tests/test_sliding_window.py holds JAX's two paths."""
    jw, tw = model
    jcfg = jax_tiny(max_seq_len=24, sliding_window=6)
    cfg = tiny_test_model(max_seq_len=24, sliding_window=6)
    ids = [(7 * i + 3) % cfg.vocab_size for i in range(20)]
    kc, vc = jax_tf.make_kv_cache(jcfg)
    lj, _, _ = jax_tf.forward_seq(jw, jcfg, jnp.asarray(ids), kc, vc,
                                  effort=0.5, impl="jnp", attn_impl="xla")
    lj = np.asarray(lj)
    out = {}
    for attn in ("xla", "flash"):
        kc, vc = port_tf.make_kv_cache(cfg, "cpu")
        out[attn] = port_tf.forward_seq(tw, cfg, torch.tensor(ids), kc, vc,
                                        effort=0.5, impl="reference",
                                        attn_impl=attn).numpy()
    assert _min_cos(lj, out["xla"]) >= 0.9999
    assert _min_cos(lj, out["flash"]) >= FLASH_COS
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    seq = port_tf.forward_seq(tw, cfg, torch.tensor(ids), kc, vc,
                              effort=1.0, impl="reference")
    w_exact = port_tf.ModelWeights(tw.tok_embeddings, tw.norm, tw.output,
                                   tw.layers)
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    tok = torch.stack([port_tf.forward_token(w_exact, cfg, t, p, kc, vc,
                                             effort=1.0, impl="reference")
                       for p, t in enumerate(ids)])
    torch.testing.assert_close(seq, tok, rtol=2e-3, atol=2e-3)


def test_engine_prefill_generate_matches_jax(model, interpret):
    """Engine(prefill=True): token ids and every per-step prediction (the
    left-pad layout's real positions, then the decode steps) equal JAX's,
    at efforts 0.5 and 1.0 through the kernel and reference routes, and at
    1.0 through the dense copies."""
    jw, tw = model
    cfg, jcfg = tiny_test_model(), jax_tiny()
    runs = [("pallas", "kernel", e) for e in (0.5, 1.0)]
    runs += [("jnp", "reference", e) for e in (0.5, 1.0)]
    runs.append(("dense", "dense", 1.0))
    for jimpl, timpl, effort in runs:
        rj = JaxEngine(jw, jcfg, impl=jimpl, prefill=True,
                       prefill_impl=jimpl, pad_to=PAD).generate(
            PROMPT, n_new=6, effort=effort)
        rt = Engine(tw, cfg, impl=timpl, prefill=True, prefill_impl=timpl,
                    pad_to=PAD, device="cpu").generate(PROMPT, n_new=6,
                                                       effort=effort)
        assert rt.token_ids == rj.token_ids, (timpl, effort)
        assert rt.predictions == rj.predictions, (timpl, effort)
        assert len(rt.predictions) == len(PROMPT) + 6 - 1


@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("jimpl,timpl,tol", ROUTES[:2])
def test_teacher_forced_surfaces_match_jax(model, interpret, prefill,
                                           jimpl, timpl, tol):
    """prompt_logits, position_logits, score and answer_limited at effort
    0.5, in the token-loop and the prefill variants: logits at the route's
    cosine per position, equal argmax ids, and log-probabilities within
    30 * (1 - cosine) (a logit vector of norm ~10 that moves by a cosine of
    1 - c moves a log-probability by up to ~10 * sqrt(2 (1 - c)), 3e-3 at
    0.9999 and 1e-2 at 0.999 here)."""
    jw, tw = model
    je = JaxEngine(jw, jax_tiny(), impl=jimpl, prefill=prefill,
                   prefill_impl=jimpl, pad_to=PAD)
    te = Engine(tw, tiny_test_model(), impl=timpl, prefill=prefill,
                prefill_impl=timpl, pad_to=PAD, device="cpu")
    lj, pj = je.prompt_logits(TEXT, effort=0.5)
    lt, pt = te.prompt_logits(TEXT, effort=0.5)
    assert cos(lj, lt) >= tol and pt == pj
    assert len(pt) == len(TEXT)
    Lj = je.position_logits(TEXT, effort=0.5)
    Lt = te.position_logits(TEXT, effort=0.5)
    assert Lt.shape == Lj.shape == (len(TEXT), tiny_test_model().vocab_size)
    assert _min_cos(Lj, Lt) >= tol
    np.testing.assert_allclose(te.score(TEXT, effort=0.5),
                               je.score(TEXT, effort=0.5), rtol=0,
                               atol=30 * (1 - tol))
    allowed = [5, 9, 33, 100]
    assert te.answer_limited(TEXT, allowed, effort=0.5) == \
        je.answer_limited(TEXT, allowed, effort=0.5)


def test_prefill_then_decode_equals_token_loop(model):
    """Within the port, at full effort on the dense copies: the prefill
    engine and the token-loop engine give the same tokens, and forward_seq
    over a prompt equals forward_token steps over it (logits at 2e-4, as
    tests/test_prefill.py holds JAX's two paths)."""
    _, tw = model
    cfg = tiny_test_model()
    r1 = Engine(tw, cfg, pad_to=PAD, device="cpu").generate(
        PROMPT, n_new=6, effort=1.0)
    r2 = Engine(tw, cfg, pad_to=PAD, prefill=True, device="cpu").generate(
        PROMPT, n_new=6, effort=1.0)
    assert r1.token_ids == r2.token_ids
    ids = torch.tensor(TEXT)
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    seq = port_tf.forward_seq(tw, cfg, ids, kc, vc, effort=1.0,
                              impl="dense")
    kc2, vc2 = port_tf.make_kv_cache(cfg, "cpu")
    w_exact = port_tf.ModelWeights(tw.tok_embeddings, tw.norm, tw.output,
                                   tw.layers)
    tok = torch.stack([port_tf.forward_token(w_exact, cfg, ids[p], p, kc2,
                                             vc2, effort=1.0, impl="dense")
                       for p in range(len(TEXT))])
    torch.testing.assert_close(seq, tok, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(kc[:, :len(TEXT)].float(),
                               kc2[:, :len(TEXT)].float(), rtol=2e-2,
                               atol=2e-3)


def test_engine_options_not_ported(model):
    """The JAX engine's options run: sampling, penalties and logprobs in
    the token loop, sampling after a prefill (which refuses penalties and
    logprobs, as the JAX engine asserts); their "off" values are greedy.
    Speculative decode runs through generate_speculative (the greedy
    tokens at 1.0 of the token loop, on a prefill engine too, as in the
    JAX package); generate() takes no spec_k, and an unknown option
    raises a TypeError."""
    _, tw = model
    te = Engine(tw, tiny_test_model(), pad_to=PAD, device="cpu")
    greedy = te.generate(PROMPT, n_new=4).token_ids
    assert te.generate(PROMPT, n_new=4, temperature=0.0, top_p=1.0, seed=0,
                       logprobs=0).token_ids == greedy
    for opt in (dict(temperature=0.7), dict(presence_penalty=0.5),
                dict(logprobs=2)):
        r = te.generate(PROMPT, n_new=4, **opt)
        assert len(r.token_ids) == 4, opt
    assert len(te.generate(PROMPT, n_new=4, logprobs=2).logprobs) == 4
    tp = Engine(tw, tiny_test_model(), pad_to=PAD, prefill=True,
                device="cpu")
    assert len(tp.generate(PROMPT, n_new=4, temperature=0.7).token_ids) == 4
    for opt in (dict(presence_penalty=0.5), dict(logprobs=2)):
        with pytest.raises(ValueError, match="token-loop"):
            tp.generate(PROMPT, n_new=4, **opt)
    greedy1 = te.generate(PROMPT, n_new=4, effort=1.0).token_ids
    assert te.generate_speculative(PROMPT, n_new=4, k=4).token_ids == \
        greedy1
    assert tp.generate_speculative(PROMPT, n_new=4, k=4).token_ids == \
        greedy1
    with pytest.raises(TypeError):
        te.generate(PROMPT, n_new=2, spec_k=4)
    with pytest.raises(TypeError):
        te.generate(PROMPT, n_new=2, beams=2)
