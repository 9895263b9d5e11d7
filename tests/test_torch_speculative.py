"""Self-speculative decode in the port, held against the JAX package on
tiny_test_model(max_seq_len=96) with seed-1 weights carried across by the
bridge (the JAX package's tests/test_speculative.py is the spec), on a
rank-prefix model (BucketConfig(bucket_size=4, chunk_rows=8)) and a
row-prefix one (bucket_size=1).

The port's "reference" route pairs with JAX's "jnp": the same tokens and
the same tokens a round (spec_tokens_per_iter), exactly. The port's
"auto" route (K1's and K2's plain versions on the CPU on the row-prefix
model) must give its own generate(effort=1.0) tokens; there the verify
pass streams the longest row's prefix (K2), so it equals the decode
step's K1 only at tau = 1 (the full_tau fixture, as in
test_torch_batcher.py).

Also pinned here: the two routing faults the port had (ROADMAP.md §3,
fixed): "stream" on a row-prefix matrix, and bucket_matmul's "stream"
and "gather", each against JAX's tokens; and forward_seq and K3's plain
version with their slots as 0-d device tensors, bit for bit against
ints.
"""

import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models import transformer as jax_tf
from effort_tpu.models.generate import Engine as JaxEngine
from effort_tpu.serving.batcher import BatchEngine as JaxBatchEngine
from effort_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.kernels import fused_stream as port_fs
from effort_tpu_torch.kernels.flash_attention import (flash_attention_ref,
                                                      flash_attention_seq)
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.ops.bucketmul import bucket_matmul, bucket_matvec
from effort_tpu_torch.serving.batcher import BatchEngine, ContinuousBatcher
from test_torch_bridge import jax_weights_to_numpy

torch.set_num_threads(2)

PROMPT = [1, 5, 9, 2, 7]
N_NEW = 20
SPEC_CASES = [(0.5, 4), (0.25, 6), (1.0, 4)]
# ROADMAP.md §3's repro of faults 1 and 2, and the JAX package's tokens
FAULT_PROMPTS = ([1, 5, 9], [4, 8, 15, 16])
FAULT_SINGLE = [451, 496, 144, 172, 144, 144]
FAULT_BATCH = {0: [451, 496, 144, 172, 144], 1: [156, 144, 172, 172, 172]}


def _cfg():
    return tiny_test_model(max_seq_len=96)


_MODELS = {}


@pytest.fixture(scope="module", params=[4, 1], ids=["bucket4", "bucket1"])
def spec_model(request):
    """(bucket size, JAX engine ("jnp"), port weights) at seed 1."""
    bs = request.param
    if bs not in _MODELS:
        jw = jax_tf.init_random_weights(
            jax_tiny(max_seq_len=96),
            JaxBucketConfig(bucket_size=bs, chunk_rows=8), seed=1)
        _MODELS[bs] = (bs, JaxEngine(jw, jax_tiny(max_seq_len=96),
                                     impl="jnp", pad_to=8),
                       model_weights_from_numpy(jax_weights_to_numpy(jw)))
    return _MODELS[bs]


@pytest.fixture
def full_tau(monkeypatch):
    monkeypatch.setattr(port_fs, "_TAU", 1.0)


@pytest.mark.parametrize("draft_effort,k", SPEC_CASES)
def test_spec_matches_full_greedy(spec_model, full_tau, draft_effort, k):
    """JAX's test_spec_matches_full_greedy on both layouts: the port's
    "reference" gives JAX's tokens and JAX's spec_tokens_per_iter exactly,
    which are JAX's greedy tokens at 1.0; the port's "auto" gives its own
    generate(effort=1.0) tokens; a draft at 1.0 accepts k - 1 or more a
    round."""
    bs, je, tw = spec_model
    jref = je.generate(PROMPT, n_new=N_NEW, effort=1.0)
    jspec = je.generate_speculative(PROMPT, n_new=N_NEW,
                                    draft_effort=draft_effort, k=k)
    assert jspec.token_ids == jref.token_ids
    ref = Engine(tw, _cfg(), impl="reference", pad_to=8, device="cpu")
    got = ref.generate_speculative(PROMPT, n_new=N_NEW,
                                   draft_effort=draft_effort, k=k)
    assert got.token_ids == jspec.token_ids
    assert got.spec_tokens_per_iter == jspec.spec_tokens_per_iter
    assert got.spec_tokens_per_iter >= 1.0
    if draft_effort == 1.0:
        assert got.spec_tokens_per_iter >= k - 1
    auto = Engine(tw, _cfg(), pad_to=8, device="cpu")
    spec = auto.generate_speculative(PROMPT, n_new=N_NEW,
                                     draft_effort=draft_effort, k=k)
    assert spec.token_ids == auto.generate(PROMPT, n_new=N_NEW,
                                           effort=1.0).token_ids
    assert spec.spec_tokens_per_iter >= 1.0
    assert spec.predictions == [] and spec.eval_ms_per_token > 0


def test_spec_acceptance_monotone_in_effort(spec_model):
    """JAX's test_spec_acceptance_monotone_in_effort: a higher draft effort
    accepts no fewer tokens a round; the port's numbers are JAX's."""
    _, je, tw = spec_model
    eng = Engine(tw, _cfg(), impl="reference", pad_to=8, device="cpu")
    got = []
    for de in (0.1, 1.0):
        j = je.generate_speculative([1, 3, 8], n_new=24, draft_effort=de,
                                    k=6)
        p = eng.generate_speculative([1, 3, 8], n_new=24, draft_effort=de,
                                     k=6)
        assert (p.token_ids, p.spec_tokens_per_iter) == (
            j.token_ids, j.spec_tokens_per_iter), de
        got.append(p.spec_tokens_per_iter)
    assert got[1] >= got[0] - 1e-9


def test_spec_refuses_non_full_kv():
    """JAX's test_spec_refuses_non_full_kv: the ring and int8 caches are
    refused (ValueError where JAX asserts), as is a run past max_seq_len;
    generate() has no spec_k keyword (the JAX engine has none)."""
    cfg = tiny_test_model(max_seq_len=32, sliding_window=8)
    w = port_tf.init_random_weights(
        cfg, BucketConfig(bucket_size=4, chunk_rows=8),
        device="cpu")
    for kw in (dict(ring_kv=True), dict(quant_kv=True)):
        eng = Engine(w, cfg, impl="reference", pad_to=8, device="cpu", **kw)
        with pytest.raises(ValueError, match="full bf16 cache"):
            eng.generate_speculative([1, 5], n_new=4)
    eng = Engine(w, cfg, impl="reference", pad_to=8, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate_speculative([1, 5], n_new=20, k=8)
    with pytest.raises(TypeError):
        eng.generate([1, 5], n_new=2, spec_k=4)


def test_spec_eos_and_single_token(spec_model):
    """An EOS among the verified tokens ends the reply after it, and
    n_new = 1 runs no round (one token a round reported), as in JAX."""
    _, je, tw = spec_model
    ref = Engine(tw, _cfg(), impl="reference", pad_to=8, device="cpu")
    plain = ref.generate(PROMPT, n_new=8, effort=1.0).token_ids
    eos = plain[3]
    jeos = JaxEngine(je.w, je.cfg, impl="jnp", pad_to=8, eos_id=eos)
    peos = Engine(tw, _cfg(), impl="reference", pad_to=8, device="cpu",
                  eos_id=eos)
    for n_new in (8, 1):
        j = jeos.generate_speculative(PROMPT, n_new=n_new,
                                      draft_effort=0.5, k=4)
        p = peos.generate_speculative(PROMPT, n_new=n_new,
                                      draft_effort=0.5, k=4)
        assert (p.token_ids, p.spec_tokens_per_iter) == (
            j.token_ids, j.spec_tokens_per_iter), n_new
    assert peos.generate_speculative(PROMPT, n_new=8).token_ids == \
        plain[:plain.index(eos) + 1]


# ---- the two routing faults (ROADMAP.md §3) ------------------------------


@pytest.fixture(scope="module")
def fault_model():
    jcfg = jax_tiny(max_seq_len=64)
    jw = jax_tf.init_random_weights(
        jcfg, JaxBucketConfig(bucket_size=1, chunk_rows=8, dtype="int8"),
        calibrate=True, fuse=True)
    return jw, model_weights_from_numpy(jax_weights_to_numpy(jw))


def test_stream_route_on_row_prefix_matches_jax(fault_model):
    """Fault 1: impl="stream" on a row-prefix container takes the
    reference route (JAX: bucket_matvec_jnp(exact_cutoff=False)); it
    raised ValueError before."""
    jw, tw = fault_model
    jtoks = JaxEngine(jw, jax_tiny(max_seq_len=64), impl="stream",
                      pad_to=8).generate([1, 5, 9], n_new=6,
                                         effort=0.5).token_ids
    got = Engine(tw, tiny_test_model(max_seq_len=64), impl="stream",
                 pad_to=8, device="cpu").generate([1, 5, 9], n_new=6,
                                                  effort=0.5).token_ids
    assert jtoks == FAULT_SINGLE
    assert got == FAULT_SINGLE
    bm = tw.layers.wo
    v = torch.randn(bm.in_dim, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        bucket_matvec(bm, v, 0.5, 1, impl="stream"),
        bucket_matvec(bm, v, 0.5, 1, impl="reference"),
        rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["stream", "gather"])
def test_batched_stream_and_gather_match_jax(fault_model, impl):
    """Fault 2: bucket_matmul takes the per-row reference for "stream" and
    "gather" (JAX: its "jnp" semantics); BatchEngine and
    Engine(prefill=True) raised before. ROADMAP.md §3's tokens."""
    jw, tw = fault_model
    cfg = tiny_test_model(max_seq_len=64)
    jbe = JaxBatchEngine(jw, jax_tiny(max_seq_len=64), batch_size=2,
                         pad_to=8, impl=impl, prefill_impl=impl)
    jcb, jgot = JaxBatcher(jbe), {}
    cb, got = ContinuousBatcher(BatchEngine(
        tw, cfg, batch_size=2, pad_to=8, impl=impl, prefill_impl=impl,
        device="cpu")), {}
    for i, p in enumerate(FAULT_PROMPTS):
        jcb.submit(p, 5, 0.5, lambda t, i=i: jgot.__setitem__(i, t))
        cb.submit(p, 5, 0.5, lambda t, i=i: got.__setitem__(i, t))
    jcb.run_until_drained()
    cb.run_until_drained()
    assert jgot == FAULT_BATCH
    assert got == FAULT_BATCH
    # the decode steps after the prefill pass on the reference route
    # (JAX: "jnp"; its "gather" fails on a row-prefix matrix, as it does
    # in the JAX package)
    jpre = JaxEngine(jw, jax_tiny(max_seq_len=64), impl="jnp", pad_to=8,
                     prefill=True, prefill_impl=impl).generate(
        [1, 5, 9], n_new=5, effort=0.5)
    pre = Engine(tw, cfg, impl="reference", pad_to=8, prefill=True,
                 prefill_impl=impl, device="cpu").generate(
        [1, 5, 9], n_new=5, effort=0.5)
    assert pre.token_ids == jpre.token_ids == FAULT_BATCH[0]
    V = torch.randn((3, tw.layers.wo.in_dim),
                    generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        bucket_matmul(tw.layers.wo, V, 0.5, 0, impl=impl),
        bucket_matmul(tw.layers.wo, V, 0.5, 0, impl="reference"),
        rtol=0, atol=0)


# ---- slots on the device ---------------------------------------------------


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


@pytest.mark.parametrize("attn_impl", ["xla", "plain", "flash"])
def test_forward_seq_device_slots_bit_equal(fault_model, attn_impl):
    """forward_seq with start_slot, rope_offset and mask_from as 0-d int32
    tensors gives the int call's logits and cache rows bit for bit, on
    every attention route (a left-padded prompt, then 4 tokens at slot
    13)."""
    _, tw = fault_model
    cfg = tiny_test_model(max_seq_len=64, sliding_window=6)
    ids = torch.tensor([0, 0, 1, 5, 9, 2, 7, 3], dtype=torch.int32)
    more = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    outs = []
    for conv in (int, _i32):
        kc, vc = port_tf.make_kv_cache(cfg, "cpu")
        a = port_tf.forward_seq(tw, cfg, ids, kc, vc, conv(0), conv(2),
                                conv(2), effort=0.5, impl="reference",
                                attn_impl=attn_impl)
        b = port_tf.forward_seq(tw, cfg, more, kc, vc, conv(13), conv(2),
                                conv(2), effort=torch.tensor(0.5),
                                attn_impl=attn_impl)
        outs.append((a, b, kc, vc))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="past the cache"):
        kc, vc = port_tf.make_kv_cache(cfg, "cpu")
        port_tf.forward_seq(tw, cfg, more, kc, vc, 62, attn_impl=attn_impl)


def test_flash_attention_ref_device_slots_bit_equal():
    """K3's plain version with start_slot and mask_from as 0-d int32
    tensors equals the int call bit for bit (with a window too), and
    flash_attention_seq's on CPU tensors likewise."""
    g = torch.Generator().manual_seed(3)
    KV, rep, T, S, D = 2, 3, 5, 40, 16
    Q = torch.randn((KV, rep, T, D), generator=g)
    K = torch.randn((KV, S, D), generator=g).to(torch.bfloat16)
    V = torch.randn((KV, S, D), generator=g).to(torch.bfloat16)
    for start, mask, window in ((0, 0, 0), (17, 4, 0), (30, 9, 6)):
        a = flash_attention_ref(Q, K, V, start, mask, window)
        b = flash_attention_ref(Q, K, V, _i32(start), _i32(mask), window)
        assert torch.equal(a, b), (start, mask, window)
        Q2 = Q.permute(2, 0, 1, 3).reshape(T, KV * rep * D)
        kc, vc = K.permute(1, 0, 2), V.permute(1, 0, 2)
        assert torch.equal(
            flash_attention_seq(Q2, kc, vc, start, mask, KV * rep, D,
                                window),
            flash_attention_seq(Q2, kc, vc, _i32(start), _i32(mask),
                                KV * rep, D, window))
