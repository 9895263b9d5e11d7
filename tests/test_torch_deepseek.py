"""DeepSeek-V2 in the port (effort_tpu_torch/models/mla.py, K9's plain
version) against tests/deepseek_v2_reference.py, the plain f32 forward pass
of modeling_deepseek.py, on a tiny DeepSeek shape on the CPU: 3 layers (the
first dense), 8 routed experts (top 3) and 2 shared, latent 64, q/k heads
32 + 16 rotary, v 32, 4 heads, vocabulary 512, YaRN on.

The port stores and multiplies in bf16 where the configuration states it
(the dense copies and the buckets are exact here: the weights are drawn
bf16-representable), so against the f32 reference it differs by rounding
only: each product's input rounded to bf16, the latent cache rows in bf16,
and wkv_b's two products on bf16 inputs. LOGIT_TOL bounds that."""

import dataclasses
import math
import os
import subprocess
import sys

import pytest
import torch

import deepseek_v2_reference as ref

from effort_tpu_torch.config import BucketConfig, deepseek_v2_lite
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels.mla_decode import mla_decode, mla_decode_ref
from effort_tpu_torch.models import mla
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.models.session import ChatSession
from effort_tpu_torch.models.transformer import (LayerWeights,
                                                 assemble_weights,
                                                 forward_seq, forward_token,
                                                 make_kv_cache, rope_angles,
                                                 rope_apply, route,
                                                 yarn_inv_freq, yarn_range)

PUBLISHED_YARN = {"type": "yarn", "factor": 40.0,
                  "original_max_position_embeddings": 4096, "beta_fast": 32,
                  "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
HF = dict(num_hidden_layers=3, hidden_size=128, intermediate_size=256,
          num_attention_heads=4, kv_lora_rank=64, qk_nope_head_dim=32,
          qk_rope_head_dim=16, v_head_dim=32, n_routed_experts=8,
          num_experts_per_tok=3, moe_intermediate_size=64,
          n_shared_experts=2, first_k_dense_replace=1, vocab_size=512,
          rms_norm_eps=1e-6, rope_theta=10000.0, norm_topk_prob=False,
          routed_scaling_factor=1.0, rope_scaling=PUBLISHED_YARN)
# the port's tiny config: DeepSeek-V2-Lite's preset at HF's widths
CFG = deepseek_v2_lite(
    name="tiny-deepseek", dim=128, hidden_dim=256, n_layers=3, n_heads=4,
    n_kv_heads=4, head_dim=32, vocab_size=512, max_seq_len=64, n_experts=8,
    n_experts_per_tok=3, kv_lora_rank=64, qk_nope_head_dim=32,
    qk_rope_head_dim=16, v_head_dim=32, moe_hidden_dim=64)
BCFG = BucketConfig(bucket_size=1, chunk_rows=16, probes=256, dtype="bf16")
# port against reference, max|dlogit| / max|logit|: every product's input
# rounded to bf16 (2^-9 relative) and the cache rows in bf16, over 3 layers
# whose residual sums those roundings. The sound routes read 0.007; with the
# shared experts left out 0.08, plain RoPE for YaRN 0.28, the rotary columns
# not de-interleaved 0.48 (attention weights at 0.08, so that its softmax
# is peaked enough for positions to matter)
LOGIT_TOL = 0.02
# a served token's reference logit below the reference's best, over the
# reference's largest logit: a greedy pick is the port's argmax, within the
# rounding above of the reference's
GAP_TOL = 0.02
# the port's cache rows against the reference's latents, max|d| / max|row|
# a layer: bf16 rows (2^-9) of inputs rounded as above; sound 0.013, the
# variants above 0.08-1.6
ROW_TOL = 0.03
ATTN_SCALE = 0.08
SEQ = torch.randint(0, 512, (40,),
                    generator=torch.Generator().manual_seed(3)).tolist()


def _rms(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.exp(torch.randn(n, generator=g) * 1.2)


@pytest.fixture(scope="module")
def model():
    W = ref.raw_weights(HF, seed=7, attn_scale=ATTN_SCALE)
    w = assemble_weights(W, CFG, BCFG, keep_dense=True, rms_m=_rms(128, 1),
                         rms_f=_rms(256, 2), rms_e=_rms(64, 3),
                         rms_s=_rms(128, 4))
    return W, w


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_config_saves_its_fields_and_leaves_others_as_they_were():
    """The preset survives to_json / from_json; a Mistral config's JSON
    holds none of DeepSeek-V2's fields (the JAX package's schema)."""
    from effort_tpu_torch.config import ModelConfig, mistral_7b
    cfg = deepseek_v2_lite()
    assert ModelConfig.from_json(cfg.to_json()) == cfg
    assert cfg.is_mla and cfg.latent_dim == 576 and cfg.qk_head_dim == 192
    saved = mistral_7b().to_json()
    assert "kv_lora_rank" not in saved and "rope_scaling" not in saved
    assert ModelConfig.from_json(saved) == mistral_7b()


# ---- YaRN and the rotary convention ----

def test_yarn_frequencies_and_scale_match_the_published_formula():
    """At DeepSeek-V2-Lite's values the correction range is 10-23 of 32 and
    the softmax scale 0.11472; the port's frequencies, angles and scale are
    modeling_deepseek.py's (its formula transcribed in the reference)."""
    cfg = deepseek_v2_lite()
    sc = cfg.rope_scaling
    assert yarn_range(64, 1e4, sc) == (10, 23)
    assert ref.yarn_find_correction_range(32, 1, 64, 1e4, 4096) == (10, 23)
    assert torch.equal(yarn_inv_freq(64, 1e4, sc),
                       ref.yarn_inv_freq(64, 1e4, sc))
    assert abs(mla.softmax_scale(cfg) - 0.11472) < 5e-6
    hf = dict(qk_nope_head_dim=128, qk_rope_head_dim=64, rope_theta=1e4,
              rope_scaling=sc)
    assert mla.softmax_scale(cfg) == ref.softmax_scale(hf)
    pos = torch.tensor([0, 1, 17, 1000, 4095])
    cos, sin = rope_angles(pos, 64, 1e4, "cpu", sc)
    rc, rs = ref.rope_cos_sin(hf, pos)
    # the same f32 angles; cos / sin of them in another order of rounding
    assert torch.allclose(cos, rc[:, :32], atol=1e-6)
    assert torch.allclose(sin, rs[:, :32], atol=1e-6)


def test_qa_perm_folds_the_deinterleave_into_the_columns():
    """Rotating the permuted columns rotate-half style gives what
    apply_rotary_pos_emb gives the published columns."""
    H, qk, R, P = 4, 48, 64, 16
    qa = torch.randn(H * qk + R + P, generator=torch.Generator()
                     .manual_seed(5))
    perm = mla.qa_perm(CFG)
    assert sorted(perm.tolist()) == list(range(len(qa)))
    q_nope, q_pe, c, k_pe = mla.split_qa(qa[perm], CFG)
    pos = torch.tensor([37])
    cos, sin = rope_angles(37, P, 1e4, "cpu", PUBLISHED_YARN)
    rc, rs = ref.rope_cos_sin(HF, pos)
    q_ref = qa[:H * qk].view(1, H, qk)
    want_q = ref.apply_rotary_pos_emb(q_ref[..., 32:], rc, rs)[0]
    want_k = ref.apply_rotary_pos_emb(qa[None, None, H * qk + R:], rc,
                                      rs)[0, 0]
    assert torch.equal(q_nope, q_ref[0, :, :32])
    assert torch.equal(c, qa[H * qk:H * qk + R])
    assert torch.allclose(rope_apply(q_pe, cos, sin), want_q, atol=1e-6)
    assert torch.allclose(rope_apply(k_pe, cos, sin), want_k, atol=1e-6)


# ---- routing ----

@pytest.mark.parametrize("renorm", [False, True])
def test_routing_softmax_over_all_ties_to_the_lower_expert(renorm):
    """Logits 3, 1, 3, 2, 3, 3, 0, 0 at top 3: experts 0, 2, 4 (four tie
    at 3, the lower three kept, in expert order), gates the softmax over
    all eight at those (summing below 1) or, renormalised, those over
    their sum, which the port computes as the softmax of the top-k logits
    (gate_scoring "topk"); the reference's gate agrees."""
    cfg = dataclasses.replace(CFG, gate_scoring="topk" if renorm else "all")
    logits = torch.tensor([3., 1., 3., 2., 3., 3., 0., 0.])
    g = torch.zeros(2, 128, 8)
    g[1, 0] = logits
    lw = LayerWeights(attn_norm=None, ffn_norm=None, wq=None, wk=None,
                      wv=None, wo=None, w1=None, w2=None, w3=None,
                      ffn_gate=g.to(torch.bfloat16))
    x = torch.zeros(128)
    x[0] = 1.0
    gates, idx = route(lw, 2, x, cfg)      # layer 2 = MoE layer 1
    assert idx.tolist() == [0, 2, 4]
    soft = torch.softmax(logits, dim=0)[[0, 2, 4]]
    want = soft / soft.sum() if renorm else soft
    assert torch.allclose(gates, want, atol=1e-7)
    assert (abs(float(gates.sum()) - 1) < 1e-6) == renorm
    rw, ri = ref.gate(dict(HF, norm_topk_prob=renorm), x[None], g[1])
    assert ri[0].tolist() == [0, 2, 4]
    assert torch.allclose(rw[0], gates, atol=1e-7)


# ---- attention ----

def test_absorbed_attention_equals_the_decompressed_form():
    """Keys and values through wkv_b (the published form) against the
    query through W_UK and the output through W_UV (the port's), on the
    same bf16 rows and f32 weights: equal to f32 rounding."""
    g = torch.Generator().manual_seed(11)
    H, nope, R, P, v, S = 4, 32, 64, 16, 32, 40
    w_uk = torch.randn(H, nope, R, generator=g) * 0.2
    w_uv = torch.randn(H, R, v, generator=g) * 0.2
    rows = torch.randn(S, R + P, generator=g).to(torch.bfloat16)
    q_nope = torch.randn(H, nope, generator=g)
    q_pe = torch.randn(H, P, generator=g)
    pos, mask_from, scale = 30, 3, 0.2
    got = mla.absorbed_attention(q_nope, q_pe, rows, w_uk, w_uv, pos,
                                 mask_from, scale)
    c = rows[:, :R].float()
    k = torch.einsum("sr,hnr->shn", c, w_uk)
    val = torch.einsum("sr,hrv->shv", c, w_uv)
    s = (torch.einsum("hn,shn->hs", q_nope, k)
         + q_pe @ rows[:, R:].float().T) * scale
    live = (torch.arange(S) >= mask_from) & (torch.arange(S) <= pos)
    s = torch.where(live, s, torch.full_like(s, -math.inf))
    want = torch.einsum("hs,shv->hv", torch.softmax(s, -1), val).reshape(-1)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("pos,mask_from", [(0, 0), (15, 0), (16, 3),
                                           (47, 47), (47, 0), (10, 11)])
def test_k9_plain_version_equals_reference_attention(pos, mask_from):
    """K9's plain version (what the wrapper runs on CPU tensors) against
    the attention written out a slot and head at a time in f64: rows
    [mask_from, pos] only, and 0 where there are none; the CPU counts no
    launch."""
    g = torch.Generator().manual_seed(pos * 7 + mask_from)
    B, H, W, R, S = 2, 4, 80, 64, 48
    q = torch.randn(B, H, W, generator=g)
    cache = torch.randn(B, S, W, generator=g).to(torch.bfloat16)
    p = torch.tensor([pos, S - 1 - pos], dtype=torch.int32)
    mf = torch.tensor([mask_from, 0], dtype=torch.int32)
    before = LAUNCHES["mla_decode"]
    got = mla_decode(q, cache, p, mf, 0.3, R)
    assert LAUNCHES["mla_decode"] == before
    assert torch.equal(got, mla_decode_ref(q, cache, p, mf, 0.3, R))
    for b in range(B):
        lo, hi = int(mf[b]), int(p[b])
        for h in range(H):
            if lo > hi:
                assert not got[b, h].any()
                continue
            rows = cache[b, lo:hi + 1].double()
            w = torch.softmax(rows @ q[b, h].double() * 0.3, dim=0)
            want = w @ rows[:, :R]
            assert float((got[b, h] - want).abs().max()) < 1e-5 * float(
                want.abs().max())


# ---- the whole model ----

def _reference(W, seq, latents=None):
    with torch.no_grad():
        return ref.forward(HF, W, seq, latents)


@pytest.mark.parametrize("impl", ["dense", "reference"])
def test_decode_through_the_cache_matches_the_full_pass(model, impl):
    """Engine's teacher-forced decode steps (one position at a time through
    the latent cache, effort 1.0) against the reference's full forward
    logits; the cache rows against the reference's latents."""
    W, w = model
    eng = Engine(w, CFG, impl=impl, device="cpu")
    got = eng.token_logits(SEQ, effort=1.0)
    lat = []
    want = _reference(W, SEQ, lat)
    assert _rel(got, want) < LOGIT_TOL
    rows = eng._kv("full")[0][:, :len(SEQ)].float()
    for l, r in enumerate(lat):
        assert _rel(rows[l], r) < ROW_TOL, l


def test_prefill_then_decode_matches_the_full_pass(model):
    """forward_seq over the first 12 tokens (the prefill, plain absorbed
    attention), then forward_token steps through the same cache: every
    position's logits against the full pass."""
    W, w = model
    cache, none = make_kv_cache(CFG, "cpu")
    assert none is None and cache.shape == (3, 64, 80)
    pre = forward_seq(w, CFG, torch.tensor(SEQ[:12]), cache, None,
                      effort=1.0, impl="dense")
    steps = [forward_token(w, CFG, t, 12 + i, cache, None, effort=1.0,
                           impl="dense") for i, t in enumerate(SEQ[12:])]
    got = torch.cat([pre, torch.stack(steps)])
    assert _rel(got, _reference(W, SEQ)) < LOGIT_TOL


def _gaps(W, seq, start, served):
    """How far each served token's reference logit lies below the
    reference's best at the position that chose it."""
    lg = _reference(W, seq)[start - 1:start - 1 + len(served)]
    t = torch.tensor(served)
    return lg.max(dim=1).values - lg.gather(1, t[:, None])[:, 0]


def test_chat_session_and_generate_follow_the_reference(model, tmp_path):
    """ChatSession turn by turn (eager on the CPU) and Engine.generate,
    greedy at effort 1.0: each served token is the reference's best or
    within rounding of it; the session's latent rows are the reference's;
    a saved and loaded session continues as the original does."""
    W, w = model
    sess = ChatSession(w, CFG, impl="dense", eos_id=-1, pad_to=8,
                       device="cpu")
    turns = [([5, 77, 301], 6), ([9, 140], 5)]
    seq = []
    for prompt, n in turns:
        out = sess.turn(prompt, n_new=n, effort=1.0)
        start = len(seq) + len(prompt)
        seq += prompt + out
        scale = _reference(W, seq).abs().max()
        assert float(_gaps(W, seq, start, out).max()) < GAP_TOL * scale
    assert sess.history == seq and sess.pos == len(seq)
    lat = []
    _reference(W, seq, lat)
    for l, r in enumerate(lat):
        assert _rel(sess.k_cache[l, :len(seq)].float(), r) < ROW_TOL
    sess.save(str(tmp_path / "s"))
    back = ChatSession.load(str(tmp_path / "s"), w, CFG, impl="dense",
                            eos_id=-1, pad_to=8, device="cpu")
    assert torch.equal(back.k_cache[:, :len(seq)], sess.k_cache[:, :len(seq)])
    assert back.turn([44], n_new=4, effort=1.0) == sess.turn(
        [44], n_new=4, effort=1.0)

    eng = Engine(w, CFG, impl="dense", eos_id=-1, pad_to=8, device="cpu")
    prompt = [3, 44, 511, 0, 128, 64, 200, 17]
    out = eng.generate(prompt, n_new=8, effort=1.0).token_ids
    full = prompt + out
    scale = _reference(W, full).abs().max()
    assert float(_gaps(W, full, len(prompt), out).max()) < GAP_TOL * scale


def test_attention_reads_of_an_mla_model_follow_k9():
    """transformer.attention_reads of an MLA model: on the card K9 runs on
    every cache (or raises) and reads the live latent rows, whatever the
    widths and dtype; on the CPU the plain version reads every row of
    every call."""
    from effort_tpu_torch.models.transformer import attention_reads
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for dt in (torch.bfloat16, torch.float32):
        assert attention_reads(30, 3, 64, CFG, dt, cuda) == 30
        assert attention_reads(30, 3, 64, CFG, dt, cpu) == 3 * 64


def test_the_routes_without_an_mla_path_refuse_it(model):
    """BatchEngine, the ring and int8 caches and the batched steps name the
    MLA path they lack instead of running a wrong one."""
    from effort_tpu_torch.serving.batcher import BatchEngine
    _, w = model
    with pytest.raises(ValueError, match="MLA"):
        BatchEngine(w, CFG, batch_size=2, device="cpu")
    for opt in ("ring_kv", "quant_kv"):
        with pytest.raises(ValueError, match="MLA"):
            Engine(w, dataclasses.replace(CFG, sliding_window=16),
                   device="cpu", **{opt: True})


def test_reference_loads_no_jax_and_nothing_of_either_package():
    """tests/deepseek_v2_reference.py alone: no jax, no effort_tpu and no
    effort_tpu_torch module loaded."""
    code = ("import sys; sys.path.insert(0, %r); import deepseek_v2_reference"
            "; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    mods = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "effort_tpu", "effort_tpu_torch"}
