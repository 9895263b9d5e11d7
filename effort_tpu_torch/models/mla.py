"""DeepSeek-V2's decoder in the port: multi-head latent attention (MLA) in
absorbed form over a latent cache, YaRN, and the assembly of its weights
(DeepSeek-V2, arXiv:2405.04434 2.1-2.2; modeling_deepseek.py of
deepseek-ai/DeepSeek-V2-Lite).

A layer, for one token x [dim] at position p (H heads, latent R, rotary P):
  - wq|wkv_a, one fused effort projection (LayerWeights.wqkv, K1 on the
    card): q [H, nope + P], the latent c [R] and the shared rotary key k_pe;
  - c through kv_a_layernorm (an RMS norm), q_pe and k_pe rotated (YaRN
    angles), and the cache row [c | k_pe] written at p in bf16;
  - q_lat[h] = W_UK[h] q_nope[h] (wkv_b's key half, bf16, dense at every
    effort), then K9 (kernels/mla_decode) attends over the live rows with
    [q_lat | q_pe]: o_lat[h] = softmax(scale [q_lat | q_pe] . rows)
    rows[:, :R], the latent being the value;
  - o[h] = W_UV[h]^T o_lat[h] (wkv_b's value half), then wo (K1);
  - the FFN of models/transformer._ffn: the dense FFN below
    first_dense_layers, else the routed experts' gated sum and the shared
    experts.
This equals the published form, where keys and values are W_UK[h]^T c and
W_UV[h]^T c, up to the order of f32 sums (tests/test_torch_deepseek.py).

Rotary convention: HF's apply_rotary_pos_emb de-interleaves the rotary part
of q and k (pairs (2i, 2i + 1) go to (i, i + P/2)) before its rotate-half
rotation. The port folds that into a fixed permutation of wq's and wkv_a's
rotary output columns at assembly (qa_perm), so the step rotates in the
port's rotate-half convention and a real checkpoint's weights still load.
The softmax scale is (nope + P) ** -0.5 times yarn_mscale(factor,
mscale_all_dim) ** 2 (softmax_scale).

The cache (transformer.make_kv_cache) is [L, S, R + P] bf16, one row a
position and layer; Engine and ChatSession hold it as their k_cache, with
no v_cache. Prefill (forward_seq) runs the same layer over T tokens with
the attention as plain tensor ops (materialized scores); batched decode of
an MLA model is not in the port.
"""

from __future__ import annotations

import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.kernels.mla_decode import mla_decode
from effort_tpu_torch.models.transformer import (
    LayerWeights, ModelWeights, RawWeight, _bucketed, _concat_raw, _ffn,
    _ffn_seq, _int32, _live_slots, _on, proj_efforts, rms_norm, rope_angles,
    rope_apply, write_row, yarn_mscale)
from effort_tpu_torch.ops.bucketize import calib_row_order
from effort_tpu_torch.ops.bucketmul import (bucket_matmul, bucket_matvec,
                                            mm_f32)


def softmax_scale(cfg: ModelConfig) -> float:
    """DeepSeek-V2's softmax_scale: q_head_dim ** -0.5, times
    yarn_mscale(factor, mscale_all_dim) ** 2 under YaRN."""
    s = cfg.qk_head_dim ** -0.5
    sc = cfg.rope_scaling
    if sc and sc.get("mscale_all_dim"):
        m = yarn_mscale(sc["factor"], sc["mscale_all_dim"])
        s = s * m * m
    return s


def qa_perm(cfg: ModelConfig) -> torch.Tensor:
    """The output-column order of the fused wq|wkv_a: each query head's
    rotary columns, and k_pe's, de-interleaved (0, 2, ..., P - 2, 1, 3, ...,
    P - 1), every other column in place."""
    H, qk, nope, P = (cfg.n_heads, cfg.qk_head_dim, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim)
    rot = torch.cat([torch.arange(0, P, 2), torch.arange(1, P, 2)])
    heads = [torch.cat([torch.arange(nope), nope + rot]) + h * qk
             for h in range(H)]
    kv = H * qk + torch.cat([torch.arange(cfg.kv_lora_rank),
                             cfg.kv_lora_rank + rot])
    return torch.cat(heads + [kv])


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [n, T, k] @ b [n, k, m] -> f32: a bf16 b takes a rounded to bf16
    and sums in f32 (cuBLAS on the card), as every dense product of the
    port; an f32 b an f32 product."""
    if b.dtype != torch.bfloat16:
        return a.to(torch.float32) @ b.to(torch.float32)
    a = a.to(torch.bfloat16)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def split_qa(qa: torch.Tensor, cfg: ModelConfig) -> tuple:
    """The fused wq|wkv_a output [..., H * qk + R + P] as (q_nope [..., H,
    nope], q_pe [..., H, P], c [..., R], k_pe [..., P])."""
    H, qk, R = cfg.n_heads, cfg.qk_head_dim, cfg.kv_lora_rank
    q = qa[..., :H * qk].reshape(*qa.shape[:-1], H, qk)
    return (q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:],
            qa[..., H * qk:H * qk + R], qa[..., H * qk + R:])


def absorb(q_nope: torch.Tensor, w_uk: torch.Tensor) -> torch.Tensor:
    """q_lat [T, H, R]: each head's query through its key half of wkv_b
    (w_uk [H, nope, R])."""
    return _bmm_f32(q_nope.transpose(0, 1), w_uk).transpose(0, 1)


def unabsorb(o_lat: torch.Tensor, w_uv: torch.Tensor) -> torch.Tensor:
    """[T, H * v]: each head's latent output through its value half of
    wkv_b (w_uv [H, R, v])."""
    T = o_lat.shape[0]
    return _bmm_f32(o_lat.transpose(0, 1), w_uv).transpose(0, 1).reshape(
        T, -1)


# kv_a_layernorm is DeepseekV2RMSNorm(kv_lora_rank), at that class's
# default eps whatever rms_norm_eps is
KV_NORM_EPS = 1e-6


def _latent_row(lw: LayerWeights, l: int, c, k_pe, cos, sin) -> torch.Tensor:
    """The cache row(s) [..., R + P] f32: the normalised latent, then the
    rotated key."""
    return torch.cat([rms_norm(c, lw.kv_norm[l], KV_NORM_EPS),
                      rope_apply(k_pe, cos, sin)], dim=-1)


def absorbed_attention(q_nope, q_pe, rows, w_uk, w_uv, pos, mask_from,
                       scale: float) -> torch.Tensor:
    """One token's attention of one layer in absorbed form: q_nope [H,
    nope], q_pe [H, P] (rotated), rows [S, R + P] (the layer's cache),
    w_uk [H, nope, R], w_uv [H, R, v] -> [H * v] f32, over the rows
    [mask_from, pos]: K9 on the card (kernels/mla_decode raises on the
    widths and dtypes it does not take), its plain version on the CPU."""
    R = w_uk.shape[2]
    q = torch.cat([absorb(q_nope[None], w_uk)[0], q_pe], dim=-1)
    o = mla_decode(q[None], rows[None], _int32(pos), _int32(mask_from),
                   scale, R)
    return unabsorb(o, w_uv)[0]


def forward_layers(w: ModelWeights, cfg: ModelConfig, h, pos, cache,
                   effort=1.0, impl: str = "auto", rope_offset=0,
                   mask_from=0):
    """The layer stack of one decode step (transformer.forward_layers of an
    MLA model): h [dim] f32 through every layer, writing this position's
    latent row into cache [L, S, R + P] in place. pos, rope_offset,
    mask_from: ints or 0-d int device tensors (then the step reads no host
    value and can be captured)."""
    pe = proj_efforts(effort, cfg)
    lw = w.layers
    cos, sin = rope_angles(pos - rope_offset, cfg.qk_rope_head_dim,
                           cfg.rope_theta, h.device, cfg.rope_scaling)
    scale = softmax_scale(cfg)
    for l in range(cfg.n_layers):
        hn = rms_norm(h, lw.attn_norm[l], cfg.norm_eps)
        q_nope, q_pe, c, k_pe = split_qa(
            bucket_matvec(lw.wqkv, hn, pe["wqkv"], l, impl), cfg)
        write_row(cache, l, pos, _latent_row(lw, l, c, k_pe, cos, sin))
        attn = absorbed_attention(q_nope, rope_apply(q_pe, cos, sin),
                                  cache[l], lw.w_uk[l], lw.w_uv[l], pos,
                                  mask_from, scale)
        h = h + bucket_matvec(lw.wo, attn, pe["wo"], l, impl)
        h = h + _ffn(lw, l, rms_norm(h, lw.ffn_norm[l], cfg.norm_eps), pe,
                     cfg, impl)
    return h


def _attend_seq(Q, rows, live, scale: float, R: int) -> torch.Tensor:
    """Prefill's absorbed attention as plain tensor ops: Q [T, H, R + P]
    over rows [S, R + P] bf16, live [T, S] -> [T, H, R] f32 (a query with
    no live row gets 0)."""
    c = rows.to(torch.float32)
    s = torch.einsum("thw,sw->ths", Q, c) * scale
    s = torch.where(live[:, None, :], s, torch.full_like(s, -torch.inf))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    return torch.einsum("ths,sr->thr", p, c[:, :R])


def forward_seq(w: ModelWeights, cfg: ModelConfig, token_ids, cache,
                start_slot=0, rope_offset=0, mask_from=0, effort=1.0,
                impl: str = "auto", moe_grouped: bool = True):
    """Prefill of an MLA model (transformer.forward_seq): T tokens at cache
    slots start_slot .. start_slot + T - 1 (an int or a 0-d int32 device
    tensor, as rope_offset and mask_from), each projection one
    bucket_matmul, attention in absorbed form as plain tensor ops over the
    latent rows (no K3: its heads are one width for q, k and v). Returns
    logits [T, vocab] f32 through the bf16 head."""
    T, dev = token_ids.shape[0], w.device
    S, R = cache.shape[1], cfg.kv_lora_rank
    if not isinstance(start_slot, torch.Tensor) and start_slot + T > S:
        raise ValueError(f"slots {start_slot}..{start_slot + T - 1} past "
                         f"the cache's {S}")
    X = w.tok_embeddings.index_select(0, token_ids.long()).to(torch.float32)
    slots = start_slot + torch.arange(T, device=dev)
    cos, sin = rope_angles(slots - rope_offset, cfg.qk_rope_head_dim,
                           cfg.rope_theta, dev, cfg.rope_scaling)
    widx = slots.clamp(max=S - 1).long()
    live = _live_slots(slots, mask_from, S, cfg, dev)
    scale = softmax_scale(cfg)
    pe = proj_efforts(effort, cfg)
    lw = w.layers
    for l in range(cfg.n_layers):
        Xn = rms_norm(X, lw.attn_norm[l], cfg.norm_eps)
        q_nope, q_pe, c, k_pe = split_qa(
            bucket_matmul(lw.wqkv, Xn, pe["wqkv"], l, impl), cfg)
        cache[l].index_copy_(0, widx, _latent_row(
            lw, l, c, k_pe, cos, sin).to(cache.dtype))
        Q = torch.cat([absorb(q_nope, lw.w_uk[l]),
                       rope_apply(q_pe, cos[:, None], sin[:, None])], dim=-1)
        O = _attend_seq(Q, cache[l], live, scale, R)
        X = X + bucket_matmul(lw.wo, unabsorb(O, lw.w_uv[l]), pe["wo"], l,
                              impl)
        Fn = rms_norm(X, lw.ffn_norm[l], cfg.norm_eps)
        X = X + _ffn_seq(lw, l, Fn, pe, cfg, impl, moe_grouped)
    X = rms_norm(X, w.norm, cfg.norm_eps)
    return mm_f32(X.to(torch.bfloat16), w.output)


def _raw(x) -> RawWeight:
    return x if isinstance(x, RawWeight) else RawWeight.of(x)


def assemble(raw: dict, cfg: ModelConfig, bcfg: BucketConfig,
             keep_dense: bool = False, rms_m=None, rms_f=None, rms_e=None,
             rms_s=None) -> ModelWeights:
    """An MLA model's ModelWeights from raw dense weights (transformer
    .assemble_weights), fused and baked. raw holds, in Hugging Face's
    layout transposed to [n_inst, in, out] (tensors or RawWeight):
      wq [L, dim, H * qk], wkv_a [L, dim, R + P], wkv_b [L, R, H * (nope +
      v)], wo [L, H * v, dim]; dense_w1 / dense_w3 / dense_w2 for the
      first_dense_layers; w1 / w3 / w2 the routed experts (moe_layer(l) * E
      + e); shared_w1 / shared_w3 / shared_w2 the shared experts as one
      FFN (one instance an MoE layer); ffn_gate [L_moe, dim, E]; kv_norm
      [L, R]; attn_norm, ffn_norm, norm, tok_embeddings, output.
    The calibration relayout: pi_m (rms_m) over the residual space, pi_f,
    pi_e, pi_s (rms_f, rms_e, rms_s) over the dense, routed and shared
    hidden spaces; wq|wkv_a's rotary columns de-interleaved (qa_perm)."""
    if not cfg.is_moe:
        raise ValueError("an MLA model is assembled with its MoE layers "
                         "(DeepSeek-V2)")
    pi = [None if r is None else calib_row_order(r)
          for r in (rms_m, rms_f, rms_e, rms_s)]
    pi_m, pi_f, pi_e, pi_s = pi

    def bk(wt, in_pi=None, out_pi=None):
        return _bucketed(_raw(wt), bcfg, keep_dense, True, 1.0, None, in_pi,
                         out_pi)

    def ffn(prefix, p):
        both = None if p is None else torch.cat([p, p + len(p)])
        return (bk(_concat_raw([raw[prefix + "w1"], raw[prefix + "w3"]]),
                   pi_m, both), bk(raw[prefix + "w2"], p, pi_m))

    dense = ffn("dense_", pi_f) if cfg.first_dense_layers else (None, None)
    shared = ffn("shared_", pi_s) if cfg.n_shared_experts else (None, None)
    w13, w2 = ffn("", pi_e)
    wkv_b = _raw(raw["wkv_b"])
    H, nope = cfg.n_heads, cfg.qk_nope_head_dim
    uk, uv = [], []
    for l in range(cfg.n_layers):
        b = wkv_b.make(l, 1)[0].reshape(cfg.kv_lora_rank, H, -1)
        uk.append(b[..., :nope].permute(1, 2, 0).to(torch.bfloat16))
        uv.append(b[..., nope:].permute(1, 0, 2).to(torch.bfloat16))
    emb, head = raw["tok_embeddings"], raw["output"]
    attn_norm, ffn_norm, norm = (raw["attn_norm"], raw["ffn_norm"],
                                 raw["norm"])
    gate = raw["ffn_gate"]
    if pi_m is not None:
        pm = _on(pi_m, emb.device).long()
        emb, head, norm = emb[:, pm], head[pm, :], norm[pm]
        attn_norm, ffn_norm = attn_norm[:, pm], ffn_norm[:, pm]
        gate = gate[:, _on(pi_m, gate.device).long(), :]
    layers = LayerWeights(
        attn_norm=attn_norm.to(torch.float32),
        ffn_norm=ffn_norm.to(torch.float32),
        wq=None, wk=None, wv=None, w1=None, w3=None,
        wqkv=bk(_concat_raw([raw["wq"], raw["wkv_a"]]), pi_m, qa_perm(cfg)),
        wo=bk(raw["wo"], None, pi_m),
        w13=w13, w2=w2, ffn_gate=gate.to(torch.bfloat16),
        kv_norm=raw["kv_norm"].to(torch.float32),
        w_uk=torch.stack(uk).contiguous(), w_uv=torch.stack(uv).contiguous(),
        dense_w13=dense[0], dense_w2=dense[1],
        shared_w13=shared[0], shared_w2=shared[1])
    return ModelWeights(tok_embeddings=emb.to(torch.bfloat16),
                        norm=norm.to(torch.float32),
                        output=head.to(torch.bfloat16), layers=layers)
