"""DeepSeek-V2's forward pass in plain f32 PyTorch: the reference that the
port's DeepSeek-V2 path (effort_tpu_torch/models/mla.py) is held to.

It follows modeling_deepseek.py of deepseek-ai/DeepSeek-V2-Lite (DeepSeek-V2,
arXiv:2405.04434 2.1-2.2) over one whole sequence: RMS norms; multi-head
latent attention in its published, decompressed form (q = wq x; [c | k_pe]
= wkv_a x; c through kv_a_layernorm; keys and values of every head from
wkv_b c; YaRN rotary embeddings on q_pe and the shared k_pe, with the
de-interleave of apply_rotary_pos_emb; the softmax scale q_head_dim ** -0.5
times yarn_get_mscale(factor, mscale_all_dim) ** 2); a dense SiLU FFN in the
first first_k_dense_replace layers, then a softmax gate over the routed
experts, the top k, and the shared experts added. No cache, no batching, no
kernel; every product in f32 with TF32 off. It imports no JAX, nothing of
effort_tpu and nothing of the port.

Departures from modeling_deepseek.py, none of which changes the
mathematics:
- the configuration is a dict of the published config.json's keys, the
  weights a dict of [in, out] f32 tensors (HF's Linear weights
  transposed), stacked over layers (raw_weights names them);
- everything runs in f32 (the published checkpoint runs in bf16; its gate is
  f32 there too);
- a token's routed experts are summed in the gate's order, best first (HF's
  moe_infer sums them expert by expert): the same sum in another order;
- the top k are taken by a stable descending sort, so equal scores go to the
  lower expert (HF's torch.topk promises no order among ties);
- no q-LoRA (q_lora_rank null, as in DeepSeek-V2-Lite), no attention bias,
  no dropout, no auxiliary loss; cos and sin are computed at the positions
  used rather than from a cached table.
"""

from __future__ import annotations

import math

import torch


def yarn_find_correction_dim(num_rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_pos):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_pos))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_pos))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale=1, mscale=1):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_linear_ramp_mask(lo, hi, dim):
    if lo == hi:
        hi += 0.001
    return torch.clamp((torch.arange(dim, dtype=torch.float32) - lo)
                       / (hi - lo), 0, 1)


def yarn_inv_freq(dim: int, base: float, sc: dict) -> torch.Tensor:
    """DeepseekV2YarnRotaryEmbedding's inv_freq."""
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                                 / dim))
    freq_inter = 1.0 / (sc["factor"] * base ** (
        torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    low, high = yarn_find_correction_range(
        sc["beta_fast"], sc["beta_slow"], dim, base,
        sc["original_max_position_embeddings"])
    inv_freq_mask = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2)
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def rope_cos_sin(hf: dict, pos: torch.Tensor) -> tuple:
    """(cos, sin) [T, rope] at integer positions pos, as
    DeepseekV2YarnRotaryEmbedding caches them (plain RoPE without
    rope_scaling)."""
    dim, base = hf["qk_rope_head_dim"], float(hf["rope_theta"])
    sc = hf.get("rope_scaling")
    if sc:
        inv = yarn_inv_freq(dim, base, sc)
        m = (yarn_get_mscale(sc["factor"], sc.get("mscale", 1))
             / yarn_get_mscale(sc["factor"], sc.get("mscale_all_dim", 0)))
    else:
        inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                              / dim))
        m = 1.0
    freqs = torch.outer(pos.to(torch.float32), inv.to(pos.device))
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * m, emb.sin() * m


def softmax_scale(hf: dict) -> float:
    s = (hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]) ** -0.5
    sc = hf.get("rope_scaling")
    if sc and sc.get("mscale_all_dim"):
        m = yarn_get_mscale(sc["factor"], sc["mscale_all_dim"])
        s = s * m * m
    return s


def rotate_half(x):
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(x, cos, sin):
    """x [T, heads, d] at cos/sin [T, d]: the de-interleave, then
    rotate-half (modeling_deepseek.apply_rotary_pos_emb)."""
    T, h, d = x.shape
    x = x.view(T, h, d // 2, 2).transpose(3, 2).reshape(T, h, d)
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _mlp(x, w1, w3, w2):
    return (torch.nn.functional.silu(x @ w1) * (x @ w3)) @ w2


def gate(hf: dict, x: torch.Tensor, g: torch.Tensor) -> tuple:
    """(weights [T, k], experts [T, k]) of MoEGate: softmax over every
    routed expert's logit, the top k (stable: ties to the lower expert),
    renormalised when norm_topk_prob, times routed_scaling_factor."""
    scores = torch.softmax(x @ g, dim=-1)
    w, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = hf["num_experts_per_tok"]
    w, idx = w[:, :k], idx[:, :k]
    if k > 1 and hf.get("norm_topk_prob"):
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * hf.get("routed_scaling_factor", 1.0), idx


def layer_latents(hf: dict, W: dict, l: int, x: torch.Tensor,
                  pos: torch.Tensor) -> tuple:
    """(q_nope [T, H, nope], q_pe [T, H, rope], c [T, R], k_pe [T, 1,
    rope]) of layer l for normed inputs x [T, dim], rotated at pos."""
    H, nope = hf["num_attention_heads"], hf["qk_nope_head_dim"]
    R = hf["kv_lora_rank"]
    T = x.shape[0]
    q = (x @ W["wq"][l]).view(T, H, -1)
    kva = x @ W["wkv_a"][l]
    # kv_a_layernorm is DeepseekV2RMSNorm(kv_lora_rank): its default eps
    c = rms_norm(kva[:, :R], W["kv_norm"][l], 1e-6)
    cos, sin = rope_cos_sin(hf, pos)
    return (q[..., :nope], apply_rotary_pos_emb(q[..., nope:], cos, sin), c,
            apply_rotary_pos_emb(kva[:, None, R:], cos, sin))


def forward(hf: dict, W: dict, ids, latents: list = None) -> torch.Tensor:
    """Logits [T, vocab] f32 of token ids [T] at positions 0 .. T - 1.
    latents, when given, gets each layer's cache rows [T, R + rope] (the
    normed latent, then the rotated k_pe)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ids = torch.as_tensor(ids)
    H, nope = hf["num_attention_heads"], hf["qk_nope_head_dim"]
    eps, K = hf["rms_norm_eps"], hf["first_k_dense_replace"]
    T = ids.shape[0]
    pos = torch.arange(T)
    x = W["tok_embeddings"][ids]
    scale = softmax_scale(hf)
    causal = pos[None, :] <= pos[:, None]
    for l in range(hf["num_hidden_layers"]):
        h = rms_norm(x, W["attn_norm"][l], eps)
        q_nope, q_pe, c, k_pe = layer_latents(hf, W, l, h, pos)
        if latents is not None:
            latents.append(torch.cat([c, k_pe[:, 0]], dim=-1))
        kv = (c @ W["wkv_b"][l]).view(T, H, -1)
        k = torch.cat([kv[..., :nope], k_pe.expand(T, H, -1)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        s = torch.einsum("thd,shd->hts", q, k) * scale
        s = torch.where(causal[None], s, torch.full_like(s, -math.inf))
        o = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1),
                         kv[..., nope:])
        x = x + o.reshape(T, -1) @ W["wo"][l]
        h = rms_norm(x, W["ffn_norm"][l], eps)
        if l < K:
            x = x + _mlp(h, W["dense_w1"][l], W["dense_w3"][l],
                         W["dense_w2"][l])
            continue
        m, E = l - K, hf["n_routed_experts"]
        wts, idx = gate(hf, h, W["ffn_gate"][m])
        y = torch.zeros_like(h)
        for t in range(T):
            for i in range(idx.shape[1]):
                e = m * E + int(idx[t, i])
                y[t] += wts[t, i] * _mlp(h[t], W["w1"][e], W["w3"][e],
                                         W["w2"][e])
        if hf.get("n_shared_experts"):
            y = y + _mlp(h, W["shared_w1"][m], W["shared_w3"][m],
                         W["shared_w2"][m])
        x = x + y
    return rms_norm(x, W["norm"], eps) @ W["output"]


def raw_weights(hf: dict, seed: int, device="cpu", scale: float = 0.02,
                bf16: bool = True, attn_scale: float = None) -> dict:
    """Seeded random weights in the layout forward() takes (and the port's
    assembly, models/mla.assemble): N(0, scale^2) matrices (wq, wkv_a and
    wkv_b N(0, attn_scale^2) when given), ones for the norms; rounded to
    bf16-representable f32 when bf16, so that a copy stored in bf16 is
    exact."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L, d, V = (hf["num_hidden_layers"], hf["hidden_size"],
               hf["vocab_size"])
    H, K, E = (hf["num_attention_heads"], hf["first_k_dense_replace"],
               hf["n_routed_experts"])
    M, R, P = L - K, hf["kv_lora_rank"], hf["qk_rope_head_dim"]
    nope, v = hf["qk_nope_head_dim"], hf["v_head_dim"]
    F, Fe = hf["intermediate_size"], hf["moe_intermediate_size"]
    Fs = hf.get("n_shared_experts", 0) * Fe

    def rnd(*shape, s=scale):
        w = torch.randn(shape, generator=g, device=device) * s
        return w.to(torch.bfloat16).to(torch.float32) if bf16 else w
    sa = attn_scale or scale
    W = {"tok_embeddings": rnd(V, d), "output": rnd(d, V),
         "wq": rnd(L, d, H * (nope + P), s=sa),
         "wkv_a": rnd(L, d, R + P, s=sa),
         "wkv_b": rnd(L, R, H * (nope + v), s=sa), "wo": rnd(L, H * v, d),
         "dense_w1": rnd(K, d, F), "dense_w3": rnd(K, d, F),
         "dense_w2": rnd(K, F, d),
         "w1": rnd(M * E, d, Fe), "w3": rnd(M * E, d, Fe),
         "w2": rnd(M * E, Fe, d),
         "shared_w1": rnd(M, d, Fs), "shared_w3": rnd(M, d, Fs),
         "shared_w2": rnd(M, Fs, d),
         "ffn_gate": rnd(M, d, E)}
    W.update(kv_norm=torch.ones(L, R, device=device),
             attn_norm=torch.ones(L, d, device=device),
             ffn_norm=torch.ones(L, d, device=device),
             norm=torch.ones(d, device=device))
    return W
