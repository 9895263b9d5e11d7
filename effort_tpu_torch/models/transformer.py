"""Transformer forward passes (Mistral family) with the effort knob, and
random-weight synthesis.

  - forward_token: one decode step of one sequence (K1 per projection; on
    a rank-prefix model K4, or K5 / K6 by impl).
  - forward_seq: prefill, T tokens of one sequence in one pass (K2 per
    projection, K3 for attention; a rank-prefix model's projections take
    the per-row reference semantics, as the JAX package's take "jnp").
    Its start slot, rotary offset and mask start may be 0-d device
    tensors (K3 reads them on the card), so the speculative verify pass
    at a device position is captured with the decode steps.
  - forward_seq_batch: T tokens of each of B slots in one pass (the
    batched speculative verify; the JAX package's vmap of forward_seq):
    K2 over the B*T rows, K3 once a slot.
  - forward_token_batch: one decode step of B slots, each with its own
    position, left-pad offset and effort (K2 per projection, or the
    reference on a rank-prefix model).
  - MoE models (n_experts > 1, Mixtral): each token's FFN is the gated sum
    of its top-k experts by the layer's gate (_ffn). In decode the routed
    instance l * E + e stays a device tensor that K1 / K4 read, so a step
    waits on no host read; prefill groups the tokens by expert (one host
    read of the routing a layer) and runs each expert with tokens once
    over its rows (_moe_grouped: K2).

  - Bucketized projection weights of all layers are packed into single
    BucketedMatrix containers (instance axis = layer); the kernel indexes an
    instance by its offset, so the layer loop never slices weights.
  - GQA is a reshape of the query heads, KV-head major, not a repeat.
  - KV cache: [n_layers, max_seq, n_kv_heads, head_dim] bf16, written in
    place (the JAX package returns updated copies; in place saves the copy).
    The decode step's position may be a 0-d int device tensor: its rows
    are written by index, so a step holds no host value and can be
    captured in a CUDA graph. Two other caches ride on forward_token's
    kv_update_fn / attn_fn hooks, as in the JAX package: a ring of
    sliding_window slots (ring_kv_hooks) and int8 rows with one f32 scale
    a (slot, kv head) (quant_kv_hooks; forward_token_batch's kv_quant).
  - The residual h stays f32 between layers; attention runs in f32.
    Decode attention over a bf16 cache on the card is K8
    (kernels/decode_attention: each slot's live rows only, read in place;
    k8_route); the int8 and ring caches and the CPU run its plain version
    (_attn_core), which widens every slot of the cache.
  - Tensor parallelism (parallel/tp.py): with tp = (mesh, axis) the passes
    run a rank's shard of every projection (cfg the local config) and sum
    over the axis after wo and after the FFN's down projection (an MoE
    FFN's gated sum), the JAX package's _psum; ffn_fn replaces the FFN
    (parallel/ep.py). With tp=None and ffn_fn=None nothing changes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.kernels.decode_attention import (attn_core,
                                                      decode_attention,
                                                      decode_limits,
                                                      head_groups)
from effort_tpu_torch.kernels.flash_attention import flash_attention_seq
from effort_tpu_torch.ops.bucketize import (bucketize, calib_row_order,
                                            pick_chunk_rows)
from effort_tpu_torch.ops.bucketmul import (bucket_matmul, bucket_matvec,
                                            dense_matvec, mm_f32)
from effort_tpu_torch.ops.layouts import BucketedMatrix, concat_bucketed

PROJ_FIELDS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wqkv", "w13")
# host reads: of the MoE routing (_moe_grouped: one a layer of a prefill
# pass) and of a speculative round's status (Engine.generate_speculative:
# one a round); a run zeroes the counts and reads them after, as it does
# LAUNCHES
HOST_READS = {"moe_routing": 0, "spec_status": 0}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when no card is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


def _move(x, device):
    return None if x is None else x.to(device)


@dataclasses.dataclass
class LayerWeights:
    """All layers' weights, the layer axis packed inside each container.

    attn_norm/ffn_norm: [L, dim] f32.
    wq/wk/wv/wo: BucketedMatrix with n_experts == L.
    w1/w2/w3:    BucketedMatrix with n_experts == L * n_experts(model).
    ffn_gate:    [L, dim, E] bf16 or None (dense models).
    wqkv/w13:    optional fused projections (output columns q|k|v and
                 w1|w3): one kernel launch and one shared selection in place
                 of three / two. When set, the unfused fields are None.

    DeepSeek-V2 (cfg.is_mla; models/mla.py) adds, always fused:
    wqkv:        wq|wkv_a, q's heads then the latent and the rotary key.
    kv_norm:     [L, kv_lora_rank] f32, the latent's RMS norm.
    w_uk, w_uv:  [L, H, nope, R] and [L, H, R, v] bf16, wkv_b's key and
                 value halves, dense at every effort (the absorbed form).
    dense_w13/dense_w2: the leading dense layers' FFN (instance l).
    w13/w2:      the routed experts, instance moe_layer(l) * E + e.
    shared_w13/shared_w2: the shared experts as one FFN, instance
                 moe_layer(l); ffn_gate [L - first_dense_layers, dim, E].
    """
    attn_norm: torch.Tensor
    ffn_norm: torch.Tensor
    wq: Optional[BucketedMatrix]
    wk: Optional[BucketedMatrix]
    wv: Optional[BucketedMatrix]
    wo: BucketedMatrix
    w1: Optional[BucketedMatrix]
    w2: BucketedMatrix
    w3: Optional[BucketedMatrix]
    ffn_gate: Optional[torch.Tensor]
    wqkv: Optional[BucketedMatrix] = None
    w13: Optional[BucketedMatrix] = None
    kv_norm: Optional[torch.Tensor] = None
    w_uk: Optional[torch.Tensor] = None
    w_uv: Optional[torch.Tensor] = None
    dense_w13: Optional[BucketedMatrix] = None
    dense_w2: Optional[BucketedMatrix] = None
    shared_w13: Optional[BucketedMatrix] = None
    shared_w2: Optional[BucketedMatrix] = None

    @property
    def any_w1(self) -> BucketedMatrix:
        return self.w13 if self.w13 is not None else self.w1

    def to(self, device) -> "LayerWeights":
        return dataclasses.replace(self, **{
            f.name: _move(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class ModelWeights:
    tok_embeddings: torch.Tensor   # [vocab, dim] bf16
    norm: torch.Tensor             # [dim] f32
    output: torch.Tensor           # [dim, vocab] bf16 LM head
    layers: LayerWeights
    # optional int8 LM head for decode (quantize_head): per-column scales;
    # greedy argmax is protected by an exact bf16 rescore of the top 16
    output_q: Optional[torch.Tensor] = None        # [dim, vocab] int8
    output_qscale: Optional[torch.Tensor] = None   # [vocab] f32

    def to(self, device) -> "ModelWeights":
        return dataclasses.replace(self, **{
            f.name: _move(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device


def quantize_head(w: ModelWeights, keep_exact: bool = True) -> ModelWeights:
    """Add an int8 copy of the LM head (per-output-column absmax scales).
    keep_exact keeps the bf16 head for the top-16 exact rescore."""
    W = w.output.to(torch.float32)
    sc = W.abs().amax(dim=0) / 127.0 + 1e-30
    Wi = torch.round(W / sc).to(torch.int8)
    return dataclasses.replace(w, output_q=Wi, output_qscale=sc,
                               output=w.output if keep_exact else None)


_HEAD_RESCORE_K = 16
# torch._int_mm takes at least 17 rows on the card; the vector rides in
# row 0 of a zero-padded block
_INT_MM_ROWS = 17


def _int8_matmul(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """x [B, k] int8 @ wq [k, n] int8 -> [B, n] int32, exact. Fewer than
    _INT_MM_ROWS rows ride in a zero-padded block."""
    B = x.shape[0]
    if B < _INT_MM_ROWS:
        a = torch.zeros((_INT_MM_ROWS, x.shape[1]), dtype=torch.int8,
                        device=x.device)
        a[:B] = x
        x = a
    return torch._int_mm(x, wq)[:B]


def head_logits(w: ModelWeights, h: torch.Tensor) -> torch.Tensor:
    """Decode LM head: h [dim] -> logits [vocab] f32.

    With an int8 head: symmetric per-tensor int8 activation times the
    per-column int8 weights, accumulated in int32; then, when the bf16 head
    is kept, the top-16 logits are recomputed exactly in bf16."""
    if w.output_q is None:
        return dense_matvec(h, w.output)
    vm = h.abs().max() / 127.0 + 1e-30
    hi = torch.round(h / vm).to(torch.int8)
    y = _int8_matmul(hi[None], w.output_q)[0].to(torch.float32) \
        * (w.output_qscale * vm)
    if w.output is not None:
        top_i = torch.topk(y, _HEAD_RESCORE_K).indices
        cols = w.output.index_select(1, top_i)                # [dim, 16]
        exact = mm_f32(h.to(torch.bfloat16)[None], cols)[0]
        y = y.scatter(0, top_i, exact)
    return y


def head_logits_batch(w: ModelWeights, H: torch.Tensor) -> torch.Tensor:
    """Batched decode LM head: H [B, dim] -> [B, vocab] f32, as head_logits
    with a per-row activation scale."""
    if w.output_q is None:
        return mm_f32(H.to(torch.bfloat16), w.output)
    B = H.shape[0]
    vm = H.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-30
    Hi = torch.round(H / vm).to(torch.int8)
    Y = _int8_matmul(Hi, w.output_q).to(torch.float32) \
        * (w.output_qscale[None, :] * vm)
    if w.output is not None:
        top_i = torch.topk(Y, _HEAD_RESCORE_K, dim=1).indices     # [B, K]
        cols = w.output.index_select(1, top_i.reshape(-1)).reshape(
            -1, B, _HEAD_RESCORE_K)                            # [dim, B, K]
        # bf16 products are exact in f32; the sum is f32
        exact = torch.einsum("bd,dbk->bk",
                             H.to(torch.bfloat16).to(torch.float32),
                             cols.to(torch.float32))
        Y = Y.scatter(1, top_i, exact)
    return Y


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMS norm over the last axis."""
    x = x.to(torch.float32)
    inv = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return x * inv * weight


_FREQS: dict = {}


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """DeepSeek-V2's yarn_get_mscale: 0.1 mscale ln(scale) + 1 (1 at
    scale <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_range(dim: int, base: float, sc: dict) -> tuple:
    """DeepSeek-V2's yarn_find_correction_range: the frequency indices
    (low, high) between which YaRN ramps from interpolated to original
    frequencies, for beta_fast / beta_slow rotations over the original
    context."""
    orig = sc["original_max_position_embeddings"]

    def dim_of(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) \
            / (2 * math.log(base))
    return (max(math.floor(dim_of(sc["beta_fast"])), 0),
            min(math.ceil(dim_of(sc["beta_slow"])), dim - 1))


def yarn_inv_freq(dim: int, base: float, sc: dict) -> torch.Tensor:
    """DeepSeek-V2's YaRN inverse frequencies [dim // 2] f32 on the CPU:
    base ** (-2i / dim) below the correction range, those divided by the
    factor above it, a linear ramp between (its
    DeepseekV2YarnRotaryEmbedding, in f32)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (sc["factor"] * base ** exps)
    low, high = yarn_range(dim, base, sc)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_angles(pos, head_dim: int, theta: float, device, scaling=None):
    """(cos, sin) [..., head_dim // 2] f32 at integer position pos (an int,
    or an integer tensor [...] of positions), frequencies theta ** (-i / h)
    in f32; with scaling (a YaRN rope_scaling dict, ModelConfig) YaRN's
    frequencies, cos and sin times mscale / mscale_all_dim."""
    key = (head_dim, theta, str(device),
           None if scaling is None else tuple(sorted(scaling.items())))
    if key not in _FREQS:
        h = head_dim // 2
        if scaling is None:
            _FREQS[key] = ((theta ** (-torch.arange(0, h, dtype=torch.float32)
                                      / h)).to(device), 1.0)
        else:
            m = (yarn_mscale(scaling["factor"], scaling.get("mscale", 1.0))
                 / yarn_mscale(scaling["factor"],
                               scaling.get("mscale_all_dim", 0.0)))
            _FREQS[key] = (yarn_inv_freq(head_dim, theta, scaling).to(device),
                           m)
    freqs, m = _FREQS[key]
    if isinstance(pos, torch.Tensor):
        angle = pos.to(torch.float32)[..., None] * freqs
    else:
        angle = float(pos) * freqs
    if m == 1.0:
        return torch.cos(angle), torch.sin(angle)
    return torch.cos(angle) * m, torch.sin(angle) * m


def rope_apply(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on x [..., head_dim] (HF weight convention)."""
    x = x.to(torch.float32)
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rope_rotate(x: torch.Tensor, pos: int, head_dim: int,
                theta: float) -> torch.Tensor:
    return rope_apply(x, *rope_angles(pos, head_dim, theta, x.device))


def make_kv_cache(cfg: ModelConfig, device, dtype=torch.bfloat16):
    """(k_cache, v_cache) [L, S, KV, D] each; on an MLA model (latent
    [L, S, kv_lora_rank + qk_rope_head_dim], None): one row a position and
    layer, the latent then the rotary key (models/mla.py)."""
    if cfg.is_mla:
        return (torch.zeros((cfg.n_layers, cfg.max_seq_len, cfg.latent_dim),
                            dtype=dtype, device=device), None)
    shape = (cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def write_row(cache: torch.Tensor, l: int, pos, row: torch.Tensor) -> None:
    """cache[l, pos] = row, in place. pos: an int, or a 0-d int device
    tensor, written by index with no host read."""
    if isinstance(pos, torch.Tensor):
        cache[l].index_copy_(0, pos.reshape(1).long(),
                             row[None].to(cache.dtype))
    else:
        cache[l, pos] = row.to(cache.dtype)


def make_ring_kv_cache(cfg: ModelConfig, device, dtype=torch.bfloat16):
    """The KV cache of ring_kv_hooks: [n_layers, sliding_window, KV, D] per
    side. It holds the last sliding_window positions only, so decode runs
    past max_seq_len (which then only sizes the prompt buffer)."""
    if not cfg.sliding_window:
        raise ValueError("a ring KV cache needs cfg.sliding_window")
    shape = (cfg.n_layers, cfg.sliding_window, cfg.n_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def ring_kv_hooks(cfg: ModelConfig):
    """(kv_update_fn, attn_fn) of the rolling cache (the JAX package's
    ring_kv_hooks): position pos lands at slot pos % W over the row that
    just left the window; slots <= pos are live, and every slot once pos
    >= W (the softmax does not care about slot order). Decode only: no
    left-pad mask. The caches are written in place."""
    W = cfg.sliding_window
    if not W:
        raise ValueError("ring KV hooks need cfg.sliding_window")

    def upd(k_cache, v_cache, l, pos, k, v):
        write_row(k_cache, l, pos % W, k)
        write_row(v_cache, l, pos % W, v)

    def attn(q, k_cache, v_cache, l, pos):
        live = (torch.arange(W, device=q.device) <= pos) | (pos >= W)
        return _attn_core(q, k_cache[l].to(torch.float32),
                          v_cache[l].to(torch.float32), live, cfg)

    return upd, attn


def quantize_kv_rows(x: torch.Tensor):
    """x [..., D] f32 -> (int8 [..., D], f32 scale [...]): symmetric absmax
    scales over the last axis, round half to even (the JAX package's
    quantize_kv_rows)."""
    s = torch.clamp(x.abs().amax(dim=-1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return q.to(torch.int8), s.to(torch.float32)


def make_quant_kv_cache(cfg: ModelConfig, device, batch_size: int = 0):
    """The int8 KV cache: per side (data [L, S, KV, D] int8, scale
    [L, S, KV] f32), with a slot axis B after L when batch_size > 0; about
    half the bf16 cache's bytes."""
    lead = (cfg.n_layers,) + ((batch_size,) if batch_size else ())
    lead += (cfg.max_seq_len, cfg.n_kv_heads)

    def side():
        return (torch.zeros(lead + (cfg.head_dim,), dtype=torch.int8,
                            device=device),
                torch.zeros(lead, dtype=torch.float32, device=device))
    return side(), side()


def _attention_q8(q, kd, ks, vd, vs, pos, cfg: ModelConfig, mask_from=0):
    """int8 attention read (leading axes are slots): kd/vd [..., S, KV, D]
    int8, ks/vs [..., S, KV] f32, dequantized in f32."""
    live = _live_slots(pos, mask_from, kd.shape[-3], cfg, q.device)
    return _attn_core(q, kd.to(torch.float32) * ks[..., None],
                      vd.to(torch.float32) * vs[..., None], live, cfg)


def quant_kv_hooks(cfg: ModelConfig):
    """(kv_update_fn, attn_fn) of the int8 cache (the JAX package's
    quant_kv_hooks): each new row quantized per kv head, the read
    dequantized. Decode only (mask_from 0); written in place."""
    def upd(k_cache, v_cache, l, pos, k, v):
        for (data, scale), x in ((k_cache, k), (v_cache, v)):
            xq, xs = quantize_kv_rows(x.to(torch.float32))
            write_row(data, l, pos, xq)
            write_row(scale, l, pos, xs)

    def attn(q, k_cache, v_cache, l, pos):
        (kd, ks), (vd, vs) = k_cache, v_cache
        return _attention_q8(q, kd[l], ks[l], vd[l], vs[l], pos, cfg)

    return upd, attn


def _attn_core(q, kf, vf, live, cfg: ModelConfig):
    """Masked-softmax attention read for one query token per slot; leading
    axes are slots. q [..., H*D]; kf/vf [..., S, KV, D] f32;
    live [..., S] bool (K8's plain version, kernels/decode_attention)."""
    return attn_core(q, kf, vf, live, cfg.n_kv_heads, cfg.kv_repeats,
                     cfg.head_dim)


def k8_route(device, cache_dtype, cfg: ModelConfig) -> bool:
    """Whether decode attention over a cache of cache_dtype on `device`
    runs K8 (kernels/decode_attention): bf16 caches on the card, heads the
    kernel takes. The int8 and ring caches, the CPU and other heads take
    the plain version (_attn_core)."""
    return (device.type == "cuda" and cache_dtype == torch.bfloat16
            and decode_limits(cfg.head_dim, cfg.kv_repeats) is None)


def attention_reads(live: int, calls: int, S: int, cfg: ModelConfig,
                    cache_dtype, device, hooked: bool = False) -> int:
    """The cache rows `calls` decode attention calls over caches of S rows
    read, `live` the sum of the rows they attend over: on K8's route
    (k8_route, with no attn_fn hook in _attention's place) those rows,
    once a head group of its launch (head_groups), else every row of
    every call (the plain version and the hooks widen the whole cache).
    Stated in closed form from the route the calls take, not measured.
    On an MLA model the rows are latent rows: K9, which every cache on the
    card takes (models/mla.absorbed_attention), reads the live ones once
    for every head, the plain version on the CPU all of them."""
    if cfg.is_mla:
        return live if device.type == "cuda" else calls * S
    if not hooked and k8_route(device, cache_dtype, cfg):
        return live * head_groups(cfg.kv_repeats)
    return calls * S


def _int32(x):
    """A position for K8: an int, or an int32 device tensor (others are
    converted on the card)."""
    if isinstance(x, torch.Tensor) and x.dtype != torch.int32:
        return x.to(torch.int32)
    return x


def active_window(cfg: ModelConfig) -> int:
    """Sliding-window width if it can bind within max_seq_len, else 0."""
    w = cfg.sliding_window or 0
    return w if 0 < w < cfg.max_seq_len else 0


def _live_slots(pos, mask_from, S: int, cfg: ModelConfig, device):
    """Cache slots a query at slot pos sees: [mask_from, pos], within the
    sliding window. pos/mask_from: ints, or device tensors [...] ->
    [..., S] (a 0-d tensor, the decode step's position, gives [S]). Ints
    stay python numbers: making a CUDA tensor of one would copy it from
    the host and wait for the card."""
    t_ids = torch.arange(S, device=device)
    if isinstance(pos, torch.Tensor):
        pos = pos[..., None]
    if isinstance(mask_from, torch.Tensor):
        mask_from = mask_from[..., None]
    live = (t_ids <= pos) & (t_ids >= mask_from)
    if active_window(cfg):
        live &= t_ids > pos - cfg.sliding_window
    return live


def _attention(q, k_cache, v_cache, pos, cfg: ModelConfig, mask_from=0):
    """q: [n_heads*head_dim]; caches: [S, n_kv, hd]. Returns [n_heads*hd].
    K8 on the live rows where k8_route takes the cache, else the plain
    version over every slot."""
    if k8_route(q.device, k_cache.dtype, cfg):
        return decode_attention(q[None], k_cache[None], v_cache[None],
                                _int32(pos), _int32(mask_from),
                                active_window(cfg))[0]
    live = _live_slots(pos, mask_from, k_cache.shape[0], cfg, q.device)
    return _attn_core(q, k_cache.to(torch.float32),
                      v_cache.to(torch.float32), live, cfg)


def _attention_seq(Q, k_cache, v_cache, slots, mask_from: int,
                   cfg: ModelConfig):
    """Causal attention for prefill with materialized scores (the JAX
    package's "xla" route): Q [T, H*D] f32 (RoPE'd, kept in f32), caches
    [S, KV, D] already holding this block's rows, slots [T] the queries'
    cache slots. Query t sees slots [mask_from, slots[t]]; a query with no
    live slot gets 0. Returns [T, H*D] f32."""
    T = Q.shape[0]
    KV, rep, D = cfg.n_kv_heads, cfg.kv_repeats, cfg.head_dim
    qh = Q.reshape(T, KV, rep, D).to(torch.float32)
    scores = torch.einsum("tkrd,skd->tkrs", qh,
                          k_cache.to(torch.float32)) / math.sqrt(D)
    live = _live_slots(slots, mask_from, k_cache.shape[0], cfg, Q.device)
    scores = torch.where(live[:, None, None, :], scores,
                         torch.full_like(scores, -math.inf))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isnan(probs), torch.zeros_like(probs), probs)
    out = torch.einsum("tkrs,skd->tkrd", probs, v_cache.to(torch.float32))
    return out.reshape(T, cfg.n_heads * D)


def _q16_floor(f: float) -> int:
    return int(np.round(np.float32(f) * np.float32(65536.0)))


def proj_efforts(effort, cfg: ModelConfig) -> dict:
    """Per-projection effective efforts under cfg.effort_floors
    (effective = max(effort, floor); fused projections take the max floor
    of their parts). Python floats stay floats, so the effort >= 1 dense
    fast path keeps working; tensors (f32, or 16.16 int32) stay tensors."""
    fl = cfg.effort_floors or {}

    def mk(*names):
        f = max((fl.get(n, 0.0) for n in names), default=0.0)
        if not f:
            return effort
        if isinstance(effort, (int, float)):
            return max(float(effort), f)
        if effort.dtype == torch.int32:
            return torch.clamp(effort, min=_q16_floor(f))
        return torch.clamp(effort.to(torch.float32), min=float(np.float32(f)))

    return {"wq": mk("wq"), "wk": mk("wk"), "wv": mk("wv"),
            "wo": mk("wo"), "w1": mk("w1"), "w3": mk("w3"),
            "w2": mk("w2"), "wqkv": mk("wq", "wk", "wv"),
            "w13": mk("w1", "w3")}


def _psum(x: torch.Tensor, tp) -> torch.Tensor:
    """x summed over the tensor-parallel axis tp = (mesh, axis) (a copy:
    the all-reduce works in place); x itself when tp is None."""
    if tp is None:
        return x
    mesh, axis = tp
    y = x.clone()
    dist.all_reduce(y, group=mesh.get_group(axis))
    return y


def _gated(w13: BucketedMatrix, w2: BucketedMatrix, inst, x, pe: dict,
           impl: str, mv=bucket_matvec):
    """Gated FFN of instance inst of a fused w1|w3 and its w2, the hidden
    width half of w13's output."""
    x13 = mv(w13, x, pe["w13"], inst, impl)
    hid = x13.shape[-1] // 2
    return mv(w2, torch.nn.functional.silu(x13[..., :hid]) * x13[..., hid:],
              pe["w2"], inst, impl)


def _expert_ffn(layer: LayerWeights, inst, x, pe: dict, cfg: ModelConfig,
                impl: str, mv=bucket_matvec):
    """Gated FFN of one instance (layer l of a dense model, moe_layer(l) *
    E + e of an MoE layer; an int or a 0-d int32 device tensor) on x [dim]
    (mv = bucket_matvec) or on rows X [T, dim] (mv = bucket_matmul)."""
    if layer.w13 is not None:
        return _gated(layer.w13, layer.w2, inst, x, pe, impl, mv)
    x1 = mv(layer.w1, x, pe["w1"], inst, impl)
    x3 = mv(layer.w3, x, pe["w3"], inst, impl)
    x2 = torch.nn.functional.silu(x1) * x3
    return mv(layer.w2, x2, pe["w2"], inst, impl)


def _add_shared(out, layer: LayerWeights, l: int, X, pe: dict,
                cfg: ModelConfig, impl: str, mv=bucket_matvec):
    """out plus the shared experts of MoE layer l (one FFN, instance
    moe_layer(l)); out itself when the model has none."""
    if not cfg.n_shared_experts:
        return out
    return out + _gated(layer.shared_w13, layer.shared_w2,
                        cfg.moe_layer(l), X, pe, impl, mv)


def route(layer: LayerWeights, l: int, x, cfg: ModelConfig):
    """Top-k gating of layer l for x [..., dim]: (gates [..., k] f32 and
    experts [..., k] int32, best first). The logits are the bf16 product
    with the layer's gate (ffn_gate[moe_layer(l)]) accumulated in f32;
    equal logits go to the lower expert, as lax.top_k breaks ties (a
    stable descending sort; torch.topk does not promise the order). The
    gates: the softmax of the top-k logits (gate_scoring "topk"), or
    (DeepSeek-V2, "all") the top k of the softmax over every logit, not
    renormalised. On the device, with no host read."""
    lead = x.shape[:-1]
    logits = mm_f32(x.to(torch.bfloat16).reshape(-1, cfg.dim),
                    layer.ffn_gate[cfg.moe_layer(l)]).reshape(
                        *lead, cfg.n_experts)
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_per_tok
    idx = idx[..., :k]
    if cfg.gate_scoring == "topk":
        return torch.softmax(top[..., :k], dim=-1), idx.to(torch.int32)
    return (torch.softmax(logits, dim=-1).gather(-1, idx),
            idx.to(torch.int32))


def _ffn(layer: LayerWeights, l: int, x, pe: dict, cfg: ModelConfig,
         impl: str, tp=None):
    """FFN of layer l on one token x [dim]: the dense gated FFN, or the
    MoE one (the JAX package's _ffn): the gates of the top-k experts, and
    out = sum over i in top-k order of gates[i] * FFN_{m*E + e_i}(x), in
    f32 (m = moe_layer(l)), then the shared experts added (DeepSeek-V2;
    its leading dense layers run dense_w13 / dense_w2). Each instance
    stays a 0-d int32 device tensor, so K1 / K4 read it on the card and
    the layer waits on no host read. tp: summed over that axis after w2
    (dense) or after the gated sum (MoE)."""
    E = cfg.n_experts
    if E == 1:
        return _psum(_expert_ffn(layer, l, x, pe, cfg, impl), tp)
    if l < cfg.first_dense_layers:
        return _psum(_gated(layer.dense_w13, layer.dense_w2, l, x, pe,
                            impl), tp)
    gates, idx = route(layer, l, x, cfg)
    base = cfg.moe_layer(l) * E
    out = None
    for i in range(cfg.n_experts_per_tok):
        y = gates[i] * _expert_ffn(layer, idx[i] + base, x, pe, cfg, impl)
        out = y if out is None else out + y
    return _psum(_add_shared(out, layer, l, x, pe, cfg, impl), tp)


def _row_efforts(pe: dict, rows) -> dict:
    """The per-projection efforts of some rows of a batch: an effort per
    row ([T] tensor) is taken at `rows` (an int, or an index tensor);
    a shared one stays as it is."""
    def pick(e):
        if not isinstance(e, torch.Tensor) or e.ndim == 0:
            return e
        return e[rows] if isinstance(rows, int) else e.index_select(0, rows)
    return {k: pick(e) for k, e in pe.items()}


def _moe_rows(layer: LayerWeights, l: int, X, pe: dict, cfg: ModelConfig,
              impl: str):
    """The MoE FFN on rows X [T, dim], one token at a time (each row at
    its own effort): the JAX package's vmap of the per-token FFN. On the
    kernel route, K1 (or K4) a row and expert, with device instances."""
    return torch.stack([_ffn(layer, l, X[t], _row_efforts(pe, t), cfg, impl)
                        for t in range(X.shape[0])])


def _moe_grouped(layer: LayerWeights, l: int, X, pe: dict,
                 cfg: ModelConfig, impl: str):
    """The MoE FFN on rows X [T, dim], grouped by expert: the routing of
    every row is read to the host once (HOST_READS["moe_routing"]), then
    each expert that has rows runs once over them (bucket_matmul: K2 on
    the kernel route, each row at its own effort, the stream as long as
    its longest row needs) and gates * y is added in each row's top-k
    order, as _ffn adds."""
    T, E, k = X.shape[0], cfg.n_experts, cfg.n_experts_per_tok
    gates, idx = route(layer, l, X, cfg)
    flat = idx.reshape(-1).long()                  # (row, i) pairs
    order = torch.argsort(flat, stable=True)       # grouped by expert
    # the counts of each expert, read to the host (torch.bincount would
    # read its input's maximum first: a second wait)
    counts = (flat[:, None] == torch.arange(E, device=X.device)).sum(
        0).tolist()
    HOST_READS["moe_routing"] += 1
    Y = torch.empty((T * k, cfg.dim), dtype=torch.float32, device=X.device)
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        pairs = order[start:start + n]
        rows = torch.div(pairs, k, rounding_mode="floor")
        Y.index_copy_(0, pairs, _expert_ffn(
            layer, cfg.moe_layer(l) * E + e, X.index_select(0, rows),
            _row_efforts(pe, rows), cfg, impl, mv=bucket_matmul))
        start += n
    Y = Y.reshape(T, k, cfg.dim)
    out = gates[:, :1] * Y[:, 0]
    for i in range(1, k):
        out = out + gates[:, i:i + 1] * Y[:, i]
    return _add_shared(out, layer, l, X, pe, cfg, impl, mv=bucket_matmul)


def _ffn_seq(layer: LayerWeights, l: int, X, pe: dict, cfg: ModelConfig,
             impl: str, moe_grouped: bool = True, tp=None):
    """Batched FFN for prefill (and a dense model's batched decode): X
    [T, dim]. Dense models run one bucket_matmul a projection; MoE models
    token by token on the "reference" route (as the JAX package vmaps its
    per-token FFN, on "jnp" whatever its impl) and grouped by expert on
    the others (K2 on the kernel route, where the JAX package's "auto"
    takes "jnp"). moe_grouped=False runs an MoE FFN token by token on
    every route (_moe_rows: no host read, so a captured pass can hold
    it). tp: the rows summed over that axis, as _ffn sums one."""
    if cfg.n_experts == 1:
        return _psum(_expert_ffn(layer, l, X, pe, cfg, impl,
                                 mv=bucket_matmul), tp)
    if l < cfg.first_dense_layers:
        return _psum(_gated(layer.dense_w13, layer.dense_w2, l, X, pe, impl,
                            mv=bucket_matmul), tp)
    if impl == "reference" or not moe_grouped:
        return _psum(_moe_rows(layer, l, X, pe, cfg, impl), tp)
    return _psum(_moe_grouped(layer, l, X, pe, cfg, impl), tp)


def _qkv(lw: LayerWeights, l: int, x, pe: dict, cfg: ModelConfig,
         impl: str, mv=bucket_matvec):
    """q, k, v of layer l for x [..., dim], through the fused projection
    when the weights have one."""
    q_out, kv_out = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    if lw.wqkv is not None:
        qkv = mv(lw.wqkv, x, pe["wqkv"], l, impl)
        return (qkv[..., :q_out], qkv[..., q_out:q_out + kv_out],
                qkv[..., q_out + kv_out:])
    return (mv(lw.wq, x, pe["wq"], l, impl), mv(lw.wk, x, pe["wk"], l, impl),
            mv(lw.wv, x, pe["wv"], l, impl))


def forward_layers(w: ModelWeights, cfg: ModelConfig, h, pos, k_cache,
                   v_cache, effort=1.0, impl: str = "auto",
                   rope_offset=0, mask_from=0, kv_update_fn=None,
                   attn_fn=None, collect_h: bool = False, tp=None,
                   ffn_fn=None):
    """The layer stack only: h [dim] f32 through cfg.n_layers blocks,
    writing this position's K/V rows into the caches in place. Returns h,
    or with collect_h (h, h_layers [L, dim]: the residual after each
    layer, as the JAX package's scan stacks it).
    pos, rope_offset, mask_from: ints or 0-d int device tensors. The hooks
    (see forward_token) replace the row write, the attention read and the
    FFN; tp sums over a tensor-parallel axis (the module docstring).
    An MLA model (cfg.is_mla) runs models/mla.forward_layers, k_cache its
    latent cache (v_cache unused), with no hooks."""
    if cfg.is_mla:
        from effort_tpu_torch.models import mla
        if (kv_update_fn or attn_fn or collect_h or tp is not None
                or ffn_fn is not None):
            raise ValueError("an MLA model's decode step takes no KV hooks, "
                             "collect_h, tp or ffn_fn")
        return mla.forward_layers(w, cfg, h, pos, k_cache, effort, impl,
                                  rope_offset, mask_from)
    KV, D = cfg.n_kv_heads, cfg.head_dim
    pe = proj_efforts(effort, cfg)
    lw = w.layers
    cos, sin = rope_angles(pos - rope_offset, D, cfg.rope_theta, h.device)
    h_layers = []
    for l in range(cfg.n_layers):
        h_norm = rms_norm(h, lw.attn_norm[l], cfg.norm_eps)
        q, k, v = _qkv(lw, l, h_norm, pe, cfg, impl)
        q = rope_apply(q.reshape(cfg.n_heads, D), cos, sin).reshape(-1)
        k = rope_apply(k.reshape(KV, D), cos, sin)
        v = v.reshape(KV, D)
        if kv_update_fn is not None:
            kv_update_fn(k_cache, v_cache, l, pos, k, v)
        else:
            write_row(k_cache, l, pos, k)
            write_row(v_cache, l, pos, v)
        if attn_fn is not None:
            attn = attn_fn(q, k_cache, v_cache, l, pos)
        else:
            attn = _attention(q, k_cache[l], v_cache[l], pos, cfg,
                              mask_from)
        h = h + _psum(bucket_matvec(lw.wo, attn, pe["wo"], l, impl), tp)
        f_norm = rms_norm(h, lw.ffn_norm[l], cfg.norm_eps)
        if ffn_fn is not None:
            h = h + ffn_fn(lw, l, f_norm)
        else:
            h = h + _ffn(lw, l, f_norm, pe, cfg, impl, tp)
        if collect_h:
            h_layers.append(h)
    if collect_h:
        return h, torch.stack(h_layers)
    return h


def _attn_impl(attn_impl: str, dev) -> str:
    if attn_impl == "auto":
        attn_impl = "flash" if dev.type == "cuda" else "xla"
    if attn_impl not in ("flash", "plain", "xla"):
        raise ValueError(f"attn_impl {attn_impl!r}")
    return attn_impl


def _write_slots(k_cache: torch.Tensor, v_cache: torch.Tensor, slots, K,
                 V) -> None:
    """k_cache[slots] = K and v_cache[slots] = V by index (rows [T, KV, D]
    into a layer's [S, KV, D]), with no host slice, so a device start slot
    needs no host read; slots past the cache are clamped to its last row
    (the callers check lengths on the host)."""
    idx = slots.clamp(max=k_cache.shape[0] - 1).long()
    k_cache.index_copy_(0, idx, K.to(k_cache.dtype))
    v_cache.index_copy_(0, idx, V.to(v_cache.dtype))


def forward_seq(w: ModelWeights, cfg: ModelConfig, token_ids: torch.Tensor,
                k_cache, v_cache, start_slot=0, rope_offset=0, mask_from=0,
                effort=1.0, impl: str = "auto", attn_impl: str = "auto",
                moe_grouped: bool = True, tp=None) -> torch.Tensor:
    """Prefill: T tokens of one sequence through all layers in one pass.

    token_ids: [T] int device tensor occupying cache slots start_slot ..
    start_slot+T-1; rope_offset/mask_from as in forward_token (left-padded
    prompts). start_slot, rope_offset, mask_from: ints, or 0-d int32
    device tensors (the speculative verify's position): the pass then
    reads no host value and can be captured; ints give what they gave
    before, bit for bit. The caches [L, S, KV, D] (or views of them) are
    written in place, by index. effort: a python float or an f32 tensor
    (each projection is one bucket_matmul: K2 on the kernel route).
    attn_impl: "flash" (K3, its plain version on CPU tensors), "plain"
    (K3's plain version on any device), "xla" (materialized f32 scores,
    _attention_seq) or "auto" (flash on the card, where K3 raises for
    heads it does not take; xla on the CPU). moe_grouped: an MoE FFN
    grouped by expert (_moe_grouped, one host read of the routing a
    layer) or, False, token by token (_moe_rows, no host read). tp: a
    rank's shard, summed over that axis after wo and the FFN (the module
    docstring). Returns logits [T, vocab] f32 through the bf16 head (a
    rank's vocabulary shard under tp)."""
    T = token_ids.shape[0]
    dev = w.device
    if cfg.is_mla:
        from effort_tpu_torch.models import mla
        if tp is not None:
            raise ValueError("an MLA model's prefill takes no tp")
        return mla.forward_seq(w, cfg, token_ids, k_cache, start_slot,
                               rope_offset, mask_from, effort, impl,
                               moe_grouped)
    attn_impl = _attn_impl(attn_impl, dev)
    KV, D, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    if not isinstance(start_slot, torch.Tensor) \
            and start_slot + T > k_cache.shape[1]:
        raise ValueError(f"slots {start_slot}..{start_slot + T - 1} past "
                         f"the cache's {k_cache.shape[1]}")
    X = w.tok_embeddings.index_select(0, token_ids.long()).to(torch.float32)
    slots = start_slot + torch.arange(T, device=dev)
    cos, sin = rope_angles(slots - rope_offset, D, cfg.rope_theta, dev)
    cos, sin = cos[:, None], sin[:, None]
    pe = proj_efforts(effort, cfg)
    lw = w.layers
    for l in range(cfg.n_layers):
        Xn = rms_norm(X, lw.attn_norm[l], cfg.norm_eps)
        Q, K, V = _qkv(lw, l, Xn, pe, cfg, impl, mv=bucket_matmul)
        Q = rope_apply(Q.reshape(T, H, D), cos, sin).reshape(T, H * D)
        K = rope_apply(K.reshape(T, KV, D), cos, sin)
        _write_slots(k_cache[l], v_cache[l], slots, K, V.reshape(T, KV, D))
        if attn_impl == "xla":
            attn = _attention_seq(Q, k_cache[l], v_cache[l], slots,
                                  mask_from, cfg)
        else:
            attn = flash_attention_seq(Q, k_cache[l], v_cache[l],
                                       start_slot, mask_from, H, D,
                                       window=active_window(cfg),
                                       plain=attn_impl == "plain")
        X = X + _psum(bucket_matmul(lw.wo, attn, pe["wo"], l, impl), tp)
        Fn = rms_norm(X, lw.ffn_norm[l], cfg.norm_eps)
        X = X + _ffn_seq(lw, l, Fn, pe, cfg, impl, moe_grouped, tp)
    X = rms_norm(X, w.norm, cfg.norm_eps)
    return mm_f32(X.to(torch.bfloat16), w.output)


def forward_seq_batch(w: ModelWeights, cfg: ModelConfig,
                      token_ids: torch.Tensor, k_cache, v_cache,
                      pos: torch.Tensor, offs: torch.Tensor,
                      efforts: torch.Tensor, impl: str = "auto",
                      attn_impl: str = "auto") -> torch.Tensor:
    """T tokens of each of B slots through all layers in one pass: the
    batched speculative verify (the JAX package's vmap of forward_seq over
    the slots of its batch cache).

    token_ids [B, T] int; pos, offs [B] int32 device tensors: slot b's
    tokens occupy its cache slots pos[b] .. pos[b]+T-1 (clamped to the
    cache's last row), rotary positions slot - offs[b], and attend to
    slots [offs[b], slot]. efforts [B] f32: each slot's effort. Every
    projection is one bucket_matmul over the B*T rows, each row at its
    slot's effort (K2 on the kernel route: the weights are read once for
    every slot, where the JAX package's vmap maps one pass a slot);
    attention runs once a slot (K3 reading pos[b] and offs[b] on the
    card, or materialized scores, as forward_seq's attn_impl); an MoE FFN
    token by token (_moe_rows). The caches [L, B, S, KV, D] are written
    in place. Returns logits [B, T, vocab] f32 through the bf16 head."""
    _no_mla_batch(cfg)
    B, T = token_ids.shape
    dev = w.device
    attn_impl = _attn_impl(attn_impl, dev)
    KV, D, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    X = w.tok_embeddings.index_select(0, token_ids.reshape(-1).long()).to(
        torch.float32)                                         # [B*T, dim]
    slots = pos[:, None] + torch.arange(T, device=dev)         # [B, T]
    cos, sin = rope_angles((slots - offs[:, None]).reshape(-1), D,
                           cfg.rope_theta, dev)
    cos, sin = cos[:, None], sin[:, None]
    pe = proj_efforts(efforts.to(torch.float32).repeat_interleave(T), cfg)
    bidx = torch.arange(B, device=dev).repeat_interleave(T)
    widx = slots.clamp(max=k_cache.shape[2] - 1).reshape(-1).long()
    lw = w.layers
    for l in range(cfg.n_layers):
        Xn = rms_norm(X, lw.attn_norm[l], cfg.norm_eps)
        Q, K, V = _qkv(lw, l, Xn, pe, cfg, impl, mv=bucket_matmul)
        Q = rope_apply(Q.reshape(B * T, H, D), cos, sin).reshape(B * T,
                                                                 H * D)
        K = rope_apply(K.reshape(B * T, KV, D), cos, sin)
        k_cache[l, bidx, widx] = K.to(k_cache.dtype)
        v_cache[l, bidx, widx] = V.reshape(B * T, KV, D).to(v_cache.dtype)
        parts = []
        for b in range(B):
            Qb = Q[b * T:(b + 1) * T]
            if attn_impl == "xla":
                parts.append(_attention_seq(Qb, k_cache[l, b], v_cache[l, b],
                                            slots[b], offs[b], cfg))
            else:
                parts.append(flash_attention_seq(
                    Qb, k_cache[l, b], v_cache[l, b], pos[b], offs[b], H, D,
                    window=active_window(cfg), plain=attn_impl == "plain"))
        attn = torch.cat(parts)
        X = X + bucket_matmul(lw.wo, attn, pe["wo"], l, impl)
        Fn = rms_norm(X, lw.ffn_norm[l], cfg.norm_eps)
        X = X + _ffn_seq(lw, l, Fn, pe, cfg, impl, moe_grouped=False)
    X = rms_norm(X, w.norm, cfg.norm_eps)
    return mm_f32(X.to(torch.bfloat16), w.output).reshape(B, T, -1)


def _no_mla_batch(cfg: ModelConfig) -> None:
    if cfg.is_mla:
        raise ValueError("batched decode of an MLA model (DeepSeek-V2) is "
                         "not in the port: no batched latent cache, K9 over "
                         "slots or K3 at unequal head widths")


def make_batch_kv_cache(cfg: ModelConfig, batch_size: int, device,
                        dtype=torch.bfloat16):
    """The batch KV cache: [L, B, S, KV, D] per side (the int8 one is
    make_quant_kv_cache(cfg, device, batch_size))."""
    shape = (cfg.n_layers, batch_size, cfg.max_seq_len, cfg.n_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def forward_token_batch(w: ModelWeights, cfg: ModelConfig,
                        toks: torch.Tensor, pos: torch.Tensor, k_cache,
                        v_cache, efforts: torch.Tensor,
                        offs: Optional[torch.Tensor] = None,
                        impl: str = "auto",
                        kv_quant: bool = False) -> torch.Tensor:
    """Batched decode step: B slots advance together.

    toks/pos/offs: [B] int device tensors (token, cache slot, left-pad
    offset of each slot); efforts: [B] f32 device tensor, one effort per
    slot, floored per projection by cfg.effort_floors. Caches
    [L, B, S, KV, D] are written in place at each slot's pos. Every
    projection is one bucket_matmul over the B slots (the JAX package's
    _mv_batch): K2 on the kernel route, the slots' own efforts inside one
    launch. An MoE FFN runs slot by slot (_moe_rows: the JAX package's
    vmap; K1 a slot and expert on the kernel route, with device
    instances, so the step waits on no host read of the routing).
    Attention is K8 a layer over each slot's live rows on the card
    (k8_route), reading pos and offs there. kv_quant: the caches are int8
    (data [L, B, S, KV, D], scale [L, B, S, KV]) pairs per side
    (make_quant_kv_cache), each new row quantized per kv head, and
    attention takes the plain version. Returns logits [B, vocab] f32."""
    _no_mla_batch(cfg)
    B = toks.shape[0]
    dev = w.device
    KV, D, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    offs = torch.zeros_like(pos) if offs is None else offs
    pe = proj_efforts(efforts.to(torch.float32), cfg)
    X = w.tok_embeddings.index_select(0, toks.long()).to(torch.float32)
    cos, sin = rope_angles(pos - offs, D, cfg.rope_theta, dev)
    cos, sin = cos[:, None], sin[:, None]
    S = (k_cache[0] if kv_quant else k_cache).shape[2]
    k8 = not kv_quant and k8_route(dev, k_cache.dtype, cfg)
    if k8:
        pos32, offs32 = _int32(pos), _int32(offs)
    else:
        live = _live_slots(pos, offs, S, cfg, dev)                # [B, S]
    bidx, pidx = torch.arange(B, device=dev), pos.long()
    lw = w.layers
    for l in range(cfg.n_layers):
        Xn = rms_norm(X, lw.attn_norm[l], cfg.norm_eps)
        Q, K, V = _qkv(lw, l, Xn, pe, cfg, impl, mv=bucket_matmul)
        Q = rope_apply(Q.reshape(B, H, D), cos, sin).reshape(B, H * D)
        K = rope_apply(K.reshape(B, KV, D), cos, sin)
        V = V.reshape(B, KV, D)
        if kv_quant:
            for (data, scale), x in ((k_cache, K), (v_cache, V)):
                xq, xs = quantize_kv_rows(x.to(torch.float32))
                data[l, bidx, pidx] = xq
                scale[l, bidx, pidx] = xs
            (kd, ks), (vd, vs) = k_cache, v_cache
            attn = _attn_core(Q, kd[l].to(torch.float32) * ks[l][..., None],
                              vd[l].to(torch.float32) * vs[l][..., None],
                              live, cfg)
        else:
            k_cache[l, bidx, pidx] = K.to(k_cache.dtype)
            v_cache[l, bidx, pidx] = V.to(v_cache.dtype)
            if k8:
                attn = decode_attention(Q, k_cache[l], v_cache[l], pos32,
                                        offs32, active_window(cfg))
            else:
                attn = _attn_core(Q, k_cache[l].to(torch.float32),
                                  v_cache[l].to(torch.float32), live, cfg)
        X = X + bucket_matmul(lw.wo, attn, pe["wo"], l, impl)
        Fn = rms_norm(X, lw.ffn_norm[l], cfg.norm_eps)
        X = X + (_ffn_seq(lw, l, Fn, pe, cfg, impl) if cfg.n_experts == 1
                 else _moe_rows(lw, l, Fn, pe, cfg, impl))
    return head_logits_batch(w, rms_norm(X, w.norm, cfg.norm_eps))


def embed(w: ModelWeights, token_id) -> torch.Tensor:
    """Row token_id of the embedding as f32 [dim]; token_id is an int or a
    device tensor (read without a host sync)."""
    if isinstance(token_id, torch.Tensor):
        return w.tok_embeddings.index_select(
            0, token_id.reshape(1))[0].to(torch.float32)
    return w.tok_embeddings[token_id].to(torch.float32)


def forward_token(w: ModelWeights, cfg: ModelConfig, token_id, pos,
                  k_cache, v_cache, effort=1.0, impl: str = "auto",
                  rope_offset=0, mask_from=0, kv_update_fn=None,
                  attn_fn=None, collect_h: bool = False, tp=None,
                  ffn_fn=None):
    """One autoregressive step: embeds token_id at position pos, runs all
    layers, returns logits [vocab] f32 (the caches are updated in place).
    collect_h=True returns (logits, h_layers [L, dim] f32), the residual
    after each layer, which calibration (convert/calibrate.py) reads; it
    is for eager calls only (the captured step, models/graphs.py, does
    not take it).

    token_id, pos, rope_offset, mask_from: ints, or 0-d int device
    tensors (then the step reads no host value, and can be captured).
    rope_offset/mask_from support left-padded prompts: pos is the cache
    slot, pos - rope_offset the rotary position, and attention ignores
    slots < mask_from.

    kv_update_fn(k_cache, v_cache, l, pos, k [KV, D], v [KV, D]) and
    attn_fn(q, k_cache, v_cache, l, pos) -> [H*D] replace the row write
    and the attention read, with the JAX package's signatures; the port's
    hooks write in place and return nothing (ring_kv_hooks,
    quant_kv_hooks, whose caches are their own layouts; parallel/sp.py's
    sequence-sharded ones).

    tp = (mesh, axis): cfg is a rank's local config and the weights its
    shard (parallel/tp.py); the sums over the axis come after wo and after
    the FFN, and the logits are the rank's vocabulary shard.
    ffn_fn(layer, l, x) -> [dim] replaces the FFN (parallel/ep.py's
    expert-sharded MoE FFN)."""
    h = embed(w, token_id)
    out = forward_layers(w, cfg, h, pos, k_cache, v_cache, effort=effort,
                         impl=impl, rope_offset=rope_offset,
                         mask_from=mask_from, kv_update_fn=kv_update_fn,
                         attn_fn=attn_fn, collect_h=collect_h, tp=tp,
                         ffn_fn=ffn_fn)
    h, h_layers = out if collect_h else (out, None)
    logits = head_logits(w, rms_norm(h, w.norm, cfg.norm_eps))
    return (logits, h_layers) if collect_h else logits


# ---- random weights -------------------------------------------------------

@dataclasses.dataclass
class RawWeight:
    """A raw [n_inst, in_dim, out_dim] f32 weight made on demand:
    make(start, n) returns instances start..start+n-1. Each instance is
    drawn from its own seeded generator, so slices never depend on how the
    tensor was chunked, and a full-size model is never resident at once."""
    make: object
    n_inst: int
    in_dim: int
    out_dim: int

    @staticmethod
    def of(t: torch.Tensor) -> "RawWeight":
        return RawWeight(lambda s, n: t[s:s + n], *t.shape)


def _randn(shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def synth_raw_weights(cfg: ModelConfig, seed: int = 0, scale: float = 0.02,
                      rms_m=None, rms_f=None, device=None) -> dict:
    """Random dense weights, made on `device`.

    rms_m [dim] / rms_f [hidden] optionally imprint persistent-outlier
    activation structure: every producer writing into a space scales its
    output columns by that space's rms, so the model's activations show the
    per-dim magnitudes calibration assumes."""
    device = resolve_device(device)
    L, E, dim, hid = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim
    q_out = cfg.n_heads * cfg.head_dim
    kv_out = cfg.n_kv_heads * cfg.head_dim
    base = [seed * 1_000_003]

    def mk(n_inst, in_d, out_d, col_scale=None):
        base[0] += 1
        seed0 = base[0] * 100_003

        def make(s, n):
            out = torch.stack([_randn((in_d, out_d), seed0 + s + i, device)
                               for i in range(n)]) * scale
            if col_scale is not None:
                out = out * col_scale[None, None, :]
            return out
        return RawWeight(make, n_inst, in_d, out_d)

    raw = dict(
        wq=mk(L, dim, q_out),
        wk=mk(L, dim, kv_out),
        wv=mk(L, dim, kv_out),
        wo=mk(L, q_out, dim, rms_m),
        w1=mk(L * E, dim, hid, rms_f),
        w2=mk(L * E, hid, dim, rms_m),
        w3=mk(L * E, dim, hid, rms_f),
    )
    emb = _randn((cfg.vocab_size, dim), seed * 7 + 1, device) * scale
    raw.update(
        ffn_gate=(_randn((L, dim, E), seed * 7 + 2, device) * scale
                  if E > 1 else None),
        tok_embeddings=emb * rms_m[None, :] if rms_m is not None else emb,
        output=_randn((dim, cfg.vocab_size), seed * 7 + 3, device) * scale,
        attn_norm=torch.ones((L, dim), device=device),
        ffn_norm=torch.ones((L, dim), device=device),
        norm=torch.ones((dim,), device=device),
    )
    return raw


def _concat_raw(entries) -> RawWeight:
    """Concatenate raw weights along the output-column axis."""
    rws = [e if isinstance(e, RawWeight) else RawWeight.of(e)
           for e in entries]
    n_inst, in_d = rws[0].n_inst, rws[0].in_dim
    if any(r.n_inst != n_inst or r.in_dim != in_d for r in rws):
        raise ValueError("fused parts differ in instances or input width")
    return RawWeight(
        lambda s, n: torch.cat([r.make(s, n) for r in rws], dim=2),
        n_inst, in_d, sum(r.out_dim for r in rws))


def _bucketed(wt, bcfg: BucketConfig, keep_dense: bool = False,
              bake: bool = True, percent_load: float = 1.0, in_rms=None,
              in_pi=None, out_pi=None):
    """One raw weight (a tensor [n_inst, in, out] or a RawWeight) as one
    BucketedMatrix, bucketized a slice of instances at a time (~1 GB of
    f32): baked with in_pi / out_pi, or with the run-time permute of
    in_rms (bake=False)."""
    from effort_tpu_torch.models.weights import truncate_bucketed
    rw = wt if isinstance(wt, RawWeight) else RawWeight.of(wt)
    b = dataclasses.replace(
        bcfg, chunk_rows=pick_chunk_rows(bcfg, rw.in_dim, rw.out_dim))
    chunk = max(1, int(2**30 // (rw.in_dim * rw.out_dim * 4)))

    def parts():
        for s in range(0, rw.n_inst, chunk):
            wt_c = rw.make(s, min(chunk, rw.n_inst - s))
            dev = wt_c.device
            if bake:
                p = bucketize(wt_c, b, keep_dense=keep_dense,
                              in_perm=_on(in_pi, dev),
                              out_perm=_on(out_pi, dev))
            else:
                p = bucketize(wt_c, b, keep_dense=keep_dense,
                              act_rms=_on(in_rms, dev), perm_segment=1)
            del wt_c
            if percent_load < 1.0:
                p = truncate_bucketed(p, percent_load)
            yield p
    return concat_bucketed(parts(), rw.n_inst)


def assemble_weights(raw: dict, cfg: ModelConfig, bcfg: BucketConfig,
                     keep_dense: bool = False, rms_m=None, rms_f=None,
                     bake: bool = True, fuse: bool = False,
                     percent_load: float = 1.0, rms_e=None,
                     rms_s=None) -> ModelWeights:
    """Bucketize raw dense weights (tensors [n_inst, in, out] or RawWeight)
    into ModelWeights, a slice of instances at a time (~1 GB of f32).

    fuse=True builds the fused q|k|v and w1|w3 projections.
    percent_load < 1 applies truncated loading per slice.
    With rms calibration and bake=True the whole-model relayout runs: the
    residual space is permuted once (pi_m, descending rms) and each FFN
    hidden space likewise (pi_f), absorbed entirely into the weights:
      pi_m: tok_embeddings cols, wq/wk/wv/w1/w3 input rows, wo/w2 output
            cols, norm weights, lm-head rows.
      pi_f: w1/w3 output cols, w2 input rows.
    The forward pass is unchanged and no run-time permute exists.
    bake=False keeps the run-time permute (seg_order) form instead.
    An MLA model (DeepSeek-V2) is assembled by models/mla.assemble, always
    fused and baked; rms_e / rms_s are its routed and shared experts'
    hidden spaces (rms_f its dense layers').
    """
    if cfg.is_mla:
        from effort_tpu_torch.models import mla
        return mla.assemble(raw, cfg, bcfg, keep_dense, rms_m, rms_f, rms_e,
                            rms_s)
    pi_m = calib_row_order(rms_m) if rms_m is not None else None
    pi_f = calib_row_order(rms_f) if rms_f is not None else None

    def bucketed(wt, in_rms=None, in_pi=None, out_pi=None):
        return _bucketed(wt, bcfg, keep_dense, bake, percent_load, in_rms,
                         in_pi, out_pi)

    out_head = raw["output"]
    emb = raw["tok_embeddings"]
    attn_norm, ffn_norm, norm = (raw["attn_norm"], raw["ffn_norm"],
                                 raw["norm"])
    if bake and pi_m is not None:
        pm = _on(pi_m, emb.device).long()
        emb = emb[:, pm]
        out_head = out_head[pm, :]
        attn_norm = attn_norm[:, pm]
        ffn_norm = ffn_norm[:, pm]
        norm = norm[pm]

    if fuse:
        # out_perm acts within each fused half: w1 and w3 columns each
        # carry the hidden-space permutation pi_f
        pi_13 = (None if pi_f is None else
                 torch.cat([pi_f, pi_f + cfg.hidden_dim]))
        proj = dict(
            wq=None, wk=None, wv=None, w1=None, w3=None,
            wqkv=bucketed(_concat_raw([raw["wq"], raw["wk"], raw["wv"]]),
                          rms_m, pi_m),
            w13=bucketed(_concat_raw([raw["w1"], raw["w3"]]),
                         rms_m, pi_m, pi_13),
        )
    else:
        proj = dict(
            wq=bucketed(raw["wq"], rms_m, pi_m),
            wk=bucketed(raw["wk"], rms_m, pi_m),
            wv=bucketed(raw["wv"], rms_m, pi_m),
            w1=bucketed(raw["w1"], rms_m, pi_m, pi_f),
            w3=bucketed(raw["w3"], rms_m, pi_m, pi_f),
        )
    gate = raw["ffn_gate"]
    if gate is not None:
        if bake and pi_m is not None:
            gate = gate[:, _on(pi_m, gate.device).long(), :]
        gate = gate.to(torch.bfloat16)
    layers = LayerWeights(
        attn_norm=attn_norm.to(torch.float32),
        ffn_norm=ffn_norm.to(torch.float32),
        wo=bucketed(raw["wo"], None, None, pi_m if bake else None),
        w2=bucketed(raw["w2"], rms_f, pi_f, pi_m),
        ffn_gate=gate,
        **proj,
    )
    return ModelWeights(
        tok_embeddings=emb.to(torch.bfloat16),
        norm=norm.to(torch.float32),
        output=out_head.to(torch.bfloat16),
        layers=layers,
    )


def _on(x, device):
    return None if x is None else torch.as_tensor(x).to(device)


def tile_layers(w: ModelWeights, cfg1: ModelConfig,
                n_layers: int) -> ModelWeights:
    """A 1-layer model's layer stack repeated to n_layers distinct copies
    on its device (concat_bucketed; no new weights, no bucketization): a
    full-depth model with a real model's bytes, layouts and selection
    counts at 1/depth of the build's cost, for timing. Every layer holds
    the same weights, so it says nothing of quality. An MoE layer's
    experts stay together: instance l * E + e."""
    if cfg1.n_layers != 1:
        raise ValueError("tile_layers expects a 1-layer source")
    lw = w.layers
    repl = {f: concat_bucketed([getattr(lw, f)] * n_layers)
            for f in PROJ_FIELDS if getattr(lw, f) is not None}
    repl["attn_norm"] = lw.attn_norm.repeat(n_layers, 1)
    repl["ffn_norm"] = lw.ffn_norm.repeat(n_layers, 1)
    if lw.ffn_gate is not None:
        repl["ffn_gate"] = lw.ffn_gate.repeat(n_layers, 1, 1)
    return dataclasses.replace(w, layers=dataclasses.replace(lw, **repl))


def init_random_weights(cfg: ModelConfig, bcfg: BucketConfig,
                        seed: int = 0, keep_dense: bool = False,
                        scale: float = 0.02, calibrate: bool = False,
                        rms_sigma: float = 1.2, fuse: bool = False,
                        percent_load: float = 1.0,
                        device=None) -> ModelWeights:
    """Random-weight model, made on `device` (the card unless named).

    calibrate=True imprints persistent-outlier activation structure
    (lognormal per-dim rms) into the weights and runs the whole-model
    baked relayout on it (see assemble_weights)."""
    device = resolve_device(device)
    rms_m = rms_f = None
    if calibrate:
        rms_m = torch.exp(_randn((cfg.dim,), seed + 777, device)
                          * rms_sigma)
        rms_f = torch.exp(_randn((cfg.hidden_dim,), seed + 778, device)
                          * rms_sigma)
    raw = synth_raw_weights(cfg, seed=seed, scale=scale, rms_m=rms_m,
                            rms_f=rms_f, device=device)
    return assemble_weights(raw, cfg, bcfg, keep_dense=keep_dense,
                            rms_m=rms_m, rms_f=rms_f, fuse=fuse,
                            percent_load=percent_load)
