"""Transformer decode forward pass (Mistral family) with the effort knob,
and random-weight synthesis.

  - Bucketized projection weights of all layers are packed into single
    BucketedMatrix containers (instance axis = layer); the kernel indexes an
    instance by its offset, so the layer loop never slices weights.
  - GQA is a reshape of the query heads, KV-head major, not a repeat.
  - KV cache: [n_layers, max_seq, n_kv_heads, head_dim] bf16, written in
    place (the JAX package returns updated copies; in place saves the copy).
  - The residual h stays f32 between layers; attention runs in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.ops.bucketize import (bucketize, calib_row_order,
                                            pick_chunk_rows)
from effort_tpu_torch.ops.bucketmul import bucket_matvec, dense_matvec, mm_f32
from effort_tpu_torch.ops.layouts import BucketedMatrix, concat_bucketed

PROJ_FIELDS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wqkv", "w13")


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


def _int8_matvec(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """x [k] int8 @ wq [k, n] int8 -> [n] int32, exact."""
    a = torch.zeros((_INT_MM_ROWS, x.shape[0]), dtype=torch.int8,
                    device=x.device)
    a[0] = x
    return torch._int_mm(a, wq)[0]


def head_logits(w: ModelWeights, h: torch.Tensor) -> torch.Tensor:
    """Decode LM head: h [dim] -> logits [vocab] f32.

    With an int8 head: symmetric per-tensor int8 activation times the
    per-column int8 weights, accumulated in int32; then, when the bf16 head
    is kept, the top-16 logits are recomputed exactly in bf16."""
    if w.output_q is None:
        return dense_matvec(h, w.output)
    vm = h.abs().max() / 127.0 + 1e-30
    hi = torch.round(h / vm).to(torch.int8)
    y = _int8_matvec(hi, w.output_q).to(torch.float32) \
        * (w.output_qscale * vm)
    if w.output is not None:
        top_i = torch.topk(y, _HEAD_RESCORE_K).indices
        cols = w.output.index_select(1, top_i)                # [dim, 16]
        exact = mm_f32(h.to(torch.bfloat16)[None], cols)[0]
        y = y.scatter(0, top_i, exact)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMS norm over the last axis."""
    x = x.to(torch.float32)
    inv = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return x * inv * weight


_FREQS: dict = {}


def rope_angles(pos: int, head_dim: int, theta: float, device):
    """(cos, sin) [head_dim // 2] f32 at integer position pos, frequencies
    theta ** (-i / h) in f32."""
    key = (head_dim, theta, str(device))
    if key not in _FREQS:
        h = head_dim // 2
        _FREQS[key] = (theta ** (-torch.arange(0, h, dtype=torch.float32)
                                 / h)).to(device)
    angle = float(pos) * _FREQS[key]
    return torch.cos(angle), torch.sin(angle)


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
    shape = (cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _attn_core(q, kf, vf, live, cfg: ModelConfig):
    """Masked-softmax attention read for one query token.
    q [H*D]; kf/vf [S, KV, D] f32; live [S] bool."""
    KV, rep, D = cfg.n_kv_heads, cfg.kv_repeats, cfg.head_dim
    qh = q.reshape(KV, rep, D).to(torch.float32)
    scores = torch.einsum("krd,tkd->krt", qh, kf) / math.sqrt(D)
    scores = torch.where(live[None, None, :], scores,
                         torch.full_like(scores, -math.inf))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("krt,tkd->krd", probs, vf)
    return out.reshape(cfg.n_heads * D)


def active_window(cfg: ModelConfig) -> int:
    """Sliding-window width if it can bind within max_seq_len, else 0."""
    w = cfg.sliding_window or 0
    return w if 0 < w < cfg.max_seq_len else 0


def _attention(q, k_cache, v_cache, pos: int, cfg: ModelConfig,
               mask_from: int = 0):
    """q: [n_heads*head_dim]; caches: [S, n_kv, hd]. Returns [n_heads*hd]."""
    t_ids = torch.arange(cfg.max_seq_len, device=q.device)
    live = (t_ids <= pos) & (t_ids >= mask_from)
    if active_window(cfg):
        live &= t_ids > pos - cfg.sliding_window
    return _attn_core(q, k_cache.to(torch.float32),
                      v_cache.to(torch.float32), live, cfg)


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


def _ffn(layer: LayerWeights, l: int, x, pe: dict, cfg: ModelConfig,
         impl: str):
    if cfg.n_experts != 1:
        raise NotImplementedError("the MoE FFN is not ported yet")
    hid = cfg.hidden_dim
    if layer.w13 is not None:
        x13 = bucket_matvec(layer.w13, x, pe["w13"], l, impl)
        x1, x3 = x13[:hid], x13[hid:]
    else:
        x1 = bucket_matvec(layer.w1, x, pe["w1"], l, impl)
        x3 = bucket_matvec(layer.w3, x, pe["w3"], l, impl)
    x2 = torch.nn.functional.silu(x1) * x3
    return bucket_matvec(layer.w2, x2, pe["w2"], l, impl)


def forward_layers(w: ModelWeights, cfg: ModelConfig, h, pos: int, k_cache,
                   v_cache, effort=1.0, impl: str = "auto",
                   rope_offset: int = 0, mask_from: int = 0):
    """The layer stack only: h [dim] f32 through cfg.n_layers blocks,
    writing this position's K/V rows into the caches in place. Returns h."""
    KV, D = cfg.n_kv_heads, cfg.head_dim
    pe = proj_efforts(effort, cfg)
    q_out, kv_out = cfg.n_heads * D, KV * D
    lw = w.layers
    cos, sin = rope_angles(pos - rope_offset, D, cfg.rope_theta, h.device)
    for l in range(cfg.n_layers):
        h_norm = rms_norm(h, lw.attn_norm[l], cfg.norm_eps)
        if lw.wqkv is not None:
            qkv = bucket_matvec(lw.wqkv, h_norm, pe["wqkv"], l, impl)
            q, k, v = (qkv[:q_out], qkv[q_out:q_out + kv_out],
                       qkv[q_out + kv_out:])
        else:
            q = bucket_matvec(lw.wq, h_norm, pe["wq"], l, impl)
            k = bucket_matvec(lw.wk, h_norm, pe["wk"], l, impl)
            v = bucket_matvec(lw.wv, h_norm, pe["wv"], l, impl)
        q = rope_apply(q.reshape(cfg.n_heads, D), cos, sin).reshape(-1)
        k = rope_apply(k.reshape(KV, D), cos, sin)
        k_cache[l, pos] = k.to(k_cache.dtype)
        v_cache[l, pos] = v.reshape(KV, D).to(v_cache.dtype)
        attn = _attention(q, k_cache[l], v_cache[l], pos, cfg, mask_from)
        h = h + bucket_matvec(lw.wo, attn, pe["wo"], l, impl)
        f_norm = rms_norm(h, lw.ffn_norm[l], cfg.norm_eps)
        h = h + _ffn(lw, l, f_norm, pe, cfg, impl)
    return h


def embed(w: ModelWeights, token_id) -> torch.Tensor:
    """Row token_id of the embedding as f32 [dim]; token_id is an int or a
    device tensor (read without a host sync)."""
    if isinstance(token_id, torch.Tensor):
        return w.tok_embeddings.index_select(
            0, token_id.reshape(1))[0].to(torch.float32)
    return w.tok_embeddings[token_id].to(torch.float32)


def forward_token(w: ModelWeights, cfg: ModelConfig, token_id, pos: int,
                  k_cache, v_cache, effort=1.0, impl: str = "auto",
                  rope_offset: int = 0, mask_from: int = 0):
    """One autoregressive step: embeds token_id at position pos, runs all
    layers, returns logits [vocab] f32 (the caches are updated in place).

    rope_offset/mask_from support left-padded prompts: pos is the cache
    slot, pos - rope_offset the rotary position, and attention ignores
    slots < mask_from."""
    h = embed(w, token_id)
    h = forward_layers(w, cfg, h, pos, k_cache, v_cache, effort=effort,
                       impl=impl, rope_offset=rope_offset,
                       mask_from=mask_from)
    return head_logits(w, rms_norm(h, w.norm, cfg.norm_eps))


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


def assemble_weights(raw: dict, cfg: ModelConfig, bcfg: BucketConfig,
                     keep_dense: bool = False, rms_m=None, rms_f=None,
                     bake: bool = True, fuse: bool = False,
                     percent_load: float = 1.0) -> ModelWeights:
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
    """
    from effort_tpu_torch.models.weights import truncate_bucketed
    pi_m = calib_row_order(rms_m) if rms_m is not None else None
    pi_f = calib_row_order(rms_f) if rms_f is not None else None

    def bucketed(wt, in_rms=None, in_pi=None, out_pi=None):
        rw = wt if isinstance(wt, RawWeight) else RawWeight.of(wt)
        b = dataclasses.replace(
            bcfg, chunk_rows=pick_chunk_rows(bcfg, rw.in_dim, rw.out_dim))
        chunk = max(1, int(2**30 // (rw.in_dim * rw.out_dim * 4)))
        parts = []
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
            parts.append(p)
        return concat_bucketed(parts)

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
