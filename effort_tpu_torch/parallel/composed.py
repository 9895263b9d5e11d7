"""Composed 2D parallelism: tp x ep (MoE serving) and tp x sp (long-context
decode), the JAX package's parallel/composed.py, one process a rank.

tp x ep ("tp", "ep" mesh axes; rank = t * n_ep + e):
  - attention Megatron-sharded over tp as in tp.py (one sum after wo),
    replicated over ep;
  - the experts split over ep, and within an owner group every expert's
    w1/w3 output-sharded and w2 input-sharded over tp; containers
    ep-major, tp-minor (PartitionSpec(("ep", "tp")): rank (t, e) holds part
    e * n_tp + t);
  - decode FFN: gate replicated, each top-k expert kept on its owner group
    (ep.py's torch.where mask, tp-local matvecs), one sum over both axes
    merging w2's row partials and the non-owners' zeros;
  - logits vocabulary-sharded over tp and all-gathered.

tp x sp ("tp", "sp"; rank = t * n_sp + s):
  - weights as tp.py, replicated over sp;
  - the KV cache [L, S, KV, D] slots over sp and heads over tp; the new row
    written only by the owning sp rank, on its tp-local heads;
  - attention: sp.py's distributed online softmax over "sp" on the
    tp-local heads; the sums after wo and w2 over "tp".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.models.transformer import (LayerWeights, ModelWeights,
                                                 forward_token,
                                                 resolve_device,
                                                 synth_raw_weights)
from effort_tpu_torch.parallel import collectives
from effort_tpu_torch.parallel import tp as _tp
from effort_tpu_torch.parallel.ep import ep_ffn, expert_groups
from effort_tpu_torch.parallel.multihost import device_type_of
from effort_tpu_torch.parallel.sp import _sp_attention, _sp_kv_update

_EP_TP = ("w1", "w2", "w3")


def make_tp_ep_mesh(n_tp: int, n_ep: int, device="cpu"):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type_of(device), (n_tp, n_ep),
                            mesh_dim_names=("tp", "ep"))


def make_tp_sp_mesh(n_tp: int, n_sp: int, device="cpu"):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type_of(device), (n_tp, n_sp),
                            mesh_dim_names=("tp", "sp"))


def tp_ep_local_config(cfg: ModelConfig, n_tp: int, n_ep: int
                       ) -> ModelConfig:
    """A rank's view: tp divides heads, hidden units and vocabulary, ep the
    experts."""
    if cfg.n_experts % n_ep:
        raise ValueError(f"{cfg.n_experts} experts over {n_ep} ranks")
    return dataclasses.replace(_tp.local_config(cfg, n_tp),
                               n_experts=cfg.n_experts // n_ep)


def make_tp_ep_weights(cfg: ModelConfig, bcfg: BucketConfig, n_tp: int,
                       n_ep: int, seed: int = 0, scale: float = 0.02,
                       rank: Optional[int] = None, device=None
                       ) -> Tuple[ModelWeights, ModelConfig]:
    """Random-weight tp x ep MoE model from synth_raw_weights(cfg, seed).
    rank=r: rank r's containers (r = t * n_ep + e); rank=None the global
    layout: attention containers and head over tp on axis 0, expert
    containers ep-major, tp-minor (tp_ep_local splits them). Made on
    `device` (the card unless named)."""
    if not cfg.is_moe:
        raise ValueError("tp x ep needs an MoE config")
    dev = resolve_device(device)
    raw = synth_raw_weights(cfg, seed=seed, scale=scale, device=dev)
    L, E = cfg.n_layers, cfg.n_experts
    if rank is None:
        tps = range(n_tp)
        pairs = [(e, t) for e in range(n_ep) for t in range(n_tp)]
    else:
        t, e = divmod(rank, n_ep)
        tps, pairs = [t], [(e, t)]

    def attn(name, axis):
        rw = raw[name]
        n = rw.out_dim if axis == "cols" else rw.in_dim
        return _tp.stack_shards([_tp.bucketize_slices(
            rw, bcfg, [(0, L)], **{axis: _tp.span(n, n_tp, t)})
            for t in tps])

    def experts(name, axis):
        rw = raw[name]
        n = rw.out_dim if axis == "cols" else rw.in_dim
        return _tp.stack_shards([_tp.bucketize_slices(
            rw, bcfg, expert_groups(L, E, n_ep, e),
            **{axis: _tp.span(n, n_tp, t)}) for e, t in pairs])

    layers = LayerWeights(
        attn_norm=raw["attn_norm"].to(torch.float32),
        ffn_norm=raw["ffn_norm"].to(torch.float32),
        wq=attn("wq", "cols"), wk=attn("wk", "cols"), wv=attn("wv", "cols"),
        wo=attn("wo", "rows"), w1=experts("w1", "cols"),
        w2=experts("w2", "rows"), w3=experts("w3", "cols"),
        ffn_gate=raw["ffn_gate"].to(torch.bfloat16))
    head = raw["output"].to(torch.bfloat16)
    out = torch.cat([head[:, _tp.span(cfg.vocab_size, n_tp, t)]
                     for t in tps])
    w = ModelWeights(tok_embeddings=raw["tok_embeddings"].to(torch.bfloat16),
                     norm=raw["norm"].to(torch.float32),
                     output=out.contiguous(), layers=layers)
    return w, tp_ep_local_config(cfg, n_tp, n_ep)


def tp_ep_local(w: ModelWeights, n_tp: int, n_ep: int,
                rank: int) -> ModelWeights:
    """Rank (t, e)'s part of a global tp x ep layout (the JAX package's
    tp_ep_specs): attention containers and head part t of n_tp, expert
    containers part e * n_tp + t of n_ep * n_tp, the rest whole."""
    t, e = divmod(rank, n_ep)
    lw = w.layers
    repl = {f: _tp.shard_of(getattr(lw, f), n_tp, t)
            for f in ("wq", "wk", "wv", "wo", "wqkv")
            if getattr(lw, f) is not None}
    repl.update({f: _tp.shard_of(getattr(lw, f), n_ep * n_tp, e * n_tp + t)
                 for f in _EP_TP})
    return dataclasses.replace(w, layers=dataclasses.replace(lw, **repl),
                               output=_tp.part(w.output, n_tp, t))


def tp_ep_ffn(layer: LayerWeights, l: int, x, effort,
              cfg_local: ModelConfig, n_ep: int, impl: str, mesh,
              tp_axis: str = "tp", ep_axis: str = "ep") -> torch.Tensor:
    """The top-k experts on their owner ep group as tp-local matvecs; one
    sum over (tp, ep) merges w2's row partials and the non-owners'
    zeros."""
    return ep_ffn(layer, l, x, effort, cfg_local, n_ep, impl, mesh, ep_axis,
                  psum_axis=(tp_axis, ep_axis))


def tp_ep_forward_token(w_local: ModelWeights, cfg_local: ModelConfig,
                        token_id, pos, k_cache, v_cache, effort, impl: str,
                        n_ep: int, mesh, tp_axis: str = "tp",
                        ep_axis: str = "ep") -> torch.Tensor:
    """One decode step of a rank on a ("tp", "ep") mesh: the caches are
    the tp-local head shards (the same over ep); returns the full logits,
    the same on every rank."""
    def ffn(layer, l, x):
        return tp_ep_ffn(layer, l, x, effort, cfg_local, n_ep, impl, mesh,
                         tp_axis, ep_axis)
    logits_local = forward_token(w_local, cfg_local, token_id, pos, k_cache,
                                 v_cache, effort=effort, impl=impl,
                                 tp=(mesh, tp_axis), ffn_fn=ffn)
    return collectives.all_gather(logits_local, mesh, tp_axis, tiled=True)


def tp_sp_cache_local(cache: torch.Tensor, n_tp: int, n_sp: int,
                      rank: int) -> torch.Tensor:
    """Rank (t, s)'s part of a global cache [L, S, KV, D] (the JAX
    package's tp_sp_cache_specs: slots over sp, heads over tp), a copy."""
    t, s = divmod(rank, n_sp)
    S, KV = cache.shape[1], cache.shape[2]
    return cache[:, _tp.span(S, n_sp, s), _tp.span(KV, n_tp, t)].clone()


def tp_sp_forward_token(w_local: ModelWeights, cfg_local: ModelConfig,
                        token_id, pos, k_cache, v_cache, effort, impl: str,
                        n_sp: int, mesh, tp_axis: str = "tp",
                        sp_axis: str = "sp", rope_offset=0,
                        mask_from=0) -> torch.Tensor:
    """One decode step of a rank on a ("tp", "sp") mesh: weights tp.py's
    shard, the LOCAL caches [L, S / n_sp, KV / n_tp, D] written in place;
    the sp online softmax on the tp-local heads. Returns the full logits,
    the same on every rank."""
    s_loc = cfg_local.max_seq_len // n_sp

    def kv_up(kc, vc, l, p, k, v):
        _sp_kv_update(kc, vc, l, p, k, v, s_loc, mesh, sp_axis)

    def attn(q, kc, vc, l, p):
        return _sp_attention(q, kc[l], vc[l], p, cfg_local, s_loc, mesh,
                             sp_axis, mask_from)

    logits_local = forward_token(
        w_local, cfg_local, token_id, pos, k_cache, v_cache, effort=effort,
        impl=impl, tp=(mesh, tp_axis), rope_offset=rope_offset,
        mask_from=mask_from, kv_update_fn=kv_up, attn_fn=attn)
    return collectives.all_gather(logits_local, mesh, tp_axis, tiled=True)
