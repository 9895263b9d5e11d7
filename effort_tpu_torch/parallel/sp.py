"""Sequence parallelism: the KV cache sharded over the sequence axis (the
JAX package's parallel/sp.py, one process a rank).

The slot axis of the cache is block-sharded over an "sp" axis: rank i owns
slots [i * S_loc, (i + 1) * S_loc). A decode step:
  - writes the new K/V row only on the owning rank (a masked write: with a
    device position, no host read);
  - runs attention as a distributed online softmax: each rank takes its
    (max, exp-sum, weighted value) over its slots, and one pmax and two
    psums merge them exactly (the log-sum-exp merge flash attention uses
    blockwise, across ranks); the traffic a step is O(heads * head_dim).
Weights are replicated.
"""

from __future__ import annotations

import math

import torch

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.models.transformer import (ModelWeights, active_window,
                                                 forward_token, write_row)
from effort_tpu_torch.parallel import collectives
from effort_tpu_torch.parallel.multihost import device_type_of


def make_sp_mesh(n_sp: int, device="cpu"):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type_of(device), (n_sp,),
                            mesh_dim_names=("sp",))


def sp_cache_local(cache: torch.Tensor, n_sp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s slots of a global cache [L, S, KV, D] (the JAX
    package's sp_cache_specs: P(None, "sp", None, None)), a copy."""
    s_loc = cache.shape[1] // n_sp
    return cache[:, rank * s_loc:(rank + 1) * s_loc].clone()


def _sp_kv_update(k_cache, v_cache, l: int, pos, k, v, s_loc: int, mesh,
                  axis: str = "sp") -> None:
    """Masked write into the LOCAL caches [L, S_loc, KV, D]: only the rank
    owning slot pos stores the new row. pos: an int, or a 0-d int device
    tensor (then every rank writes its clamped slot with the old row where
    it does not own pos: no host read)."""
    local = pos - collectives.axis_index(mesh, axis) * s_loc
    if not isinstance(local, torch.Tensor):
        if 0 <= local < s_loc:
            write_row(k_cache, l, local, k)
            write_row(v_cache, l, local, v)
        return
    owns = (local >= 0) & (local < s_loc)
    slot = local.clamp(0, s_loc - 1)
    for cache, row in ((k_cache, k), (v_cache, v)):
        old = cache[l].index_select(0, slot.reshape(1).long())[0]
        write_row(cache, l, slot, torch.where(owns, row.to(cache.dtype), old))


def _sp_attention(q, k_local, v_local, pos, cfg_local: ModelConfig,
                  s_loc: int, mesh, axis: str = "sp", mask_from=0):
    """Distributed online-softmax attention over the sharded slots.
    q [H*D]; k_local/v_local [S_loc, KV, D], this rank's slots. Exact:
    the ranks' (m, s, o) merged with the log-sum-exp identity."""
    H, KV, D = cfg_local.n_heads, cfg_local.n_kv_heads, cfg_local.head_dim
    rep = cfg_local.kv_repeats
    my = collectives.axis_index(mesh, axis)
    qh = q.reshape(KV, rep, D).to(torch.float32)
    kf = k_local.to(torch.float32)
    vf = v_local.to(torch.float32)
    scores = torch.einsum("krd,tkd->krt", qh, kf) / math.sqrt(D)
    slots = my * s_loc + torch.arange(s_loc, device=q.device)
    mask = (slots <= pos) & (slots >= mask_from)
    if active_window(cfg_local):
        mask &= slots > pos - cfg_local.sliding_window
    scores = torch.where(mask, scores, torch.full_like(scores, -math.inf))
    m_glob = collectives.pmax(scores.amax(dim=-1), mesh, axis)   # [KV, rep]
    # a fully masked local slice: exp(-inf - finite) = 0
    p = torch.where(mask, torch.exp(scores - m_glob[..., None]), 0.0)
    s_glob = collectives.psum(p.sum(dim=-1), mesh, axis)          # [KV, rep]
    o_glob = collectives.psum(torch.einsum("krt,tkd->krd", p, vf), mesh,
                              axis)                               # [KV,rep,D]
    out = o_glob / torch.clamp(s_glob[..., None], min=1e-30)
    return out.reshape(H * D)


def sp_forward_token(w: ModelWeights, cfg: ModelConfig, token_id, pos,
                     k_cache, v_cache, effort, impl: str, n_sp: int, mesh,
                     axis: str = "sp", rope_offset=0,
                     mask_from=0) -> torch.Tensor:
    """One decode step of a rank with a sequence-sharded KV cache: the
    LOCAL caches [L, max_seq_len / n_sp, KV, D] written in place, weights
    replicated. Returns the logits [vocab], the same on every rank."""
    s_loc = cfg.max_seq_len // n_sp

    def kv_up(kc, vc, l, p, k, v):
        _sp_kv_update(kc, vc, l, p, k, v, s_loc, mesh, axis)

    def attn(q, kc, vc, l, p):
        return _sp_attention(q, kc[l], vc[l], p, cfg, s_loc, mesh, axis,
                             mask_from)

    return forward_token(w, cfg, token_id, pos, k_cache, v_cache,
                         effort=effort, impl=impl, rope_offset=rope_offset,
                         mask_from=mask_from, kv_update_fn=kv_up,
                         attn_fn=attn)
