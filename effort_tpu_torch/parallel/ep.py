"""Expert parallelism for MoE models: experts sharded over an "ep" axis (the
JAX package's parallel/ep.py, one process a rank).

The packed expert axis of w1/w2/w3 is split across ranks (rank p owns
experts [p * E_loc, (p + 1) * E_loc) of every layer); attention weights,
norms and the gate are replicated. Two routings, both keeping per-expert
effort semantics:

  - ep_ffn (decode, one token): the activation is replicated; each of the
    top-k experts runs on its owner and one psum combines them. The JAX
    package skips a non-owned expert with lax.cond; here the expert's
    local instance l * E_loc + e % E_loc stays a 0-d device tensor that K1
    reads on the card, and the owner mask is torch.where(owner == my,
    gate * y, 0), so the step waits on no host read of the routing. A
    non-owner therefore still streams an expert (its own local expert of
    the same index) and drops the result: every rank runs 3 k K1 launches
    a layer for the FFN, where the JAX package's owners run 3 each.
  - ep_ffn_tokens (a batch of tokens): tokens sharded over the same axis;
    capacity-bounded all-to-all dispatch: each rank scatters its tokens
    into per-expert buffers of C slots, an all-to-all routes them to the
    owners, each owner runs its experts one slot at a time (K1 a slot and
    projection, as the JAX package's bucket_matvec a slot; a slot left
    empty gives 0, as its cond gives), a second all-to-all brings the
    results home and the gates combine them. Assignments over capacity
    are dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.models.transformer import (LayerWeights, ModelWeights,
                                                 _expert_ffn, forward_token,
                                                 proj_efforts, resolve_device,
                                                 route, synth_raw_weights)
from effort_tpu_torch.parallel import collectives
from effort_tpu_torch.parallel.multihost import device_type_of
from effort_tpu_torch.parallel.tp import (bucketize_slices, shard_of,
                                          stack_shards)

_EP_SHARDED = ("w1", "w2", "w3")


def make_ep_mesh(n_ep: int, device="cpu"):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type_of(device), (n_ep,),
                            mesh_dim_names=("ep",))


def local_config(cfg: ModelConfig, n_ep: int) -> ModelConfig:
    if cfg.n_experts % n_ep:
        raise ValueError(f"{cfg.n_experts} experts over {n_ep} ranks")
    return dataclasses.replace(cfg, n_experts=cfg.n_experts // n_ep)


def expert_groups(n_layers: int, n_experts: int, n_ep: int, p: int) -> list:
    """The raw instances (l * E + e) part p of n_ep owns, as (start, count)
    runs in its local order l * E_loc + j."""
    e_loc = n_experts // n_ep
    return [(l * n_experts + p * e_loc, e_loc) for l in range(n_layers)]


def make_ep_weights(cfg: ModelConfig, bcfg: BucketConfig, n_ep: int,
                    seed: int = 0, scale: float = 0.02,
                    rank: Optional[int] = None, device=None
                    ) -> Tuple[ModelWeights, ModelConfig]:
    """Random-weight ep model from synth_raw_weights(cfg, seed): attention,
    norms, gate, embeddings and head replicated; w1/w2/w3 hold the rank's
    experts (bucketization is per instance, so a rank's containers are
    slices of the single-device model's, bit for bit). rank=None: every
    rank's expert containers concatenated on axis 0 (ep_local splits
    them). Made on `device` (the card unless named)."""
    if not cfg.is_moe:
        raise ValueError("expert parallelism needs an MoE config")
    dev = resolve_device(device)
    raw = synth_raw_weights(cfg, seed=seed, scale=scale, device=dev)
    ranks = range(n_ep) if rank is None else [rank]
    L, E = cfg.n_layers, cfg.n_experts

    def whole(name):
        return bucketize_slices(raw[name], bcfg, [(0, L)])

    def experts(name):
        return stack_shards([bucketize_slices(
            raw[name], bcfg, expert_groups(L, E, n_ep, p)) for p in ranks])

    layers = LayerWeights(
        attn_norm=raw["attn_norm"].to(torch.float32),
        ffn_norm=raw["ffn_norm"].to(torch.float32),
        wq=whole("wq"), wk=whole("wk"), wv=whole("wv"), wo=whole("wo"),
        w1=experts("w1"), w2=experts("w2"), w3=experts("w3"),
        ffn_gate=raw["ffn_gate"].to(torch.bfloat16))
    w = ModelWeights(tok_embeddings=raw["tok_embeddings"].to(torch.bfloat16),
                     norm=raw["norm"].to(torch.float32),
                     output=raw["output"].to(torch.bfloat16), layers=layers)
    return w, local_config(cfg, n_ep)


def ep_local(w: ModelWeights, n_ep: int, rank: int) -> ModelWeights:
    """Rank `rank`'s part of a global ep layout (the JAX package's
    ep_specs: the expert containers split on axis 0, the rest whole)."""
    lw = w.layers
    return dataclasses.replace(w, layers=dataclasses.replace(lw, **{
        f: shard_of(getattr(lw, f), n_ep, rank) for f in _EP_SHARDED}))


def _global_cfg(cfg_local: ModelConfig, n_ep: int) -> ModelConfig:
    return dataclasses.replace(cfg_local,
                               n_experts=cfg_local.n_experts * n_ep)


def ep_ffn(layer: LayerWeights, l: int, x, effort, cfg_local: ModelConfig,
           n_ep: int, impl: str, mesh, ep_axis: str = "ep",
           psum_axis=None) -> torch.Tensor:
    """Decode-path ep FFN of a rank on the replicated x [dim]: each top-k
    expert through this rank's instance of its local index, kept where the
    rank owns it (torch.where), then summed over psum_axis (default
    ep_axis)."""
    E_loc, k = cfg_local.n_experts, cfg_local.n_experts_per_tok
    my = collectives.axis_index(mesh, ep_axis)
    gates, idx = route(layer, l, x, _global_cfg(cfg_local, n_ep))
    pe = proj_efforts(effort, cfg_local)
    out = None
    for i in range(k):
        inst = idx[i] % E_loc + l * E_loc
        y = gates[i] * _expert_ffn(layer, inst, x, pe, cfg_local, impl)
        y = torch.where(idx[i] // E_loc == my, y, 0.0)
        out = y if out is None else out + y
    return collectives.psum(out, mesh, psum_axis or ep_axis)


def ep_forward_token(w_local: ModelWeights, cfg_local: ModelConfig,
                     token_id, pos, k_cache, v_cache, effort, impl: str,
                     n_ep: int, mesh, ep_axis: str = "ep") -> torch.Tensor:
    """One decode step of a rank: attention replicated, FFN
    expert-sharded. Returns the logits [vocab], the same on every rank."""
    def ffn(layer, l, x):
        return ep_ffn(layer, l, x, effort, cfg_local, n_ep, impl, mesh,
                      ep_axis)
    return forward_token(w_local, cfg_local, token_id, pos, k_cache,
                         v_cache, effort=effort, impl=impl, ffn_fn=ffn)


def expert_capacity(n_tokens_local: int, n_ep: int, k: int, n_experts: int,
                    capacity_factor: float = 1.25) -> int:
    """Slots a (source rank, expert) buffer holds in the all-to-all."""
    total = n_tokens_local * k
    return max(1, int(math.ceil(total / n_experts * capacity_factor)))


def ep_ffn_tokens(layer: LayerWeights, l: int, X, effort,
                  cfg_local: ModelConfig, n_ep: int, impl: str, mesh,
                  ep_axis: str = "ep", capacity_factor: float = 1.25,
                  return_stats: bool = False):
    """Batched ep FFN with all-to-all routing: X [T_local, dim], this
    rank's tokens. Tokens over an expert's capacity are dropped (their gate
    contribution is 0). return_stats also returns this rank's dropped
    assignments as a [1] int32 (of T_local * n_experts_per_tok)."""
    Tl, dim = X.shape
    E_loc, k = cfg_local.n_experts, cfg_local.n_experts_per_tok
    E = E_loc * n_ep
    C = expert_capacity(Tl, n_ep, k, E, capacity_factor)
    dev = X.device
    gates, top_idx = route(layer, l, X, _global_cfg(cfg_local, n_ep))

    ids = top_idx.reshape(-1).long()                                # [Tl*k]
    onehot = (ids[:, None] == torch.arange(E, device=dev)).to(torch.int32)
    pos_in_e = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=1)
    valid = pos_in_e < C
    tok_of = torch.arange(Tl * k, device=dev) // k
    pos_c = torch.where(valid, pos_in_e, 0)

    # each valid (expert, slot) pair is unique; overflow rows add 0
    send = torch.zeros((E, C, dim), dtype=X.dtype, device=dev)
    send.index_put_((ids, pos_c), X[tok_of] * valid[:, None].to(X.dtype),
                    accumulate=True)
    recv = collectives.all_to_all(send.reshape(n_ep, E_loc, C, dim), mesh,
                                  ep_axis)
    xs = recv.transpose(0, 1).reshape(E_loc, n_ep * C, dim)

    pe = proj_efforts(effort, cfg_local)
    ys = torch.zeros((E_loc, n_ep * C, dim), dtype=torch.float32,
                     device=dev)
    for e in range(E_loc):
        for s in range(n_ep * C):
            y = _expert_ffn(layer, l * E_loc + e, xs[e, s], pe, cfg_local,
                            impl)
            ys[e, s] = torch.where(xs[e, s].any(), y, 0.0)

    back = ys.reshape(E_loc, n_ep, C, dim).transpose(0, 1)
    y_home = collectives.all_to_all(back.contiguous(), mesh,
                                    ep_axis).reshape(E, C, dim)
    contrib = y_home[ids, pos_c] * (gates.reshape(-1)
                                    * valid.to(torch.float32))[:, None]
    y = contrib.reshape(Tl, k, dim).sum(dim=1)
    if return_stats:
        return y, (~valid).sum().to(torch.int32).reshape(1)
    return y
