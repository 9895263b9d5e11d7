"""Tensor parallelism for the bucketized model (the JAX package's
parallel/tp.py, one process a rank).

Design (Megatron-style, adapted to bucketMul), as the JAX package's:
  - wq/wk/wv and w1/w3 are OUTPUT-sharded (attention heads / hidden
    units); wo and w2 are INPUT-sharded, so attention and the FFN's
    elementwise ops run locally and each block needs one sum over the
    axis after wo and one after w2 (forward_token's tp hook);
  - each shard's slice is bucketized on its own (its own stats and
    probes), so the effort cutoff is a quantile of the local probe sample
    and the dispatch needs no communication;
  - the LM head is vocabulary-sharded and stays bf16; the logits are
    all-gathered over the axis;
  - the KV cache is head-sharded (n_kv_heads % tp == 0).

Weights: make_tp_weights(rank=r) builds rank r's shard only, drawing the
model's raw weights (synth_raw_weights, one instance at a time, so no rank
holds the full model); rank=None gives the JAX package's global layout,
every shard's container concatenated on axis 0, which tp_local splits as
PartitionSpec("tp") would. A rank's KV cache is make_kv_cache of the
local config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.models.transformer import (LayerWeights, ModelWeights,
                                                 RawWeight, forward_token,
                                                 resolve_device,
                                                 synth_raw_weights)
from effort_tpu_torch.ops.bucketize import bucketize
from effort_tpu_torch.ops.layouts import (TENSOR_FIELDS, BucketedMatrix,
                                          concat_bucketed)
from effort_tpu_torch.parallel import collectives
from effort_tpu_torch.parallel.multihost import device_type_of

# the container fields with one entry an instance (probe_dims, one vector
# for every instance, stays whole)
_PER_INSTANCE = tuple(f for f in TENSOR_FIELDS if f != "probe_dims")
_CHUNK_BYTES = 2**30


def make_mesh(n_dp: int = 1, n_tp: int = 1, device="cpu"):
    """A ("dp", "tp") DeviceMesh over the process group's first
    n_dp * n_tp ranks, row-major (the JAX package's devices.reshape)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type_of(device), (n_dp, n_tp),
                            mesh_dim_names=("dp", "tp"))


def local_config(cfg: ModelConfig, n_tp: int) -> ModelConfig:
    if cfg.n_heads % n_tp or cfg.n_kv_heads % n_tp or cfg.hidden_dim % n_tp:
        raise ValueError(f"heads {cfg.n_heads}/{cfg.n_kv_heads}, hidden "
                         f"{cfg.hidden_dim} do not split {n_tp} ways")
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // n_tp, n_kv_heads=cfg.n_kv_heads // n_tp,
        hidden_dim=cfg.hidden_dim // n_tp, vocab_size=cfg.vocab_size // n_tp)


def span(n: int, parts: int, p: int) -> slice:
    """Part p of n indices split into `parts` equal parts."""
    if n % parts:
        raise ValueError(f"{n} does not split {parts} ways")
    k = n // parts
    return slice(p * k, (p + 1) * k)


def bucketize_slices(rw: RawWeight, bcfg: BucketConfig,
                     groups: Sequence[Tuple[int, int]],
                     rows: slice = slice(None),
                     cols: slice = slice(None)) -> BucketedMatrix:
    """bucketize of instances `groups` ((start, count) runs, concatenated
    in order) of a raw weight, rows / cols of each kept; drawn and
    bucketized about a GiB of f32 at a time."""
    def parts():
        for start, count in groups:
            full = rw.in_dim * rw.out_dim * 4
            step = max(1, _CHUNK_BYTES // full)
            for s in range(start, start + count, step):
                n = min(step, start + count - s)
                wt = rw.make(s, n)[:, rows, cols].contiguous()
                yield bucketize(wt, bcfg)
                del wt
    return concat_bucketed(parts(), sum(c for _, c in groups))


def stack_shards(bms: Sequence[BucketedMatrix]) -> BucketedMatrix:
    """Shards' containers concatenated on axis 0, each with its own
    trailing zero block: the JAX package's global layout (metadata and
    probe_dims from the first shard)."""
    if len(bms) == 1:
        return bms[0]
    return dataclasses.replace(bms[0], **{
        f: (None if getattr(bms[0], f) is None
            else torch.cat([getattr(b, f) for b in bms]))
        for f in _PER_INSTANCE})


def part(t: Optional[torch.Tensor], n: int, i: int):
    """Part i of t split n ways on axis 0, as PartitionSpec splits it."""
    if t is None:
        return None
    if t.shape[0] % n:
        raise ValueError(f"axis 0 of {tuple(t.shape)} does not split {n} "
                         f"ways")
    k = t.shape[0] // n
    return t[i * k:(i + 1) * k]


def shard_of(bm: BucketedMatrix, n: int, i: int) -> BucketedMatrix:
    """Shard i of a global container of n shards (stack_shards' inverse)."""
    return dataclasses.replace(bm, **{f: part(getattr(bm, f), n, i)
                                      for f in _PER_INSTANCE})


def _proj_fields(lw: LayerWeights):
    return [f.name for f in dataclasses.fields(lw)
            if isinstance(getattr(lw, f.name), BucketedMatrix)]


def tp_local(w: ModelWeights, n_tp: int, rank: int) -> ModelWeights:
    """Rank `rank`'s shard of a global tp layout (make_tp_weights with
    rank=None, or the JAX package's carried across): every container and
    the LM head split on axis 0, norms, embeddings and the gate whole."""
    lw = w.layers
    layers = dataclasses.replace(lw, **{
        f: shard_of(getattr(lw, f), n_tp, rank) for f in _proj_fields(lw)})
    return dataclasses.replace(w, layers=layers,
                               output=part(w.output, n_tp, rank))


def make_tp_weights(cfg: ModelConfig, bcfg: BucketConfig, n_tp: int,
                    seed: int = 0, scale: float = 0.02,
                    rank: Optional[int] = None, device=None
                    ) -> Tuple[ModelWeights, ModelConfig]:
    """Random-weight tp model from synth_raw_weights(cfg, seed): each
    shard's slice of every projection bucketized on its own. rank=r gives
    rank r's local container only; rank=None the global layout (every
    shard's container concatenated on axis 0; tp_local splits it). With
    n_tp = 1 it is the single-device model of the same draws and bucketize
    calls. Made on `device` (the card unless named). Returns (weights,
    local config)."""
    dev = resolve_device(device)
    raw = synth_raw_weights(cfg, seed=seed, scale=scale, device=dev)
    ranks = range(n_tp) if rank is None else [rank]

    def col(name):       # output-shard
        rw = raw[name]
        return stack_shards([bucketize_slices(
            rw, bcfg, [(0, rw.n_inst)], cols=span(rw.out_dim, n_tp, p))
            for p in ranks])

    def row(name):       # input-shard
        rw = raw[name]
        return stack_shards([bucketize_slices(
            rw, bcfg, [(0, rw.n_inst)], rows=span(rw.in_dim, n_tp, p))
            for p in ranks])

    # wo rows are head-major, so equal row parts are head groups, matching
    # the local attention output; w2's rows are the local hidden units
    layers = LayerWeights(
        attn_norm=raw["attn_norm"].to(torch.float32),
        ffn_norm=raw["ffn_norm"].to(torch.float32),
        wq=col("wq"), wk=col("wk"), wv=col("wv"), wo=row("wo"),
        w1=col("w1"), w2=row("w2"), w3=col("w3"),
        ffn_gate=(raw["ffn_gate"].to(torch.bfloat16)
                  if raw["ffn_gate"] is not None else None))
    head = raw["output"].to(torch.bfloat16)
    out = torch.cat([head[:, span(cfg.vocab_size, n_tp, p)] for p in ranks])
    w = ModelWeights(tok_embeddings=raw["tok_embeddings"].to(torch.bfloat16),
                     norm=raw["norm"].to(torch.float32),
                     output=out.contiguous(), layers=layers)
    return w, local_config(cfg, n_tp)


def tp_forward_token(w_local: ModelWeights, cfg_local: ModelConfig,
                     token_id, pos, k_cache, v_cache, effort, impl: str,
                     mesh, tp_axis: str = "tp") -> torch.Tensor:
    """One decode step of a rank: its shard's forward with the sums over
    tp_axis, then the vocabulary shards' logits all-gathered. The caches
    (the rank's head shard, [L, S, KV/n_tp, D]) are written in place.
    Returns the full logits [vocab] f32, the same on every rank."""
    logits_local = forward_token(w_local, cfg_local, token_id, pos, k_cache,
                                 v_cache, effort=effort, impl=impl,
                                 tp=(mesh, tp_axis))
    return collectives.all_gather(logits_local, mesh, tp_axis, tiled=True)
