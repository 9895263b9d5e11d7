"""Weight-set utilities: size estimate, truncated loading, dense copies.

The checkpoint loader (the JAX package's models/weights.load_bucketized)
is not ported yet: no bucketized checkpoint is in the repository.
"""

from __future__ import annotations

import dataclasses

import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.models.transformer import PROJ_FIELDS, ModelWeights
from effort_tpu_torch.ops.layouts import BucketedMatrix


def model_weight_bytes(cfg: ModelConfig, bcfg: BucketConfig,
                       percent_load: float = 1.0) -> int:
    """Estimated device bytes for a loaded model (weights only)."""
    # per-element upper bounds: vals + packed positions (+ int4's f32
    # outlier table); per-row stats/scales/probes are negligible
    item = {"bf16": 2.25, "int8": 1.25, "int4": 1.0}[bcfg.dtype]
    L, E, dim, hid = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim
    q_out = cfg.n_heads * cfg.head_dim
    kv_out = cfg.n_kv_heads * cfg.head_dim
    params = L * (dim * (q_out + 2 * kv_out) + q_out * dim
                  + E * 3 * dim * hid)
    return int(params * item * percent_load
               + 2 * 2 * cfg.vocab_size * dim)        # embeddings + head


def truncate_bucketed(bm: BucketedMatrix,
                      percent_load: float) -> BucketedMatrix:
    """In-memory truncated loading.

    bucket_size == 1 (row-prefix): drop the trailing (least important,
    calibration-sorted) row chunks; an unsorted matrix is kept whole.
    bucket_size > 1: keep the leading ranks. The dense copy is dropped (it
    no longer matches)."""
    if percent_load >= 1.0:
        return bm
    if bm.bucket_size == 1 and not bm.rows_sorted:
        return bm
    E, K, G = bm.n_experts, bm.n_ranks, bm.chunk_rows
    nc = bm.n_chunks
    zero_v, zero_p = bm.vals[-1:], bm.pos[-1:]
    vals = bm.vals[:-1].reshape((E, K, nc) + tuple(bm.vals.shape[1:]))
    pos = bm.pos[:-1].reshape((E, K, nc) + tuple(bm.pos.shape[1:]))
    stats, scales = bm.stats, bm.scales
    probes, probe_dims = bm.probes, bm.probe_dims
    in_dim, K_new = bm.in_dim, K
    ov, oi = bm.outlier_vals, bm.outlier_idx
    if bm.bucket_size == 1:
        nc_keep = max(1, int(round(percent_load * nc)))
        vals, pos = vals[:, :, :nc_keep], pos[:, :, :nc_keep]
        in_dim = nc_keep * G
        stats = stats[:, :in_dim]
        scales = scales[:, :in_dim] if scales is not None else None
        stride = bm.in_dim // probes.shape[1]
        probes = probes[:, :in_dim // stride]
        probe_dims = probe_dims[:in_dim // stride]
        if ov is not None:   # outliers on dropped rows contribute nothing
            ov = torch.where(oi[:, :, 0] < in_dim, ov, torch.zeros_like(ov))
    else:
        K_new = max(1, int(round(percent_load * K)))
        vals, pos = vals[:, :K_new], pos[:, :K_new]
        stats = stats[..., :K_new]
        scales = scales[..., :K_new] if scales is not None else None
    vals = torch.cat([vals.reshape((-1,) + tuple(bm.vals.shape[1:])),
                      zero_v])
    pos = torch.cat([pos.reshape((-1,) + tuple(bm.pos.shape[1:])), zero_p])
    return dataclasses.replace(
        bm, vals=vals, pos=pos, stats=stats.contiguous(),
        scales=None if scales is None else scales.contiguous(),
        probes=probes.contiguous(), probe_dims=probe_dims,
        outlier_vals=ov, dense=None, in_dim=in_dim, n_ranks=K_new)


def truncate_model(w: ModelWeights, percent_load: float) -> ModelWeights:
    """truncate_bucketed over every projection container."""
    layers = w.layers
    repl = {f: truncate_bucketed(getattr(layers, f), percent_load)
            for f in PROJ_FIELDS if getattr(layers, f) is not None}
    return dataclasses.replace(
        w, layers=dataclasses.replace(layers, **repl))


def attach_dense_bucketed(bm: BucketedMatrix) -> BucketedMatrix:
    """Rebuild a bf16 dense copy from the buckets (rows in the layout's
    order) and attach it; exact up to quantization."""
    if bm.dense is not None:
        return bm
    dense = torch.stack([
        bm.reconstruct_dense(e, permuted_space=True).to(torch.bfloat16)
        for e in range(bm.n_experts)])
    return dataclasses.replace(bm, dense=dense)


def attach_dense(w: ModelWeights) -> ModelWeights:
    """attach_dense_bucketed over every projection container: gives a
    model the effort >= 1 dense path. Costs a full bf16 weight set."""
    layers = w.layers
    repl = {f: attach_dense_bucketed(getattr(layers, f))
            for f in PROJ_FIELDS if getattr(layers, f) is not None}
    return dataclasses.replace(
        w, layers=dataclasses.replace(layers, **repl))
