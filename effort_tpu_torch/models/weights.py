"""Load a bucketized checkpoint into packed ModelWeights; weight-set
utilities (size estimate, truncated loading, dense copies).

load_bucketized reads the per-layer tensors the converter wrote
(convert/convert.py, or the JAX package's converter: the format is the
same) and stacks them into the packed per-projection BucketedMatrix
containers the forward passes use, on a torch device (the card unless
named). Truncated loading (percent_load < 1) drops the least important
rank slices (bucket_size >= 2) or the trailing calibration-sorted row
chunks (bucket_size 1) at load time.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.models.transformer import (PROJ_FIELDS, LayerWeights,
                                                 ModelWeights,
                                                 resolve_device)
from effort_tpu_torch.ops.layouts import BucketedMatrix, probe_sample_indices
from effort_tpu_torch.runtime.safetensors_io import MultiShardReader


def load_config(ckpt_dir: str):
    """(ModelConfig, BucketConfig) of a converted checkpoint."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        d = json.load(f)
    return (ModelConfig(**d["model"]), BucketConfig(**d["buckets"]))


def _host(reader: MultiShardReader, name: str) -> torch.Tensor:
    """A stored tensor as a CPU tensor of its own memory: the copy keeps
    it valid after the reader's mapping closes. BF16 (stored as uint16
    bits) comes back as torch.bfloat16 (torch.from_numpy rejects numpy's
    ml_dtypes.bfloat16, so the bits are viewed)."""
    a = np.array(reader[name], copy=True)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bf16(reader: MultiShardReader, name: str, device) -> torch.Tensor:
    t = _host(reader, name)
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected BF16, found {t.dtype}")
    return t.to(device)


def _arr(reader: MultiShardReader, name: str, device) -> torch.Tensor:
    return _host(reader, name).to(device)


def _stack(parts, device, zero_block: bool = False) -> torch.Tensor:
    """Stack (zero_block=False) or concatenate along axis 0 (True, plus one
    all-zero block at the end) CPU tensors into one tensor allocated once
    on `device`, filled a part at a time."""
    if not zero_block:
        parts = [p[None] for p in parts]
    n = sum(p.shape[0] for p in parts) + int(zero_block)
    out = torch.empty((n,) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype, device=device)
    at = 0
    for p in parts:
        out[at:at + p.shape[0]].copy_(p)
        at += p.shape[0]
    if zero_block:
        out[-1:].zero_()
    return out


def _stack_bucketed(reader: MultiShardReader, prefixes: List[str],
                    cfg: ModelConfig, bcfg: BucketConfig,
                    percent_load: Optional[float] = None,
                    rows_sorted: bool = False,
                    load_core: bool = False,
                    out_dim: Optional[int] = None,
                    device=None) -> BucketedMatrix:
    """Stack per-instance tensors (one per prefix) into one packed
    BucketedMatrix whose n_experts = len(prefixes), on `device`.

    load_core=True reads the converter's optional `.core` dense copies
    (stored in the baked row order) into the `dense` field (the effort >= 1
    dense path and dense prefill); only at full percent_load, since a
    truncated layout no longer matches the dense copy.
    out_dim: the projection's true output width (int4 stores two values a
    byte, padded to 128 bytes, so shapes alone cannot give it)."""
    load_core = (load_core
                 and (percent_load is None or percent_load >= 1.0)
                 and all(p + ".core" in reader for p in prefixes))
    first = prefixes[0]
    # the chunk size is a per-matrix layout choice (pick_chunk_rows):
    # recover it from the stored block shape
    NB_inst, G, OB = reader[first + ".vals"].shape   # vals (pos is packed)
    in_dim, K_stored = reader[first + ".stats"].shape
    B = bcfg.bucket_size
    if out_dim is None:
        out_dim = OB * B * (2 if bcfg.dtype == "int4" else 1)
    nc = in_dim // G
    if NB_inst != nc * K_stored:
        raise ValueError(f"{first}: {NB_inst} blocks for {nc} chunks x "
                         f"{K_stored} ranks")

    # truncated loading: blocks are rank-major (id = k * nc + g)
    K, nc_keep = K_stored, nc
    stride = in_dim // reader[first + ".probes"].shape[0]
    if percent_load is not None and percent_load < 1.0:
        if B == 1 and rows_sorted:
            # drop the trailing (least important, calibration-sorted) row
            # chunks; unsorted rows stay whole (see truncate_bucketed)
            nc_keep = max(1, int(round(percent_load * nc)))
        elif B > 1:
            K = max(1, int(round(percent_load * K_stored)))
    rows = nc_keep * G

    def blocks(t):
        t = t.reshape((K_stored, nc) + tuple(t.shape[1:]))[:K, :nc_keep]
        return t.reshape((-1,) + tuple(t.shape[2:]))

    def each(suffix):
        return [_host(reader, p + suffix) for p in prefixes]

    def optional(suffix, trim=lambda t: t):
        if first + suffix not in reader:
            return None
        return _stack([trim(t) for t in each(suffix)], device)

    # stats / scales [in, K] per instance; probes an ascending strided dim
    # sample: keep the prefix that falls inside the kept rows
    trim_rk = lambda t: t[:rows, :K]                          # noqa: E731
    return BucketedMatrix(
        vals=_stack([blocks(t) for t in each(".vals")], device, True),
        pos=_stack([blocks(t) for t in each(".pos")], device, True),
        stats=optional(".stats", trim_rk),
        probes=optional(".probes", lambda t: t[:rows // stride]),
        probe_dims=torch.from_numpy(probe_sample_indices(
            rows, out_dim, bcfg.probes)[:, 0].copy()).to(device),
        scales=optional(".scales", trim_rk),
        outlier_vals=optional(".outlier_vals"),
        outlier_idx=optional(".outlier_idx"),
        dense=optional(".core") if load_core else None,
        seg_order=optional(".seg_order"),
        in_dim=rows, out_dim=out_dim, bucket_size=B, chunk_rows=G,
        n_ranks=K, n_experts=len(prefixes), dtype_name=bcfg.dtype,
        perm_segment=max(1, G // 4),
        rows_sorted=rows_sorted,
    )


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


def device_budget_bytes(device) -> int:
    """Bytes a new allocation on a CUDA device can take now: the card's
    free memory plus what torch's allocator holds cached but unused."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no memory budget on {device}: pass "
                         f"hbm_budget_bytes")
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device)
               - torch.cuda.memory_allocated(device))


def auto_percent_load(cfg: ModelConfig, bcfg: BucketConfig,
                      hbm_budget_bytes: Optional[int] = None,
                      reserve_frac: float = 0.25, device=None) -> float:
    """The largest percent_load (in 16ths) whose weights fit the budget,
    leaving reserve_frac of it for the KV cache, activations and scratch.
    The budget is hbm_budget_bytes, or on a CUDA device what
    torch.cuda.mem_get_info says is free on it (device_budget_bytes). On
    the CPU pass hbm_budget_bytes: there is no card to ask, and no guess
    is made (ValueError)."""
    if hbm_budget_bytes is None:
        hbm_budget_bytes = device_budget_bytes(resolve_device(device))
    budget = int(hbm_budget_bytes * (1.0 - reserve_frac))
    for i in range(16, 0, -1):
        pl = i / 16.0
        if model_weight_bytes(cfg, bcfg, pl) <= budget:
            return pl
    return 1.0 / 16.0


def load_bucketized(ckpt_dir: str, percent_load: Optional[float] = None,
                    model: Optional[str] = None,
                    auto_adjust: bool = False,
                    load_dense="auto", device=None,
                    hbm_budget_bytes: Optional[int] = None) -> tuple:
    """Returns (ModelWeights, ModelConfig, BucketConfig), the weights on
    `device` (the card unless named).

    auto_adjust=True (and no explicit percent_load): degrade percent_load
    so the weights fit the budget (auto_percent_load).
    load_dense: read the converter's `.core` dense copies (when stored)
    into each projection's `dense` field, for the effort >= 1 dense path
    and dense prefill. "auto" loads them when they exist and buckets plus
    dense copies fit 80% of the budget; True forces (when stored); False
    skips. Ignored under truncated loading.
    The budget of auto_adjust and load_dense="auto": hbm_budget_bytes, or
    on a CUDA device its free memory (torch.cuda.mem_get_info). On the CPU
    either needs hbm_budget_bytes (ValueError otherwise): there is no
    card to ask, and no guess is made."""
    device = resolve_device(device)
    cfg, bcfg = load_config(ckpt_dir)
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        meta = json.load(f)
    fused = bool(meta.get("fused", False))
    calibrated = bool(meta.get("calibrated", False))
    prof = meta.get("activation_profile")
    if prof:
        # measured at convert time: a flat profile streams about every
        # chunk under the tau coverage bound, so effort then buys quality
        # scaling rather than decode speed
        conc = max(prof.get("top25pct_mass_m", 0.0),
                   prof.get("top25pct_mass_f", 0.0))
        if conc < 0.40:
            logging.getLogger("effort_tpu_torch").info(
                "checkpoint activation profile is flat (top-25%% mass "
                "%.2f): effort buys quality-scaling, little decode "
                "speed at tau~1; for speed use int8 buckets and/or "
                "percent_load", conc)

    def budget():
        if hbm_budget_bytes is not None:
            return hbm_budget_bytes
        return device_budget_bytes(device)

    if auto_adjust and percent_load is None:
        percent_load = auto_percent_load(cfg, bcfg, budget())
    r = MultiShardReader(ckpt_dir, model)
    L, E = cfg.n_layers, cfg.n_experts

    want_core = bool(load_dense)
    if load_dense == "auto" and (percent_load is None
                                 or percent_load >= 1.0):
        probe = ("layers.0.attention.wqkv.core" if fused
                 else "layers.0.attention.wq.core")
        if probe in r:
            dense_bytes = model_weight_bytes(
                cfg, dataclasses.replace(bcfg, dtype="bf16"))
            total = model_weight_bytes(cfg, bcfg) + dense_bytes
            want_core = total <= int(budget() * 0.8)
        else:
            want_core = False

    q_out = cfg.n_heads * cfg.head_dim
    kv_out = cfg.n_kv_heads * cfg.head_dim
    out_dims = {"wq": q_out, "wk": kv_out, "wv": kv_out, "wo": cfg.dim,
                "wqkv": q_out + 2 * kv_out, "w1": cfg.hidden_dim,
                "w3": cfg.hidden_dim, "w2": cfg.dim,
                "w13": 2 * cfg.hidden_dim}

    def attn(p):
        # wo's input space (the attention output) is never
        # calibration-sorted
        return _stack_bucketed(
            r, [f"layers.{l}.attention.{p}" for l in range(L)],
            cfg, bcfg, percent_load,
            rows_sorted=calibrated and p != "wo", load_core=want_core,
            out_dim=out_dims[p], device=device)

    def ffn(p):
        return _stack_bucketed(
            r, [f"layers.{l}.feed_forward.experts.{e}.{p}"
                for l in range(L) for e in range(E)],
            cfg, bcfg, percent_load, rows_sorted=calibrated,
            load_core=want_core, out_dim=out_dims[p], device=device)

    def per_layer(name, f32=True):
        parts = [_host(r, f"layers.{l}.{name}") for l in range(L)]
        if f32:
            parts = [p.float() for p in parts]
        return _stack(parts, device)

    try:
        if fused:
            proj = dict(wq=None, wk=None, wv=None, w1=None, w3=None,
                        wqkv=attn("wqkv"), w13=ffn("w13"))
        else:
            proj = dict(wq=attn("wq"), wk=attn("wk"), wv=attn("wv"),
                        w1=ffn("w1"), w3=ffn("w3"))
        layers = LayerWeights(
            attn_norm=per_layer("attention_norm"),
            ffn_norm=per_layer("ffn_norm"),
            wo=attn("wo"), w2=ffn("w2"),
            ffn_gate=(per_layer("ffn_gate", f32=False) if cfg.is_moe
                      else None),
            **proj,
        )
        w = ModelWeights(
            tok_embeddings=_bf16(r, "tok_embeddings", device),
            norm=_host(r, "norm").float().to(device),
            output=_bf16(r, "output", device),
            layers=layers,
        )
    finally:
        r.close()
    return w, cfg, bcfg
