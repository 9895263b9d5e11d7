"""Offline bucketization: dense weights -> BucketedMatrix.

One stable argsort by |w| per bucket, a gather and a few transposes; the
output arrays equal the JAX package's bucketize on the same input (int4
codes up to rounding ties of the quantile scale). Runs on the device of its
input, so a full-width model is bucketized on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from effort_tpu_torch.config import BucketConfig
from effort_tpu_torch.ops.layouts import (BucketedMatrix, pack_positions,
                                          probe_sample_indices)


def _sort_buckets(wt: torch.Tensor, bucket_size: int):
    """wt [in,out] -> (vals f32, pos int8 | None, stats) with vals/pos
    [in, B, out/B] and stats [in, B]."""
    in_dim, out_dim = wt.shape
    B = bucket_size
    nb = out_dim // B
    w = wt.reshape(in_dim, nb, B).float()
    if B == 1:
        # one element per bucket: the sort is the identity and positions
        # are identically zero (never stored for this layout)
        vals = w.permute(0, 2, 1)
        return vals, None, vals.abs().mean(dim=2)
    order = torch.argsort(-w.abs(), dim=-1, stable=True)   # [in, nb, B]
    vals = torch.gather(w, -1, order).permute(0, 2, 1)     # [in, B, nb]
    pos = order.permute(0, 2, 1).to(torch.int8)
    return vals, pos, vals.abs().mean(dim=2)


def _to_blocks(x: torch.Tensor, n_chunks: int, G: int, K: int):
    """[E, in, K, nb] -> [E*K*nc, G, nb], rank-major block ids
    id = (e*K + k) * n_chunks + g."""
    E, in_dim, k_dim, nb = x.shape
    if k_dim != K:
        raise ValueError((k_dim, K))
    x = x.reshape(E, n_chunks, G, K, nb).permute(0, 3, 1, 2, 4)
    return x.reshape(E * n_chunks * K, G, nb)


def calib_row_order(act_rms) -> torch.Tensor:
    """Descending-|activation| input-row order for the baked permutation."""
    rms = torch.as_tensor(act_rms, dtype=torch.float32)
    return torch.argsort(-rms, stable=True).to(torch.int32)


def pick_chunk_rows(cfg: BucketConfig, in_dim: int, out_dim: int) -> int:
    """Per-matrix chunk size. For the row-prefix layout (bucket_size=1)
    chunk_rows sets the streaming granularity of the coverage bound: the
    largest chunk of at most ~3 MB that leaves >= 4 chunks; where none
    fits and chunk_rows does not divide in_dim, chunk_rows halved until it
    does (DeepSeek-V2's dense w2: 10944 rows, 64-row chunks)."""
    if cfg.bucket_size != 1:
        return cfg.chunk_rows
    item = {"bf16": 2, "int8": 1, "int4": 0.5}[cfg.dtype]
    G = cfg.chunk_rows
    for cand in (1024, 512, 256, 128):
        if (in_dim % cand == 0 and cand * 4 <= in_dim
                and cand * out_dim * item <= 3 * 2**20):
            return max(G, cand)
    while in_dim % G and G % 2 == 0:
        G //= 2
    return G


def _quantile_linear(x: torch.Tensor, q: float, dim: int = -1):
    """Linear-interpolation quantile along `dim` with the scalar arithmetic
    of jnp.quantile in f32 (torch.quantile caps its input at 2**24
    elements, below one fused Mistral-7B projection)."""
    n = x.shape[dim]
    qq = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(qq), np.ceil(qq)
    hw = np.float32(qq - low)
    lw = np.float32(1.0) - hw
    low_i = int(min(max(low, 0), n - 1))
    high_i = int(min(max(high, 0), n - 1))
    s = torch.sort(x, dim=dim).values
    return (s.select(dim, low_i) * float(lw)
            + s.select(dim, high_i) * float(hw))


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, on every device. On CUDA, torch computes x / d
    for a python number d as x * (1 / d), which can land one bit off, and
    a scale one bit off moves a code at a rounding tie: dividing by a 0-d
    tensor on x's device takes the true division, so a conversion on the
    card writes the CPU's (and the JAX package's) bytes."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _pad_for_packing(blocks: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad the last axis to a multiple of `multiple` elements (the packed
    byte width stays a multiple of 128, as the JAX layout requires)."""
    pad = (-blocks.shape[-1]) % multiple
    if pad:
        blocks = torch.cat([blocks, blocks.new_zeros(
            blocks.shape[:-1] + (pad,))], dim=-1)
    return blocks


def _select_instances(x: torch.Tensor, idx, axis: int) -> torch.Tensor:
    """Index `axis` of every instance of x [E, ...] by idx ([n] or [E, n])."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    if idx.ndim == 1:
        return x.index_select(axis, idx)
    return torch.stack([x[e].index_select(axis - 1, idx[e])
                        for e in range(x.shape[0])])


def bucketize(wt, cfg: BucketConfig, keep_dense: bool = False,
              act_rms=None, perm_segment: int = 0,
              in_perm=None, out_perm=None) -> BucketedMatrix:
    """Convert dense transposed weights to the bucketized format.

    wt: [in_dim, out_dim] or [E, in_dim, out_dim] (instances packed).
    act_rms: optional [in_dim] typical activation magnitude per input dim.
      Input dims are then permuted in segments so similar-|v| dims share a
      chunk; the permutation is applied to v at run time (seg_order).
    in_perm: optional [in_dim] (or [E, in_dim]) baked input-row permutation:
      rows are reordered physically and no run-time permute happens. The
      whole-model relayout (models.transformer.assemble_weights) uses it.
      Excludes act_rms.
    out_perm: optional [out_dim] (or [E, out_dim]) output-column
      permutation applied before bucketing.
    """
    wt = torch.as_tensor(wt)
    if wt.ndim == 2:
        wt = wt[None]
    E, in_dim, out_dim = wt.shape
    dev = wt.device

    if out_perm is not None:
        wt = _select_instances(wt, out_perm, 2)
    if in_perm is not None:
        if act_rms is not None:
            raise ValueError("in_perm (baked) excludes act_rms (runtime)")
        wt = _select_instances(wt, in_perm, 1)

    seg_order = None
    if act_rms is not None:
        seg = perm_segment or max(1, cfg.chunk_rows // 4)
        if in_dim % seg:
            raise ValueError((in_dim, seg))
        keys = torch.as_tensor(act_rms, dtype=torch.float32,
                               device=dev).reshape(-1, seg).mean(dim=1)
        sorder = torch.argsort(-keys, stable=True).to(torch.int32)
        row_order = (sorder.long()[:, None] * seg
                     + torch.arange(seg, device=dev)).reshape(-1)
        wt = wt[:, row_order, :]
        seg_order = sorder[None].repeat(E, 1)
    else:
        seg = perm_segment or 1
    B, G = cfg.bucket_size, cfg.chunk_rows
    if out_dim % B or in_dim % G:
        raise ValueError(f"shape {(in_dim, out_dim)} vs B={B}, G={G}")
    K = cfg.ranks_loaded
    n_chunks = in_dim // G

    outlier_vals = outlier_idx = None
    wt_full = wt
    if cfg.dtype == "int4" and cfg.outlier_frac > 0:
        # the dense copy and the probes keep the outliers (wt_full)
        wt, outlier_vals, outlier_idx = _extract_outliers(wt,
                                                          cfg.outlier_frac)

    vals_l, pos_l, stats_l = [], [], []
    for e in range(E):
        va, po, st = _sort_buckets(wt[e], B)
        vals_l.append(va[:, :K])     # truncated loading: leading ranks
        pos_l.append(None if po is None else po[:, :K])
        stats_l.append(st[:, :K])
    vals = torch.stack(vals_l)      # [E, in, K, nb] f32
    stats = torch.stack(stats_l)    # [E, in, K] f32

    scales = None
    if cfg.dtype == "bf16":
        qvals = vals.to(torch.bfloat16)
    elif cfg.dtype == "int8":
        # per-bucket-row symmetric absmax scale
        scales = _true_div(torch.clamp(vals.abs().amax(dim=3), min=1e-30),
                           127.0)
        qvals = torch.clamp(torch.round(vals / scales[..., None]),
                            -127, 127).to(torch.int8)
    else:
        # int4: per-bucket-row scale from the clip_quantile of |w|; the top
        # tail saturates to +-7 s
        scales = _true_div(_quantile_linear(vals.abs(), cfg.clip_quantile),
                           7.0)
        scales = torch.clamp(scales, min=1e-30)
        qvals = torch.clamp(torch.round(vals / scales[..., None]),
                            -7, 7).to(torch.int8)
    del vals

    vblocks = _to_blocks(qvals, n_chunks, G, K)
    if cfg.dtype == "int4":
        # two per byte: nibble q+8, byte j holds columns j and j + OBp
        vblocks = pack_positions(
            _pad_for_packing(vblocks, 256).to(torch.int16) + 8, 16)
    if B == 1:
        # row-prefix layout: no positions; a placeholder keeps the fields
        pblocks = torch.zeros((E * n_chunks * K, 1, 128), dtype=torch.uint8,
                              device=dev)
    else:
        pos_per128 = 128 * (8 // {2: 1, 4: 2, 8: 3, 16: 4, 32: 5}[B])
        pblocks = pack_positions(_pad_for_packing(
            _to_blocks(torch.stack(pos_l), n_chunks, G, K), pos_per128), B)
    # one trailing all-zero block (the padding target of block-gather
    # dispatch lists)
    vblocks = torch.cat([vblocks, torch.zeros_like(vblocks[:1])])
    pblocks = torch.cat([pblocks, torch.zeros_like(pblocks[:1])])

    pidx = torch.as_tensor(probe_sample_indices(in_dim, out_dim, cfg.probes),
                           dtype=torch.int64, device=dev)
    probes = wt_full[:, pidx[:, 0], pidx[:, 1]].float()   # [E, P]

    return BucketedMatrix(
        vals=vblocks,
        pos=pblocks,
        stats=stats,
        probes=probes,
        probe_dims=pidx[:, 0].to(torch.int32),
        scales=scales,
        outlier_vals=outlier_vals,
        outlier_idx=outlier_idx,
        dense=wt_full.to(torch.bfloat16) if keep_dense else None,
        seg_order=seg_order,
        in_dim=in_dim,
        out_dim=out_dim,
        bucket_size=B,
        chunk_rows=G,
        n_ranks=K,
        n_experts=E,
        dtype_name=cfg.dtype,
        perm_segment=seg,
        rows_sorted=(in_perm is not None or act_rms is not None),
    )


def _extract_outliers(wt: torch.Tensor, outlier_frac: float):
    """Pull the top-|w| fraction out for exact f32 handling; zero it in wt.
    The table is sorted by output column."""
    E, in_dim, out_dim = wt.shape
    n_out = max(1, int(in_dim * out_dim * outlier_frac))
    wt_clean, ov_l, oi_l = [], [], []
    for e in range(E):
        flat = wt[e].reshape(-1).float()
        top = torch.sort(torch.topk(flat.abs(), n_out).indices).values
        rows, cols = top // out_dim, top % out_dim
        order = torch.argsort(cols, stable=True)
        ov_l.append(flat[top][order])
        oi_l.append(torch.stack([rows[order], cols[order]],
                                dim=1).to(torch.int32))
        clean = flat.clone()
        clean[top] = 0.0
        wt_clean.append(clean.reshape(in_dim, out_dim))
    return torch.stack(wt_clean), torch.stack(ov_l), torch.stack(oi_l)


def bucketize_numpy(wt: np.ndarray, cfg: BucketConfig, device=None,
                    **kw) -> BucketedMatrix:
    """bucketize of a numpy array, run on `device` (the card unless named;
    the CPU only when the caller asks for it). kw: bucketize's keywords."""
    from effort_tpu_torch.models.transformer import resolve_device
    t = torch.from_numpy(np.array(wt, dtype=np.float32, copy=True))
    return bucketize(t.to(resolve_device(device)), cfg, **kw)
