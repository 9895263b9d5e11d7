"""Runtime effort selection: cutoff quantile and per-row rank counts.

  - cutoff: a quantile of the sampled |v * probe| scores, found by a
    two-level threshold search (32 geometric thresholds, then 32 linear
    ones inside the bracket): deterministic and within ~1% in value. A
    sort-based exact version exists for tests and oracle work.
  - selection: stats[i,k]*|v_i| > cutoff is monotone in k (stats, the mean
    |w| of rank-k elements, is non-increasing in k), so the selected set per
    input row is a rank prefix n_i.
  - compaction (select_blocks): the selected (chunk, rank) weight blocks in
    a fixed-capacity id list for the block-gather kernels (K6, K7), by a
    cumsum over the rank-major flags: ids come out ascending, pads are the
    trailing all-zero block, and overflow drops the deepest ranks first.

The kernels compute the same search with their own threshold table
(kernels/fused_stream.thresh_tables); the two tables differ in the last
bit, as they do in the JAX package, and each is held against its own
counterpart there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from effort_tpu_torch.ops.layouts import BucketedMatrix, strided_sample

_NL = 32
_RATIO = 0.62


def effort_q16(effort, device) -> torch.Tensor:
    """Effort as the kernels take it: 16.16 fixed point in an int32 [1]
    device tensor. A float or an f32 tensor is rounded (f32 multiply, round
    half to even); an int32 tensor is taken to be 16.16 already."""
    if isinstance(effort, torch.Tensor) and effort.dtype == torch.int32:
        return effort.reshape(1)
    e = torch.as_tensor(effort, dtype=torch.float32, device=device)
    return torch.round(e * 65536.0).to(torch.int32).reshape(1)


def effort_f32(effort, device) -> torch.Tensor:
    """Effort as an f32 scalar tensor; a 16.16 int32 tensor is decoded."""
    if isinstance(effort, torch.Tensor) and effort.dtype == torch.int32:
        return effort.reshape(()).to(torch.float32) * (1.0 / 65536.0)
    return torch.as_tensor(effort, dtype=torch.float32, device=device)


_RATIOS: dict = {}


def _ratio_table(device) -> torch.Tensor:
    """[_NL] f32 0.62 ** (1..32), computed once on the CPU (as the JAX
    package computes it there) and copied to each device, so the search
    compares against the same thresholds on every device."""
    key = str(device)
    if key not in _RATIOS:
        _RATIOS[key] = (torch.tensor(_RATIO, dtype=torch.float32)
                        ** torch.arange(1, _NL + 1, dtype=torch.float32)
                        ).to(device)
    return _RATIOS[key]


def quantile_count(P: int, effort, device):
    """clip(round(P * effort), 1, P) in f32 (round half to even): a python
    float for a float effort (computed on the host, so no device tensor is
    made from it), else an f32 tensor."""
    if isinstance(effort, (int, float)):
        return float(np.clip(np.round(np.float32(P) * np.float32(effort)),
                             1, P))
    return torch.clamp(torch.round(P * effort_f32(effort, device)), 1.0,
                       float(P))


def compute_cutoff(v_probe_sample: torch.Tensor, probes: torch.Tensor,
                   effort) -> torch.Tensor:
    """Approximate quantile cutoff: a value with ~effort*P of the sampled
    |v[probe_dims]*probes| above it (within ~1% in value). `effort` is a
    float, an f32 tensor or a 16.16 int32 tensor (effort_q16)."""
    scores = torch.abs(v_probe_sample * probes)
    dev = scores.device
    P = scores.shape[0]
    k = quantile_count(P, effort, dev)

    m = torch.max(scores) + 1e-30
    ratios = _ratio_table(dev)

    def at(x, i):
        # x[i] for a 0-d index tensor, read on the device (indexing with
        # it would read it to the host and wait for the card)
        return x.index_select(0, i.reshape(1))[0]

    def first_hit(t):
        counts = (scores[None, :] > t[:, None]).sum(dim=1)
        hits = counts >= k
        # first threshold whose count reaches k (counts grow as t falls)
        idx = torch.argmax(hits.to(torch.int32))
        return idx, at(hits, idx)

    t = m * ratios
    idx, hit = first_hit(t)
    lo = torch.where(hit, at(t, idx), torch.zeros_like(m))
    hi = torch.where(hit & (idx > 0), at(t, torch.clamp(idx - 1, min=0)), m)
    # refine linearly inside [lo, hi]
    fr = torch.arange(1, _NL + 1, dtype=torch.float32, device=dev) / _NL
    t2 = hi - (hi - lo) * fr
    idx2, hit2 = first_hit(t2)
    return torch.where(hit2, at(t2, idx2), lo)


def compute_cutoff_exact(v_probe_sample: torch.Tensor, probes: torch.Tensor,
                         effort) -> torch.Tensor:
    """Sort-based exact version (tests / oracle comparisons)."""
    scores = torch.abs(v_probe_sample * probes)
    P = scores.shape[0]
    k = quantile_count(P, effort, scores.device)
    k = int(k) if isinstance(k, float) else k.to(torch.int64)
    s_desc = torch.sort(scores, descending=True).values
    return s_desc[k - 1]


def row_rank_counts(v: torch.Tensor, stats: torch.Tensor,
                    cutoff: torch.Tensor) -> torch.Tensor:
    """n_i in [0, K]: how many leading ranks of row i pass the cutoff.
    stats: [in, K] (one instance). Returns int32 [in]."""
    sel = stats * torch.abs(v)[:, None] > cutoff
    return sel.sum(dim=1).to(torch.int32)


def rank_inputs(bm: BucketedMatrix, v: torch.Tensor, effort, expert: int):
    """The selection both rank-prefix dispatches share: (vp, n, u) with vp
    the permuted input, n [in] the rank counts and u [K, in] f32 = v *
    [k < n_i] (* the dequant scale)."""
    vp = bm.permute_v(v, expert)
    cutoff = compute_cutoff(strided_sample(vp, bm.in_dim,
                                           bm.probes.shape[1]),
                            bm.probes[expert], effort)
    n = row_rank_counts(vp, bm.stats[expert], cutoff)
    ranks = torch.arange(bm.n_ranks, dtype=torch.int32, device=vp.device)
    u = vp[None, :] * (ranks[:, None] < n[None, :])
    if bm.scales is not None:
        u = u * bm.scales[expert].T
    return vp, n, u.to(torch.float32)


class BlockSelection(NamedTuple):
    """Compacted dispatch for the block-gather kernels."""
    block_ids: torch.Tensor  # [max_blocks] int32, padded with zero_block_id
    u_scaled: torch.Tensor   # [K, n_chunks, G] f32: v * rank-mask (* scale)
    n_blocks: torch.Tensor   # [] int32: real blocks, before the capacity cap


def select_blocks(bm: BucketedMatrix, v: torch.Tensor, effort, expert: int,
                  max_blocks: int) -> BlockSelection:
    """The compacted block list and the masked, scaled input of one matvec
    (plain tensor ops, no host sync). Block (k, g) is needed iff some row
    of chunk g selects rank k, i.e. max_i n_i > k; the flags are taken in
    rank-major order (the block-id layout) and compacted by a cumsum."""
    K, G, nc = bm.n_ranks, bm.chunk_rows, bm.n_chunks
    _, n, u = rank_inputs(bm, v, effort, expert)
    dev = u.device
    ranks = torch.arange(K, dtype=torch.int32, device=dev)
    maxn = torch.amax(n.reshape(nc, G), dim=1)
    flags = (ranks[:, None] < maxn[None, :]).reshape(-1).to(torch.int32)
    cum = torch.cumsum(flags, 0, dtype=torch.int32)
    slot = torch.where(flags == 1, cum - 1, max_blocks).clamp(max=max_blocks)
    gids = expert * bm.blocks_per_expert + torch.arange(
        K * nc, dtype=torch.int32, device=dev)
    ids = torch.full((max_blocks + 1,), bm.zero_block_id, dtype=torch.int32,
                     device=dev)
    # flagged blocks land on distinct slots; the rest and the overflow go
    # to the last slot, which is cut off
    ids = ids.scatter(0, slot.long(), torch.where(
        flags == 1, gids, bm.zero_block_id))[:max_blocks]
    tail = torch.arange(max_blocks, device=dev) >= torch.clamp(
        cum[-1], max=max_blocks)
    ids = torch.where(tail, bm.zero_block_id, ids)
    return BlockSelection(block_ids=ids, u_scaled=u.reshape(K, nc, G),
                          n_blocks=cum[-1])
