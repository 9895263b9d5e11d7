"""Runtime effort selection: cutoff quantile and per-row rank counts.

  - cutoff: a quantile of the sampled |v * probe| scores, found by a
    two-level threshold search (32 geometric thresholds, then 32 linear
    ones inside the bracket): deterministic and within ~1% in value. A
    sort-based exact version exists for tests and oracle work.
  - selection: stats[i,k]*|v_i| > cutoff is monotone in k (stats, the mean
    |w| of rank-k elements, is non-increasing in k), so the selected set per
    input row is a rank prefix n_i.

The kernels compute the same search with their own threshold table
(kernels/fused_stream.thresh_tables); the two tables differ in the last
bit, as they do in the JAX package, and each is held against its own
counterpart there.
"""

from __future__ import annotations

import torch

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


def compute_cutoff(v_probe_sample: torch.Tensor, probes: torch.Tensor,
                   effort) -> torch.Tensor:
    """Approximate quantile cutoff: a value with ~effort*P of the sampled
    |v[probe_dims]*probes| above it (within ~1% in value). `effort` is a
    float, an f32 tensor or a 16.16 int32 tensor (effort_q16)."""
    scores = torch.abs(v_probe_sample * probes)
    dev = scores.device
    P = scores.shape[0]
    k = torch.clamp(torch.round(P * effort_f32(effort, dev)), 1.0, float(P))

    m = torch.max(scores) + 1e-30
    ratios = torch.tensor(_RATIO, dtype=torch.float32, device=dev) ** \
        torch.arange(1, _NL + 1, dtype=torch.float32, device=dev)

    def first_hit(t):
        counts = (scores[None, :] > t[:, None]).sum(dim=1)
        hits = counts >= k
        # first threshold whose count reaches k (counts grow as t falls)
        idx = torch.argmax(hits.to(torch.int32))
        return idx, hits[idx]

    t = m * ratios
    idx, hit = first_hit(t)
    lo = torch.where(hit, t[idx], torch.zeros_like(m))
    hi = torch.where(hit & (idx > 0), t[torch.clamp(idx - 1, min=0)], m)
    # refine linearly inside [lo, hi]
    fr = torch.arange(1, _NL + 1, dtype=torch.float32, device=dev) / _NL
    t2 = hi - (hi - lo) * fr
    idx2, hit2 = first_hit(t2)
    return torch.where(hit2, t2[idx2], lo)


def compute_cutoff_exact(v_probe_sample: torch.Tensor, probes: torch.Tensor,
                         effort) -> torch.Tensor:
    """Sort-based exact version (tests / oracle comparisons)."""
    scores = torch.abs(v_probe_sample * probes)
    P = scores.shape[0]
    k = torch.clamp(torch.round(P * effort_f32(effort, scores.device)), 1, P
                    ).to(torch.int64)
    s_desc = torch.sort(scores, descending=True).values
    return s_desc[k - 1]


def row_rank_counts(v: torch.Tensor, stats: torch.Tensor,
                    cutoff: torch.Tensor) -> torch.Tensor:
    """n_i in [0, K]: how many leading ranks of row i pass the cutoff.
    stats: [in, K] (one instance). Returns int32 [in]."""
    sel = stats * torch.abs(v)[:, None] > cutoff
    return sel.sum(dim=1).to(torch.int32)
