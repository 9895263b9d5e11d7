"""Slow, obvious numpy oracle for bucketMul semantics (the JAX package's
ops/oracle.py, kept as the port's own copy: pure numpy, the same arrays).

The ground truth the implementations are tested against, written
independently against the algorithm contract:

  offline:  per input row, split output columns into buckets of B; sort each
            bucket by |w| desc; rank-k of all buckets of row i forms bucket
            row (i,k); stats[i,k] = mean |w| of that bucket row.
  runtime:  cutoff = value with ~P*effort of the sampled |v_d * probe_d|
            above it; select bucket rows where stats[i,k]*|v_i| > cutoff;
            multiply only those, scattering into the original columns.
"""

from __future__ import annotations

import numpy as np

from effort_tpu_torch.ops.layouts import probe_sample_indices


def bucketize_oracle(wt: np.ndarray, bucket_size: int, n_probes: int = 4096):
    """wt: [in_dim, out_dim] float. Returns (vals, pos, stats, probes, pdims).

    vals/pos: [in_dim, B, out_dim//B] — rank-major bucket rows.
    """
    in_dim, out_dim = wt.shape
    B = bucket_size
    assert out_dim % B == 0
    nb = out_dim // B
    vals = np.zeros((in_dim, B, nb), np.float32)
    pos = np.zeros((in_dim, B, nb), np.int8)
    for i in range(in_dim):
        for j in range(nb):
            bucket = wt[i, j * B:(j + 1) * B]
            order = np.argsort(-np.abs(bucket), kind="stable")
            for k in range(B):
                vals[i, k, j] = bucket[order[k]]
                pos[i, k, j] = order[k]
    stats = np.mean(np.abs(vals), axis=2)  # [in_dim, B]
    pidx = probe_sample_indices(in_dim, out_dim, n_probes)
    probes = wt[pidx[:, 0], pidx[:, 1]].astype(np.float32)
    return vals, pos, stats, probes, pidx[:, 0]


def cutoff_oracle(v: np.ndarray, probes: np.ndarray, probe_dims: np.ndarray,
                  effort: float) -> float:
    """Quantile cutoff over sampled |v*probe| so ~effort fraction is above:
    target count P - (P-1)*(1-effort), exactly, by sorting (not by a
    tolerance-terminated search)."""
    scores = np.abs(v[probe_dims] * probes)
    P = scores.shape[0]
    k = int(np.clip(round(P * effort), 1, P))
    return float(np.sort(scores)[::-1][k - 1])


def row_rank_counts_oracle(v, stats, cutoff):
    """n_i = number of leading ranks selected for input row i."""
    sel = stats * np.abs(v)[:, None] > cutoff  # [in_dim, K]
    # stats are non-increasing in k, so selection is a prefix; count it.
    return sel.sum(axis=1).astype(np.int32)


def bucketmul_oracle(v: np.ndarray, vals, pos, stats, probes, probe_dims,
                     effort: float) -> np.ndarray:
    """Effort-truncated matvec: y ~= v @ wt using only selected bucket rows."""
    in_dim, K, nb = vals.shape
    B = K
    cutoff = cutoff_oracle(v, probes, probe_dims, effort)
    n = row_rank_counts_oracle(v, stats, cutoff)
    y = np.zeros(nb * B, np.float32)
    for i in range(in_dim):
        for k in range(n[i]):
            for j in range(nb):
                y[j * B + int(pos[i, k, j])] += v[i] * vals[i, k, j]
    return y
