"""Frozen copy of the effort arithmetic: row-prefix int8 bucketization
(bucket size 1) and the run-time row selection, in plain PyTorch.

This is the yardstick's own copy, independent of the program: it imports
nothing of the port and takes none of the program's weights, scales or
tables. It rebuilds each matrix from the raw weights the benchmark made:

  - rows are permuted into descending calibration order (the relayout
    that makes the leading chunks hold the largest activations);
  - each row (an input dim) is quantized to int8 with one absmax scale;
    its selection statistic is the mean |w| of the row in f32;
  - a probe sample of (row, column) weights sets the cutoff quantile.

At run time, for an input vector v (permuted space) and an effort e:
  - scores |v[probe rows] * probes| give a cutoff: the value with about
    e * P of the scores above it, found by a two-level search over 32
    geometric and then 32 linear thresholds below the largest score;
  - row i is selected when stats_i * |v_i| > cutoff; its input is
    u_i = bf16(v_i * scale_i);
  - the streamed prefix is the shortest run of chunks that holds tau of
    the selected mass (tau None keeps every selected row);
  - y = u[:C*G] @ codes[:C*G] in f32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

N_LEVELS = 32
RATIO = 0.62


def calib_order(rms: torch.Tensor) -> torch.Tensor:
    """Descending-rms row order (stable)."""
    return torch.argsort(-rms.float(), stable=True)


def chunk_rows(in_dim: int, out_dim: int, base: int = 128,
               item_bytes: float = 1.0) -> int:
    """Rows a streamed chunk: the largest of 1024, 512, 256, 128 that
    divides in_dim, leaves at least 4 chunks and spans at most 3 MiB."""
    for cand in (1024, 512, 256, 128):
        if (in_dim % cand == 0 and cand * 4 <= in_dim
                and cand * out_dim * item_bytes <= 3 * 2**20):
            return max(base, cand)
    return base


def probe_rows(in_dim: int, n_probes: int) -> np.ndarray:
    """The probes' input rows: every ceil(in_dim / n_probes)-th row."""
    stride = max(1, -(-in_dim // n_probes))
    return np.arange(in_dim // stride, dtype=np.int64) * stride


@dataclasses.dataclass
class Matrix:
    """One quantized matrix, rows in the permuted space: codes [in, out]
    f32 (integers in [-127, 127]), scale/stats [in] f32, probes [P] f32."""
    codes: torch.Tensor
    scale: torch.Tensor
    stats: torch.Tensor
    probes: torch.Tensor
    G: int

    @property
    def in_dim(self) -> int:
        return self.codes.shape[0]

    @property
    def out_dim(self) -> int:
        return self.codes.shape[1]


def quantize(wt: torch.Tensor, n_probes: int = 4096, base_rows: int = 128,
             bits: int = 8) -> Matrix:
    """wt [in, out] f32 (already permuted) -> Matrix. bits 8: codes in
    [-127, 127], scale absmax / 127."""
    if bits != 8:
        raise ValueError("the reference states int8 buckets")
    wt = wt.float()
    in_dim, out_dim = wt.shape
    # true division by a 0-d tensor: x / d for a python d may be taken as
    # x * (1 / d) on the card, one bit off
    scale = torch.clamp(wt.abs().amax(dim=1), min=1e-30) / torch.full(
        (), 127.0, device=wt.device)
    codes = torch.clamp(torch.round(wt / scale[:, None]), -127, 127)
    rows = torch.as_tensor(probe_rows(in_dim, n_probes), device=wt.device)
    probes = wt[rows, rows % out_dim]
    return Matrix(codes=codes, scale=scale, stats=wt.abs().mean(dim=1),
                  probes=probes,
                  G=chunk_rows(in_dim, out_dim, base_rows))


_TABLES: dict = {}


def thresholds(device) -> tuple:
    """(geo [32], frac [32]) f32: geo[j] = exp((j+1) ln 0.62), computed on
    the host in f32; frac[j] = (j+1)/32."""
    key = str(device)
    if key not in _TABLES:
        j1 = torch.arange(1, N_LEVELS + 1, dtype=torch.float32)
        geo = torch.exp(j1 * float(np.log(RATIO)))
        _TABLES[key] = (geo.to(device), (j1 * (1.0 / N_LEVELS)).to(device))
    return _TABLES[key]


def effort_fraction(effort: float) -> float:
    """The effort as the selection takes it: 16.16 fixed point."""
    q = int(np.round(np.float32(effort) * np.float32(65536.0)))
    return float(np.float32(q) * np.float32(1.0 / 65536.0))


def cutoffs(scores: torch.Tensor, effort: float) -> torch.Tensor:
    """scores [T, P] -> cutoff [T]: the two-level threshold search."""
    P = scores.shape[-1]
    kq = float(np.clip(np.round(np.float32(P) * np.float32(
        effort_fraction(effort))), 1, P))
    geo, frac = thresholds(scores.device)
    m = torch.amax(scores, dim=-1) + 1e-30

    def level(t, lo0, hi0):                          # t [T, 32]
        cnt = (scores[:, None, :] > t[:, :, None]).sum(dim=-1)
        misses = (cnt < kq).sum(dim=-1)               # first index that hits
        hit = misses < N_LEVELS

        def at(i):
            return torch.gather(t, 1, i[:, None])[:, 0]
        lo = torch.where(hit, at(torch.clamp(misses, max=N_LEVELS - 1)),
                         lo0)
        hi = torch.where(hit & (misses >= 1),
                         at(torch.clamp(misses - 1, min=0)), hi0)
        return lo, hi

    lo, hi = level(m[:, None] * geo, torch.zeros_like(m), m)
    cut, _ = level(hi[:, None] - (hi - lo)[:, None] * frac, lo, hi)
    return cut


def coverage_rows(mat: Matrix, x: torch.Tensor, sel: torch.Tensor,
                  tau: float) -> torch.Tensor:
    """Rows of the shortest chunk prefix holding tau of each vector's
    selected mass x[sel] ([T] int64, C * G). Masses add in f64, each
    chunk prefix rounded to f32 once."""
    nc = mat.in_dim // mat.G
    mass = torch.where(sel, x, torch.zeros_like(x))
    cum = torch.cumsum(mass.reshape(-1, nc, mat.G).to(torch.float64).sum(-1),
                       -1).to(torch.float32)
    tot = torch.amax(cum, dim=-1, keepdim=True)
    C = torch.clamp((cum < tau * tot).sum(-1) + 1, max=nc)
    return C.to(torch.int64) * mat.G


def select(mat: Matrix, V: torch.Tensor, effort: float):
    """V [T, in] f32 -> (u [T, in] f32 holding bf16 values, x [T, in] the
    selection scores stats * |v|, sel [T, in] the selected rows)."""
    stride = max(1, mat.in_dim // mat.probes.shape[0])
    n = mat.probes.shape[0]
    scores = torch.abs(V[:, :n * stride:stride] * mat.probes)
    cut = cutoffs(scores, effort)
    x = mat.stats * torch.abs(V)
    sel = x > cut[:, None]
    u = (torch.where(sel, V, torch.zeros_like(V)) * mat.scale).to(
        torch.bfloat16).to(torch.float32)
    return u, x, sel


def matmul(mat: Matrix, V: torch.Tensor, effort: float, tau,
           record=None, record_tau: float = 0.97) -> torch.Tensor:
    """The effort product of every row of V [T, in]: [T, out] f32, with u
    zeroed past the prefix that holds tau of the selected mass (tau None:
    every selected row). record, when given, is called with the rows
    each vector needs at record_tau coverage ([T] int64): the work the
    inputs need, whatever prefix the product takes."""
    u, x, sel = select(mat, V, effort)
    if tau is not None:
        rows = coverage_rows(mat, x, sel, tau)
        live = torch.arange(mat.in_dim, device=V.device)[None, :] \
            < rows[:, None]
        u = torch.where(live, u, torch.zeros_like(u))
    if record is not None:
        record(coverage_rows(mat, x, sel, record_tau))
    return u @ mat.codes


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * weight


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [T, heads, D] at integer positions pos [T]."""
    D = x.shape[-1]
    h = D // 2
    freqs = theta ** (-torch.arange(0, h, dtype=torch.float32,
                                    device=x.device) / h)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention_follow(Q, K, V, Kp, Vp, n_kv: int) -> torch.Tensor:
    """Causal attention in f32 over one sequence whose earlier keys and
    values are given (Kp, Vp [n, KV, D]: the rows another pass wrote):
    query t sees Kp/Vp at s < t and its own K[t]/V[t] at s = t."""
    n, H, D = Q.shape
    rep = H // n_kv
    q = Q.reshape(n, n_kv, rep, D)
    s = torch.einsum("tkrd,skd->krts", q, Kp) / math.sqrt(D)
    own = torch.einsum("tkrd,tkd->krt", q, K) / math.sqrt(D)
    idx = torch.arange(n, device=Q.device)
    s = torch.where(idx[None, :] < idx[:, None], s,
                    torch.full_like(s, -math.inf))
    s[..., idx, idx] = own
    p = torch.softmax(s, dim=-1)
    p_own = p[..., idx, idx].clone()                  # [KV, rep, n]
    p[..., idx, idx] = 0.0
    out = torch.einsum("krts,skd->tkrd", p, Vp) \
        + p_own.permute(2, 0, 1)[..., None] * V[:, :, None, :]
    return out.reshape(n, H * D)


def attention(Q, K, V, qpos, kpos, n_kv: int) -> torch.Tensor:
    """Causal attention in f32: Q [T, H, D] at positions qpos, K/V [S, KV,
    D] at kpos; query t sees keys with kpos <= qpos[t]."""
    T, H, D = Q.shape
    rep = H // n_kv
    q = Q.reshape(T, n_kv, rep, D)
    s = torch.einsum("tkrd,skd->krts", q, K) / math.sqrt(D)
    mask = kpos[None, :] <= qpos[:, None]
    s = torch.where(mask[None, None], s, torch.full_like(s, -math.inf))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("krts,skd->tkrd", p, V).reshape(T, H * D)
