"""Row-prefix effort matvec (bucket_size = 1): the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the TPU kernel effort_tpu/kernels/fused_stream.py:mxu_matvec ->
_kernel_mxu. The kernel (csrc/mxu_matvec.cu) selects input rows against an
effort-dependent cutoff, finds the shortest chunk prefix that holds tau of
the selected mass, and streams only that prefix of the weights. It is bound
by the streamed bytes, C*G*row_bytes, over the card's memory rate.

Effort reaches the kernel as a 16.16 fixed-point int32 device tensor, as
the TPU kernel takes it, so moving the knob needs no host sync and no
rebuild.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from effort_tpu_torch.kernels import LAUNCHES, _build
from effort_tpu_torch.ops.effort import effort_q16
from effort_tpu_torch.ops.layouts import (BucketedMatrix, strided_sample,
                                          strided_sample_len)

_NL = 32          # thresholds per cutoff-search level
_RATIO = 0.62
# Selected-mass coverage target of the streamed prefix (see the module
# docstring); read at call time, so tests and scripts may set it.
_TAU = float(os.environ.get("EFFORT_TPU_TAU", "0.97"))
_MAX_PROBES = 4096
_MAX_CHUNKS = 1024
_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.uint8: 2}
# enough blocks in flight for 132 SMs: at least two per SM
_MIN_BLOCKS = 264

LAUNCHES["mxu_matvec"] = 0
_TABLES: dict = {}


def thresh_tables(device) -> torch.Tensor:
    """[2*_NL] f32: geo[j] = exp((j+1) ln 0.62), then frac[j] = (j+1)/32 —
    the kernel's threshold table (fused_stream.py:_thresh_tables), built
    once on the CPU and copied to each device, so the kernel and the plain
    version compare against identical thresholds."""
    key = str(device)
    if key not in _TABLES:
        j1 = torch.arange(1, _NL + 1, dtype=torch.float32)
        geo = torch.exp(j1 * float(np.log(_RATIO)))
        _TABLES[key] = torch.cat([geo, j1 * (1.0 / _NL)]).to(device)
    return _TABLES[key]


def _vec_cutoff(scores, kq, m, tables):
    """Two-level threshold search with the kernel's table; the first index
    whose count reaches kq equals the number of misses (counts are
    non-decreasing along a level)."""
    geo, frac = tables[:_NL], tables[_NL:]

    def level(t, lo0, hi0):
        cnt = (scores[None, :] > t[:, None]).sum(dim=1).to(torch.float32)
        nh = (cnt < kq).sum()
        hit = nh < _NL
        t_lo = torch.where(hit, t[torch.clamp(nh, max=_NL - 1)], lo0)
        t_hi = torch.where(hit & (nh >= 1), t[torch.clamp(nh - 1, min=0)],
                           hi0)
        return t_lo, t_hi

    lo, hi = level(m * geo, torch.zeros_like(m), m)
    cutoff, _ = level(hi - (hi - lo) * frac, lo, hi)
    return cutoff


def _weights_as_float(bm: BucketedMatrix, expert: int) -> torch.Tensor:
    """Instance `expert` of vals as f32 [in_dim, OB], integer codes
    undequantized (the scales ride in u)."""
    nc, G = bm.n_chunks, bm.chunk_rows
    blocks = bm.vals[expert * nc:(expert + 1) * nc]
    if bm.vals_packed:
        lo = (blocks & 15).to(torch.float32) - 8.0
        hi = (blocks >> 4).to(torch.float32) - 8.0
        w = torch.cat([lo, hi], dim=-1)[..., :bm.n_buckets]
    else:
        w = blocks.to(torch.float32)
    return w.reshape(nc * G, bm.n_buckets)


def mxu_matvec_ref(bm: BucketedMatrix, v: torch.Tensor, effort,
                   expert: int = 0, tau: float = None,
                   return_len: bool = False):
    """Plain PyTorch version of the kernel: the same cutoff on the 16.16
    effort, u rounded to bf16, C from torch.cumsum, and
    y = u[:C*G] @ W[:C*G] in f32. Returns y [OB] f32, or (y, C) with C an
    int32 [1] tensor."""
    tau = _TAU if tau is None else tau
    if bm.bucket_size != 1:
        raise ValueError("mxu_matvec needs the row-prefix layout "
                         "(bucket_size=1)")
    G, nc = bm.chunk_rows, bm.n_chunks
    vp = bm.permute_v(v, expert).to(torch.float32)
    dev = vp.device
    vs = strided_sample(vp, bm.in_dim, bm.probes.shape[1])
    P = vs.shape[0]
    scores = torch.abs(vs * bm.probes[expert].to(torch.float32))
    eff = effort_q16(effort, dev).to(torch.float32)[0] * (1.0 / 65536.0)
    kq = torch.clamp(torch.round(P * eff), 1.0, float(P))
    m = torch.max(scores) + 1e-30
    cutoff = _vec_cutoff(scores, kq, m, thresh_tables(dev))

    x = bm.stats[expert, :, 0] * torch.abs(vp)
    sel = x > cutoff
    u = torch.where(sel, vp, torch.zeros_like(vp))
    if bm.scales is not None:
        u = u * bm.scales[expert, :, 0]
    u = u.to(torch.bfloat16)

    mass = torch.where(sel, x, torch.zeros_like(x)).reshape(nc, G).sum(1)
    # each prefix rounded to f32 once, as the kernel's serial sum does
    cum = torch.cumsum(mass.to(torch.float64), 0).to(torch.float32)
    tot = torch.max(cum)
    C = torch.clamp((cum < tau * tot).sum() + 1, max=nc).to(torch.int32)
    rows = torch.arange(bm.in_dim, device=dev) < C * G
    u_pre = torch.where(rows, u.to(torch.float32), torch.zeros_like(vp))
    y = u_pre @ _weights_as_float(bm, expert)
    return (y, C.reshape(1)) if return_len else y


def _lib():
    lib = _build.load("mxu_matvec")
    if not getattr(lib, "_effort_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.effort_mxu_matvec.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, i,
            p, p, p, p, p, i, p]
        lib.effort_mxu_matvec.restype = i
        lib.effort_cuda_error_string.argtypes = [i]
        lib.effort_cuda_error_string.restype = ctypes.c_char_p
        lib._effort_typed = True
    return lib


def _rows_per_block(tiles: int, in_dim: int) -> int:
    """Rows per streaming block: the largest of 256..32 that still puts
    _MIN_BLOCKS blocks on the card (fewer rows per block means more
    partial sums to write and add)."""
    for rb in (256, 128, 64):
        if tiles * -(-in_dim // rb) >= _MIN_BLOCKS:
            return rb
    return 32


def _check(bm: BucketedMatrix, v: torch.Tensor, expert: int):
    E, nc, G = bm.n_experts, bm.n_chunks, bm.chunk_rows
    if bm.bucket_size != 1:
        raise ValueError("mxu_matvec needs the row-prefix layout "
                         "(bucket_size=1)")
    if not isinstance(expert, int) or not 0 <= expert < E:
        raise ValueError(f"expert {expert!r} not an int in [0, {E})")
    vals = bm.vals
    if vals.dtype not in _KIND or vals.ndim != 3 \
            or not vals.is_contiguous() \
            or tuple(vals.shape[:2]) != (E * nc + 1, G):
        raise ValueError(f"vals {vals.dtype} {tuple(vals.shape)}: want "
                         f"contiguous bf16/int8/uint8 [{E * nc + 1}, {G}, *]")
    row_bytes = vals.shape[2] * vals.element_size()
    decoded = vals.shape[2] * (2 if bm.vals_packed else 1)
    if row_bytes % 16 or decoded < bm.n_buckets \
            or (not bm.vals_packed and decoded != bm.n_buckets):
        raise ValueError(f"vals width {vals.shape[2]} does not fit "
                         f"out_dim {bm.out_dim} in 16-byte rows")
    P = strided_sample_len(bm.in_dim, bm.probes.shape[1])
    if not 1 <= P <= _MAX_PROBES or tuple(bm.probes.shape) != (E, P) \
            or nc > _MAX_CHUNKS:
        raise ValueError(f"probes {tuple(bm.probes.shape)} / {nc} chunks "
                         f"outside the kernel's limits")
    want = (E, bm.in_dim, 1)
    for name in ("stats", "scales", "probes"):
        t = getattr(bm, name)
        if t is None:
            if name == "scales" and vals.dtype == torch.bfloat16:
                continue
            raise ValueError(f"{name} missing")
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or (name != "probes" and tuple(t.shape) != want):
            raise ValueError(f"{name}: want contiguous f32 {want}")
    if bm.scales is not None and vals.dtype == torch.bfloat16:
        raise ValueError("bf16 values take no scales")
    for t in (vals, bm.stats, bm.probes):
        if t.device != v.device:
            raise ValueError(f"weights on {t.device}, v on {v.device}")


def mxu_matvec(bm: BucketedMatrix, v: torch.Tensor, effort,
               expert: int = 0, tau: float = None,
               return_len: bool = False):
    """Row-prefix effort matvec: y [OB] f32 (or (y, C) with the streamed
    chunk count C as an int32 [1] device tensor).

    effort: a float, an f32 tensor or a 16.16 int32 tensor (effort_q16).
    expert: instance index (the layer in the packed per-projection
    containers). tau: coverage target, default the module's _TAU.

    CPU tensors run the plain version (mxu_matvec_ref); CUDA tensors launch
    the kernel, on the current stream without synchronising, or raise."""
    if not v.is_cuda:
        return mxu_matvec_ref(bm, v, effort, expert, tau, return_len)
    tau = _TAU if tau is None else tau
    _check(bm, v, expert)
    dev = v.device
    vp = bm.permute_v(v, expert).to(torch.float32).contiguous()
    if vp.shape != (bm.in_dim,):
        raise ValueError(f"v {tuple(v.shape)} vs in_dim {bm.in_dim}")
    eq = effort_q16(effort, dev)
    if eq.device != dev:
        raise ValueError(f"effort on {eq.device}, v on {dev}")
    tables = thresh_tables(dev)
    G, nc, in_dim = bm.chunk_rows, bm.n_chunks, bm.in_dim
    P = bm.probes.shape[1]
    stride = max(1, -(-in_dim // P))
    row_bytes = bm.vals.shape[2] * bm.vals.element_size()
    width = bm.vals.shape[2] * (2 if bm.vals_packed else 1)
    rb = _rows_per_block(-(-row_bytes // 512), in_dim)

    u = torch.empty(in_dim, dtype=torch.bfloat16, device=dev)
    c_len = torch.empty(1, dtype=torch.int32, device=dev)
    cutoff = torch.empty(1, dtype=torch.float32, device=dev)
    partial = torch.empty((-(-in_dim // rb), width), dtype=torch.float32,
                          device=dev)
    y = torch.empty(bm.n_buckets, dtype=torch.float32, device=dev)
    vals_ptr = bm.vals.data_ptr() + expert * in_dim * row_bytes
    scales_ptr = (bm.scales.data_ptr() + expert * in_dim * 4
                  if bm.scales is not None else None)
    lib = _lib()
    err = lib.effort_mxu_matvec(
        vp.data_ptr(), bm.probes.data_ptr() + expert * P * 4,
        bm.stats.data_ptr() + expert * in_dim * 4, scales_ptr,
        eq.data_ptr(), tables.data_ptr(), vals_ptr,
        _KIND[bm.vals.dtype], in_dim, row_bytes, bm.n_buckets, G, nc, P,
        stride, float(tau), rb, width,
        u.data_ptr(), c_len.data_ptr(), cutoff.data_ptr(),
        partial.data_ptr(), y.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("mxu_matvec launch failed: "
                           + lib.effort_cuda_error_string(err).decode())
    LAUNCHES["mxu_matvec"] += 1
    return (y, c_len) if return_len else y
