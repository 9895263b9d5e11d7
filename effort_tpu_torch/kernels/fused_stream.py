"""Effort matvecs with the selection inside the kernel: the row-prefix
matvec and matmul (bucket_size = 1, K1 and K2) and the rank-prefix matvec
(bucket_size >= 2, K4); the CUDA kernels' wrappers and their plain PyTorch
versions.

  - mxu_matvec (K1) replaces effort_tpu/kernels/fused_stream.py:mxu_matvec
    -> _kernel_mxu, in csrc/mxu_matvec.cu. The kernel selects input rows
    against an effort-dependent cutoff, finds the shortest chunk prefix
    that holds tau of the selected mass, and streams only that prefix of
    the weights. It is bound by the streamed bytes, C*G*row_bytes, over the
    card's memory rate. The selection runs as a grid of blocks owning
    whole chunks, the last of them to finish finding C (a per-card scratch
    and ticket, as K4's); the stream and the split sum are programmatic
    dependents of the launch before them. Effort reaches it as a 16.16
    fixed-point int32 device tensor, as the TPU kernel takes it, so moving
    the knob needs no host sync and no rebuild.
  - mxu_matvec_batch (K2) replaces fused_stream.py:mxu_matvec_batch ->
    _kernel_mxu_batch, in csrc/mxu_matvec_batch.cu: the same for T slots
    (prefill tokens or batched decode slots), each with its own f32 effort
    and selection; the streamed prefix is the longest slot's, and its
    product runs on the tensor cores (wgmma, bf16 in, f32 out) with the
    launch shape from k2_plan.
  - fused_matvec (K4) replaces fused_stream.py:fused_matvec -> _kernel, in
    csrc/fused_matvec.cu (+ csrc/rank_prefix.cuh): a grid of blocks, each
    owning whole chunks, selects (K1's cutoff search on the 16.16 effort,
    rank counts, u in f32, chunk masses in f64), and the last of them to
    finish scans each rank's coverage length C_k in tiles of TGB chunks;
    then the per-rank prefix stream that K5 shares (kernels/prefix_stream,
    a shared-memory ring filled by the copy engine) scatters by packed
    position into y[j*B + p]. Bound by the streamed bytes. The TPU kernel
    takes a static effort; this one reads the 16.16 device tensor at run
    time, as K1 does.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from effort_tpu_torch.kernels import LAUNCHES, _build
from effort_tpu_torch.kernels.prefix_stream import (_KIND, StreamSelection,
                                                    body_limits,
                                                    check_instance,
                                                    coverage_lengths,
                                                    row_values, stream_plan,
                                                    stream_product_ref,
                                                    tile_offsets)
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
# enough blocks in flight for 132 SMs: at least two per SM
_MIN_BLOCKS = 264

LAUNCHES["mxu_matvec"] = 0
LAUNCHES["mxu_matvec_batch"] = 0
LAUNCHES["fused_matvec"] = 0
_MAX_MASSES = 24576       # K * nc f64 masses in K4's selection scratch
# K4's selection scratch a card: _MAX_MASSES f64 masses and the ticket of
# the last block, zeroed once (the kernel leaves the ticket at 0)
_K4_SCRATCH: dict = {}
# K1's scratch a card: "mass", _MAX_CHUNKS f64 chunk masses and the ticket
# of the selection's last block after them, zeroed once (the kernel leaves
# the ticket at 0); "u" [in_dim] bf16 and "cutoff" [1] f32, the selection
# of the last call (grown as wider inputs come)
_K1_SCRATCH: dict = {}
_TABLES: dict = {}
# K2's stream (csrc/mxu_matvec_batch.cu): row bytes of a block's 256
# output columns by value kind, and rows of a ring stage
_K2_BLOCK_BYTES = {0: 512, 1: 256, 2: 128}
_K2_TILE_ROWS = 64
_K2_PER_SM: dict = {}


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
    """Two-level threshold search with the kernel's table, batched over the
    leading axes: scores [..., P], kq and m [...]. The first index whose
    count reaches kq equals the number of misses (counts are
    non-decreasing along a level)."""
    geo, frac = tables[:_NL], tables[_NL:]

    def level(t, lo0, hi0):                                # t [..., NL]
        cnt = (scores[..., None, :] > t[..., :, None]).sum(dim=-1).to(
            torch.float32)
        nh = (cnt < kq[..., None]).sum(dim=-1)
        hit = nh < _NL

        def at(i):
            return torch.gather(t, -1, i[..., None])[..., 0]
        t_lo = torch.where(hit, at(torch.clamp(nh, max=_NL - 1)), lo0)
        t_hi = torch.where(hit & (nh >= 1), at(torch.clamp(nh - 1, min=0)),
                           hi0)
        return t_lo, t_hi

    lo, hi = level(m[..., None] * geo, torch.zeros_like(m), m)
    cutoff, _ = level(hi[..., None] - (hi - lo)[..., None] * frac, lo, hi)
    return cutoff


def _select_ref(bm: BucketedMatrix, vp: torch.Tensor, eff: torch.Tensor,
                expert: int, tau: float):
    """The kernels' selection, batched over the leading axes of vp
    [..., in] (permuted, f32) with eff [...] f32: u [..., in] bf16, each
    vector's stream length C [...] int32 and its cutoff [...] f32. The selected masses add in f64
    (exact in any order for terms spanning less than 2^29, so C does not
    hang on summation order) and each chunk prefix is rounded to f32 once,
    as the kernels sum."""
    G, nc = bm.chunk_rows, bm.n_chunks
    dev = vp.device
    vs = strided_sample(vp, bm.in_dim, bm.probes.shape[1])
    P = vs.shape[-1]
    scores = torch.abs(vs * bm.probes[expert].to(torch.float32))
    kq = torch.clamp(torch.round(P * eff), 1.0, float(P))
    m = torch.amax(scores, dim=-1) + 1e-30
    cutoff = _vec_cutoff(scores, kq, m, thresh_tables(dev))

    x = bm.stats[expert, :, 0] * torch.abs(vp)
    sel = x > cutoff[..., None]
    u = torch.where(sel, vp, torch.zeros_like(vp))
    if bm.scales is not None:
        u = u * bm.scales[expert, :, 0]
    mass = torch.where(sel, x, torch.zeros_like(x))
    C = coverage_lengths(mass.reshape(*x.shape[:-1], nc, G), tau)
    return u.to(torch.bfloat16), C, cutoff


def _prefix_product(bm: BucketedMatrix, u: torch.Tensor, C: torch.Tensor,
                    expert: int) -> torch.Tensor:
    """u[..., :C*G] @ W[:C*G] in f32 (rows past the prefix zeroed)."""
    rows = torch.arange(bm.in_dim, device=u.device) < C * bm.chunk_rows
    u_pre = torch.where(rows, u.to(torch.float32),
                        torch.zeros((), device=u.device))
    first = expert * bm.in_dim
    return u_pre @ row_values(bm, torch.arange(first, first + bm.in_dim,
                                               device=u.device))


def _need_row_prefix(bm: BucketedMatrix):
    if bm.bucket_size != 1:
        raise ValueError("the row-prefix kernels need bucket_size=1")


def mxu_select_ref(bm: BucketedMatrix, v: torch.Tensor, effort,
                   expert: int = 0, tau: float = None):
    """K1's selection in plain PyTorch, on the 16.16 effort: (u [in] bf16,
    C int32 [1], cutoff f32 [1])."""
    tau = _TAU if tau is None else tau
    _need_row_prefix(bm)
    vp = bm.permute_v(v, expert).to(torch.float32)
    eff = effort_q16(effort, vp.device).to(torch.float32)[0] \
        * (1.0 / 65536.0)
    u, C, cutoff = _select_ref(bm, vp, eff, expert, tau)
    return u, C.reshape(1), cutoff.reshape(1)


def mxu_matvec_ref(bm: BucketedMatrix, v: torch.Tensor, effort,
                   expert: int = 0, tau: float = None,
                   return_len: bool = False):
    """Plain PyTorch version of K1: the same cutoff on the 16.16 effort, u
    rounded to bf16, C from torch.cumsum, and y = u[:C*G] @ W[:C*G] in f32.
    Returns y [OB] f32, or (y, C) with C an int32 [1] tensor."""
    u, C, _ = mxu_select_ref(bm, v, effort, expert, tau)
    y = _prefix_product(bm, u, C, expert)
    return (y, C) if return_len else y


def slot_efforts(efforts, T: int, device) -> torch.Tensor:
    """Per-slot efforts as K2 takes them: f32 [T] on `device`, from a float
    or an f32 tensor ([T], or a scalar repeated). A float is filled in on
    the device (no copy from the host, no wait). Other dtypes raise: K2
    takes no 16.16 effort (that is K1's form)."""
    if isinstance(efforts, (int, float)):
        return torch.full((T,), float(efforts), dtype=torch.float32,
                          device=device)
    if not isinstance(efforts, torch.Tensor) \
            or efforts.dtype != torch.float32:
        raise TypeError(f"efforts: want a float or an f32 tensor, got "
                        f"{getattr(efforts, 'dtype', type(efforts))}")
    return efforts.to(device).reshape(-1).expand(T).contiguous()


def mxu_matvec_batch_ref(bm: BucketedMatrix, V: torch.Tensor, efforts,
                         expert: int = 0, tau: float = None,
                         return_len: bool = False):
    """Plain PyTorch version of K2: each slot of V [T, in] selects at its
    own f32 effort (kq = clip(round(P*eff), 1, P)), u is rounded to bf16,
    and every slot streams C = the largest slot's coverage length:
    Y = u[:, :C*G] @ W[:C*G] in f32. Returns Y [T, OB] f32, or (Y, C)."""
    tau = _TAU if tau is None else tau
    _need_row_prefix(bm)
    Vp = bm.permute_v(V, expert).to(torch.float32)
    eff = slot_efforts(efforts, Vp.shape[0], Vp.device)
    u, C, _ = _select_ref(bm, Vp, eff, expert, tau)
    C = torch.amax(C)
    y = _prefix_product(bm, u, C, expert)
    return (y, C.reshape(1)) if return_len else y


class K2Plan(NamedTuple):
    """K2's launch shape: nn n8 slot tiles a block (8*nn slots), the grid
    (slot_tiles, col_tiles, splits), and the partial sums' shape [splits,
    T, width] f32 (None with one split: the blocks write Y)."""
    nn: int
    slot_tiles: int
    col_tiles: int
    splits: int
    partial: Optional[tuple]

    @property
    def blocks(self) -> int:
        return self.slot_tiles * self.col_tiles * self.splits


def _k2_nn(T: int) -> int:
    """n8 slot tiles a block of K2's stream takes: the fewest of 1, 2, 4, 8
    that hold T slots, 8 (64 slots) past that."""
    return next(n for n in (1, 2, 4, 8) if 8 * n >= min(T, 64))


def k2_plan(T: int, in_dim: int, row_bytes: int, width: int, kind: int,
            sms: int, per_sm: int) -> K2Plan:
    """K2's stream for T slots over [in_dim, row_bytes] values of kind
    `kind` (prefix_stream._KIND) decoding to `width` columns, on a card of
    `sms` SMs that hold `per_sm` of its blocks each: one slot tile of up to
    64 slots (the n8 tiles the slots need), column tiles of
    _K2_BLOCK_BYTES, and the split of the live rows that streams fastest by
    a simple model: the values' bytes, inflated while fewer blocks than SMs
    run or a last wave runs part full, plus the partial sums written and
    read again (splits x T x width f32); at most one split per stage of
    in_dim rows."""
    nn = _k2_nn(T)
    slot_tiles = -(-T // (8 * nn))
    col_tiles = -(-row_bytes // _K2_BLOCK_BYTES[kind])
    base = slot_tiles * col_tiles
    resident = sms * per_sm

    def cost(s):
        blocks = base * s
        idle = (max(1.0, sms / blocks) if blocks <= resident
                else -(-blocks // resident) * resident / blocks)
        return in_dim * row_bytes * idle + (8 * s * T * width if s > 1
                                            else 0)
    splits = min(range(1, -(-in_dim // _K2_TILE_ROWS) + 1), key=cost)
    return K2Plan(nn, slot_tiles, col_tiles, splits,
                  (splits, T, width) if splits > 1 else None)


def _k2_per_sm(kind: int, nn: int, dev) -> int:
    """Blocks of K2's stream one SM holds at once (the built kernel's
    occupancy), once per (kind, nn, card); raises if the kernel's tiling is
    not _K2_BLOCK_BYTES and _K2_TILE_ROWS."""
    key = (kind, nn, dev.index)
    if key not in _K2_PER_SM:
        f = _build.load("mxu_matvec_batch").effort_mxu_batch_blocks_per_sm
        f.argtypes, f.restype = [ctypes.c_int] * 5, ctypes.c_int
        n = f(kind, nn, _K2_BLOCK_BYTES[kind], _K2_TILE_ROWS, dev.index)
        if n < 1:
            raise RuntimeError(
                "K2's tiling differs from _K2_BLOCK_BYTES / _K2_TILE_ROWS"
                if n < 0 else f"K2's stream fits no SM (kind {kind}, nn "
                f"{nn})")
        _K2_PER_SM[key] = n
    return _K2_PER_SM[key]


def select_plan(nc: int, sms: int) -> list:
    """K1's selection grid on a card of `sms` SMs: min(nc, sms) blocks, at
    most one an SM and none without a chunk; block b owns chunks [b*nc //
    n, (b+1)*nc // n), the kernel's split. Returns those ranges."""
    n = min(nc, sms)
    return [(b * nc // n, (b + 1) * nc // n) for b in range(n)]


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
    _need_row_prefix(bm)
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


def mxu_scratch(device, in_dim: int = 0) -> dict:
    """K1's per-card scratch (see _K1_SCRATCH), u grown to at least in_dim
    rows. After a call on `device` has run, "u"[:in_dim] and "cutoff" hold
    that call's selection and the ticket (the "mass" tensor's last element
    as int32 words) is 0 again: the card tests read them from here."""
    dev = torch.device(device)
    if dev not in _K1_SCRATCH:
        _K1_SCRATCH[dev] = dict(
            mass=torch.zeros(_MAX_CHUNKS + 1, dtype=torch.float64,
                             device=dev),
            u=torch.empty(0, dtype=torch.bfloat16, device=dev),
            cutoff=torch.empty(1, dtype=torch.float32, device=dev))
    scratch = _K1_SCRATCH[dev]
    if scratch["u"].numel() < in_dim:
        scratch["u"] = torch.empty(in_dim, dtype=torch.bfloat16, device=dev)
    return scratch


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

    blocks = len(select_plan(
        nc, torch.cuda.get_device_properties(dev).multi_processor_count))
    scratch = mxu_scratch(dev, in_dim)
    c_len = torch.empty(1, dtype=torch.int32, device=dev)
    partial = torch.empty((-(-in_dim // rb), width), dtype=torch.float32,
                          device=dev)
    y = torch.empty(bm.n_buckets, dtype=torch.float32, device=dev)
    vals_ptr = bm.vals.data_ptr() + expert * in_dim * row_bytes
    scales_ptr = (bm.scales.data_ptr() + expert * in_dim * 4
                  if bm.scales is not None else None)
    _build.kernel_fn("mxu_matvec", "effort_mxu_matvec",
                     "pppppppiiiiiiiiifiippppppip")(
        vp.data_ptr(), bm.probes.data_ptr() + expert * P * 4,
        bm.stats.data_ptr() + expert * in_dim * 4, scales_ptr,
        eq.data_ptr(), tables.data_ptr(), vals_ptr,
        _KIND[bm.vals.dtype], in_dim, row_bytes, bm.n_buckets, G, nc, P,
        stride, blocks, float(tau), rb, width,
        scratch["u"].data_ptr(), c_len.data_ptr(),
        scratch["cutoff"].data_ptr(), scratch["mass"].data_ptr(),
        partial.data_ptr(), y.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["mxu_matvec"] += 1
    return (y, c_len) if return_len else y


def mxu_matvec_batch(bm: BucketedMatrix, V: torch.Tensor, efforts,
                     expert: int = 0, tau: float = None,
                     return_len: bool = False):
    """Batched row-prefix effort matmul: Y [T, OB] f32 for V [T, in] (or
    (Y, C) with the streamed chunk count C, the largest slot's, as an int32
    [1] device tensor).

    efforts: per-slot f32 efforts [T] (a float or scalar f32 tensor is
    shared by every slot; other dtypes raise). tau: coverage target,
    default the module's _TAU. No padding of T is needed.

    CPU tensors run the plain version (mxu_matvec_batch_ref); CUDA tensors
    launch the kernel, on the current stream without synchronising, or
    raise."""
    if not V.is_cuda:
        return mxu_matvec_batch_ref(bm, V, efforts, expert, tau, return_len)
    tau = _TAU if tau is None else tau
    if V.ndim != 2 or V.shape[0] < 1:
        raise ValueError(f"V {tuple(V.shape)}: want [T, in] with T >= 1")
    _check(bm, V, expert)
    dev = V.device
    Vp = bm.permute_v(V, expert).to(torch.float32).contiguous()
    T = Vp.shape[0]
    if Vp.shape[1] != bm.in_dim:
        raise ValueError(f"V {tuple(V.shape)} vs in_dim {bm.in_dim}")
    eff = slot_efforts(efforts, T, dev)
    tables = thresh_tables(dev)
    G, nc, in_dim = bm.chunk_rows, bm.n_chunks, bm.in_dim
    P = bm.probes.shape[1]
    stride = max(1, -(-in_dim // P))
    row_bytes = bm.vals.shape[2] * bm.vals.element_size()
    width = bm.vals.shape[2] * (2 if bm.vals_packed else 1)
    kind = _KIND[bm.vals.dtype]
    plan = k2_plan(T, in_dim, row_bytes, width, kind,
                   torch.cuda.get_device_properties(dev).multi_processor_count,
                   _k2_per_sm(kind, _k2_nn(T), dev))

    u = torch.empty((T, in_dim), dtype=torch.bfloat16, device=dev)
    c_slot = torch.empty(T, dtype=torch.int32, device=dev)
    cutoff = torch.empty(T, dtype=torch.float32, device=dev)
    c_len = torch.empty(1, dtype=torch.int32, device=dev)
    partial = (torch.empty(plan.partial, dtype=torch.float32, device=dev)
               if plan.partial else None)
    y = torch.empty((T, bm.n_buckets), dtype=torch.float32, device=dev)
    vals_ptr = bm.vals.data_ptr() + expert * in_dim * row_bytes
    scales_ptr = (bm.scales.data_ptr() + expert * in_dim * 4
                  if bm.scales is not None else None)
    _build.kernel_fn("mxu_matvec_batch", "effort_mxu_matvec_batch",
                     "pippppppiiiiiiiifiiippppppip")(
        Vp.data_ptr(), T, bm.probes.data_ptr() + expert * P * 4,
        bm.stats.data_ptr() + expert * in_dim * 4, scales_ptr,
        eff.data_ptr(), tables.data_ptr(), vals_ptr, kind, in_dim,
        row_bytes, bm.n_buckets, G, nc, P, stride, float(tau), plan.nn,
        plan.splits, width, u.data_ptr(), c_slot.data_ptr(),
        cutoff.data_ptr(), c_len.data_ptr(),
        partial.data_ptr() if partial is not None else None, y.data_ptr(),
        dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["mxu_matvec_batch"] += 1
    return (y, c_len) if return_len else y


# ---- K4: the rank-prefix matvec (bucket_size >= 2) -------------------------

def _select_ranks_ref(bm: BucketedMatrix, vp: torch.Tensor,
                      eff: torch.Tensor, expert: int, tau: float):
    """K4's selection: (u [K, in] f32, C [K] int32) with K1's cutoff search
    and table, n_i = #{k: stats[i, k] |v_i| > cutoff}, u[k, i] = v_i [k <
    n_i] scale[i, k], and C_k from rank k's selected masses (f64 sums)."""
    K, G, nc = bm.n_ranks, bm.chunk_rows, bm.n_chunks
    dev = vp.device
    vs = strided_sample(vp, bm.in_dim, bm.probes.shape[1])
    P = vs.shape[-1]
    scores = torch.abs(vs * bm.probes[expert].to(torch.float32))
    kq = torch.clamp(torch.round(P * eff), 1.0, float(P))
    m = torch.amax(scores) + 1e-30
    cutoff = _vec_cutoff(scores, kq, m, thresh_tables(dev))
    x = bm.stats[expert] * torch.abs(vp)[:, None]            # [in, K]
    n = (x > cutoff).sum(dim=1)
    sel = torch.arange(K, device=dev)[None, :] < n[:, None]
    zero = torch.zeros((), device=dev)
    u = torch.where(sel, vp[:, None], zero)
    if bm.scales is not None:
        u = u * bm.scales[expert]
    C = coverage_lengths(torch.where(sel, x, zero).T.reshape(K, nc, G), tau)
    return u.T.contiguous(), C


def fused_matvec_ref(bm: BucketedMatrix, v: torch.Tensor, effort,
                     expert: int = 0, tile_blocks: int = 8,
                     tau: float = None, return_selection: bool = False):
    """Plain PyTorch version of K4: its selection (_select_ranks_ref) at the
    16.16 effort, then the stream's function (prefix_stream.
    stream_product_ref). Returns y [OB*B] f32, or (y, C [K] int32, the
    selection as a StreamSelection)."""
    tau = _TAU if tau is None else tau
    K, nc = bm.n_ranks, bm.n_chunks
    vp = bm.permute_v(v, expert).to(torch.float32)
    eff = effort_q16(effort, vp.device).to(torch.float32)[0] \
        * (1.0 / 65536.0)
    u, C = _select_ranks_ref(bm, vp, eff, expert, tau)
    base = (expert * K + torch.arange(K, dtype=torch.int32,
                                      device=vp.device)) * nc
    cum = tile_offsets(C, tile_blocks)
    y = stream_product_ref(bm, u, cum, base, tile_blocks)
    if return_selection:
        return y, C, StreamSelection(cum, base,
                                     u.reshape(K, nc, bm.chunk_rows))
    return y


def fused_limits(bm: BucketedMatrix, tile_blocks: int) -> Optional[str]:
    """Why K4 cannot take this container, or None: the stream's limits
    (prefix_stream.body_limits) and those of its selection."""
    E, K, nc = bm.n_experts, bm.n_ranks, bm.n_chunks
    why = body_limits(bm, tile_blocks * bm.chunk_rows)
    if why:
        return why
    if nc % tile_blocks:
        return f"{nc} chunks not a multiple of {tile_blocks}"
    P = strided_sample_len(bm.in_dim, bm.probes.shape[1])
    if not 1 <= P <= _MAX_PROBES or tuple(bm.probes.shape) != (E, P) \
            or K * nc > _MAX_MASSES:
        return (f"probes {tuple(bm.probes.shape)} / {K} ranks of {nc} "
                f"chunks outside the selection's limits")
    for name in ("stats", "scales", "probes"):
        t = getattr(bm, name)
        if t is None:
            if name == "scales" and bm.vals.dtype == torch.bfloat16:
                continue
            return f"{name} missing"
        if t.dtype != torch.float32 or not t.is_contiguous() or (
                name != "probes" and tuple(t.shape) != (E, bm.in_dim, K)):
            return f"{name}: want contiguous f32 [{E}, {bm.in_dim}, {K}]"
    if bm.scales is not None and bm.vals.dtype == torch.bfloat16:
        return "bf16 values take no scales"
    return None


def supports_fused(bm: BucketedMatrix, tile_blocks: int = 8) -> bool:
    """Whether K4 takes this rank-prefix container (its real limits, where
    the JAX package's check is Mosaic's 128-lane rule)."""
    return bm.bucket_size >= 2 and fused_limits(bm, tile_blocks) is None


def fused_matvec(bm: BucketedMatrix, v: torch.Tensor, effort,
                 expert: int = 0, tile_blocks: int = 8, tau: float = None,
                 return_selection: bool = False):
    """Effort matvec with the selection in the kernel: y [OB*B] f32.
    bucket_size == 1 goes to mxu_matvec (K1), as in the JAX package.

    effort: a float, an f32 tensor or a 16.16 int32 tensor (effort_q16),
    read by the kernel at run time. return_selection returns (y, C, sel):
    C [K] int32, each rank's coverage length in chunks, and the selection
    (cum_tiles, base_blocks, u) as a prefix_stream.StreamSelection, which
    K5 takes; all on the device.

    CPU tensors run the plain version (fused_matvec_ref); CUDA tensors
    launch the kernel, on the current stream without synchronising, or
    raise."""
    if bm.bucket_size == 1:
        return mxu_matvec(bm, v, effort, expert, tau)
    if not v.is_cuda:
        return fused_matvec_ref(bm, v, effort, expert, tile_blocks, tau,
                                return_selection)
    tau = _TAU if tau is None else tau
    why = fused_limits(bm, tile_blocks)
    if why:
        raise ValueError(why)
    check_instance(bm, expert, v, bm.stats, bm.probes)
    dev = v.device
    vp = bm.permute_v(v, expert).to(torch.float32).contiguous()
    if vp.shape != (bm.in_dim,):
        raise ValueError(f"v {tuple(v.shape)} vs in_dim {bm.in_dim}")
    eq = effort_q16(effort, dev)
    if eq.device != dev:
        raise ValueError(f"effort on {eq.device}, v on {dev}")
    K, G, nc, in_dim = bm.n_ranks, bm.chunk_rows, bm.n_chunks, bm.in_dim
    P = bm.probes.shape[1]
    prow = bm.pos.shape[2]
    vrow = bm.vals.shape[2] * bm.vals.element_size()
    threads, col_blocks, splits = stream_plan(bm, tile_blocks)
    if dev not in _K4_SCRATCH:
        _K4_SCRATCH[dev] = torch.zeros(_MAX_MASSES + 1, dtype=torch.float64,
                                       device=dev)
    u = torch.empty((K, nc, G), dtype=torch.float32, device=dev)
    C = torch.empty(K, dtype=torch.int32, device=dev)
    cum = torch.empty(K + 1, dtype=torch.int32, device=dev)
    base = torch.empty(K, dtype=torch.int32, device=dev)
    cutoff = torch.empty(1, dtype=torch.float32, device=dev)
    partial = torch.empty((splits, bm.out_dim), dtype=torch.float32,
                          device=dev)
    y = torch.empty(bm.out_dim, dtype=torch.float32, device=dev)
    row = expert * in_dim * K * 4
    _build.kernel_fn("fused_matvec", "effort_fused_matvec",
                     "pppppppiipiiiiiiiiiiifipppppppiiipip")(
        vp.data_ptr(), bm.probes.data_ptr() + expert * P * 4,
        bm.stats.data_ptr() + row,
        bm.scales.data_ptr() + row if bm.scales is not None else None,
        eq.data_ptr(), thresh_tables(dev).data_ptr(), bm.vals.data_ptr(),
        _KIND[bm.vals.dtype], vrow, bm.pos.data_ptr(), prow, vrow,
        bm.vals.shape[0] * G, bm.bucket_size, G, nc, K, tile_blocks,
        bm.n_buckets, P,
        max(1, -(-in_dim // P)), float(tau), expert, u.data_ptr(),
        C.data_ptr(), cum.data_ptr(), base.data_ptr(), cutoff.data_ptr(),
        _K4_SCRATCH[dev].data_ptr(), partial.data_ptr(), splits, col_blocks,
        threads, y.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["fused_matvec"] += 1
    return (y, C, StreamSelection(cum, base, u)) if return_selection else y
