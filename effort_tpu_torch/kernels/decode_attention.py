"""Decode attention over the live rows of a bf16 KV cache (K8): the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces no TPU kernel: the JAX package's decode attention is XLA
(effort_tpu/models/transformer.py:205). The plain version, attn_core, is
the arithmetic the port ran before the kernel, and still runs for the int8
and ring caches: every slot of the cache widened to f32, the scores, a
mask, a softmax over all of them and a second f32 product. Its time grew
with the cache, not with the positions a slot attends over. The kernel
(csrc/decode_attention.cu) reads the bf16 caches in place, each slot's live
rows only, with f32 arithmetic throughout; its bound is the live rows'
bytes.

One query token a slot: q [B, H*D] f32 against k, v [B, S, KV, D] bf16
(the chat step passes a layer's [S, KV, D] as B = 1). Slot b sees cache
rows [max(mask_from[b], pos[b] - window + 1), pos[b]] (no window when it
is 0), one contiguous range, as models/transformer._live_slots defines
it; a slot with none gets 0. pos and mask_from are [B] int32 tensors on the
card, read by the kernel and never by the host, so a captured step replays
the launch as the positions move; with B = 1 each may also be an int or a
0-d int32 tensor.

Route: callers check decode_limits before calling (the chat step and the
batched step in models/transformer.py, for bf16 caches only); on CUDA
tensors the wrapper launches the kernel or raises, on CPU tensors it runs
the plain version.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from effort_tpu_torch.kernels import LAUNCHES, _build
from effort_tpu_torch.kernels.prefix_stream import instance_ptr

LAUNCHES["decode_attention"] = 0
_MAX_D = 256
_MAX_REP = 64
_MAX_REPG = 8          # query heads a block
_MAX_CHUNKS = 128      # chunks a slot (csrc kMaxParts)
_MAX_ROWS = 65535      # slots x KV heads x head groups: the grid's y
# a launch's blocks at the whole cache, per SM: the chunks shrink until the
# grid holds about this many (one slot's few heads get short chunks that
# fill the card, many slots long ones)
_BLOCKS_PER_SM = 8
_TICKETS: dict = {}    # (card, stream) -> tickets


def attn_core(q, kf, vf, live, KV: int, rep: int, D: int) -> torch.Tensor:
    """Masked-softmax attention read for one query token per slot; leading
    axes are slots. q [..., H*D]; kf/vf [..., S, KV, D] f32; live [..., S]
    bool. A slot with no live slot gets NaN (the softmax of nothing)."""
    lead = q.shape[:-1]
    qh = q.reshape(*lead, KV, rep, D).to(torch.float32)
    scores = torch.einsum("...krd,...tkd->...krt", qh, kf) / math.sqrt(D)
    scores = torch.where(live[..., None, None, :], scores,
                         torch.full_like(scores, -math.inf))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("...krt,...tkd->...krd", probs, vf)
    return out.reshape(*lead, KV * rep * D)


def decode_limits(D: int, rep: int):
    """Why the kernel cannot take heads D wide shared rep ways, or None."""
    if not (8 <= D <= _MAX_D and D % 8 == 0):
        return (f"decode_attention: head_dim {D} outside the kernel's "
                f"limits (a multiple of 8 from 8 to {_MAX_D})")
    if not 1 <= rep <= _MAX_REP:
        return f"decode_attention: rep {rep} outside 1..{_MAX_REP}"
    return None


class DecodePlan(NamedTuple):
    """K8's launch shape: repg query heads a block (groups of them a KV
    head), tiles of `tile` rows, chunks of chunk_tiles tiles, n_chunks
    chunks covering the cache."""
    repg: int
    groups: int
    tile: int
    chunk_tiles: int
    n_chunks: int

    @property
    def chunk(self) -> int:
        return self.tile * self.chunk_tiles


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def head_groups(rep: int) -> int:
    """The blocks that load a KV head's rows: its rep query heads in
    groups of up to _MAX_REPG, each group's block loading them again."""
    return -(-rep // min(_MAX_REPG, _pow2_at_least(rep)))


def decode_plan(B: int, KV: int, rep: int, S: int, D: int,
                sms: int) -> DecodePlan:
    """The chunks a launch over B slots of S rows takes: the shortest
    (whole tiles, doubling from two: a chunk's partial and its share of the
    combine cost about what a tile does) that keep the grid within
    _BLOCKS_PER_SM blocks an SM at the whole cache and within _MAX_CHUNKS
    chunks a slot. On an H100 this is the fastest chunk length, or within
    10% of it, at scripts/torch_k8_plans.py's cases.
    Tiles hold 8192 elements of a side (64 rows of 128-wide heads), at
    most 128 rows and at least one step of each of the block's 8 warps
    (csrc tile_rows)."""
    repg = min(_MAX_REPG, _pow2_at_least(rep))
    groups = head_groups(rep)
    D2 = max(8, _pow2_at_least(D))
    tile = max(8192 // D2 if D2 >= 64 else 128, 2048 // D2)
    n_tiles = -(-S // tile)
    rows = B * KV * groups
    ct = min(2, n_tiles)
    while ct < n_tiles and (rows * -(-n_tiles // ct) > _BLOCKS_PER_SM * sms
                            or -(-n_tiles // ct) > _MAX_CHUNKS):
        ct *= 2
    return DecodePlan(repg, groups, tile, ct, -(-n_tiles // ct))


def live_rows(pos: int, mask_from: int, window: int, S: int) -> int:
    """The cache rows a slot at position pos attends over: [max(mask_from,
    pos - window + 1), min(pos, S - 1)]. The kernel loads these rows and
    no others (a live chunk's block copies its rows outside the range as
    zeros, reading nothing), once a head group (head_groups)."""
    lo = max(mask_from, 0, pos - window + 1 if window else 0)
    return max(0, min(pos, S - 1) - lo + 1)


def _as_slots(x, B: int, dev) -> torch.Tensor:
    """pos or mask_from as a [B] integer tensor on dev (the plain
    version's form)."""
    t = torch.as_tensor(x, device=dev).reshape(-1)
    return t.expand(B) if t.numel() == 1 else t


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos, mask_from=0, window: int = 0) -> torch.Tensor:
    """Plain PyTorch version: q [B, H*D], k/v [B, S, KV, D] -> [B, H*D]
    f32, through attn_core on the widened caches; slots with no live row
    0."""
    B, S, KV, D = k.shape
    rep = q.shape[-1] // (KV * D)
    t = torch.arange(S, device=q.device)
    p = _as_slots(pos, B, q.device)[:, None]
    live = (t <= p) & (t >= _as_slots(mask_from, B, q.device)[:, None])
    if window:
        live &= t > p - window
    out = attn_core(q, k.to(torch.float32), v.to(torch.float32), live, KV,
                    rep, D)
    return torch.where(live.any(dim=-1, keepdim=True), out,
                       torch.zeros_like(out))


def _ints_ptr(name: str, x, B: int, dev) -> int:
    """The device address of B int32 the kernel reads: a contiguous int32
    tensor's of B elements on dev (not read), or with B = 1 a
    non-negative int's entry of the card's table of ints."""
    if isinstance(x, torch.Tensor):
        if (x.dtype != torch.int32 or x.numel() != B or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"decode_attention: {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}: want {B} "
                             f"contiguous int32 on {dev}")
        return x.data_ptr()
    if B != 1:
        raise ValueError(f"decode_attention: {name} must be a [{B}] int32 "
                         f"tensor")
    if int(x) < 0:
        raise ValueError(f"decode_attention: negative {name}")
    return instance_ptr(int(x), dev)


def _tickets(dev, stream) -> torch.Tensor:
    """The tickets of launches on `stream`: int32 zeros, one for each
    (slot, KV head, head group) of a launch, left zero by the kernel; made
    at a stream's first launch (256 KiB). Launches on one stream run in
    order, so none shares its tickets with another running beside it. A
    captured launch keeps the capture stream's: two graphs that launch K8
    replayed at once on two streams would share them, as K1's and K4's
    selection scratch would (the port replays its steps on one stream)."""
    key = (dev, stream.cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(_MAX_ROWS, dtype=torch.int32,
                                    device=dev)
    return _TICKETS[key]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, mask_from=0, window: int = 0) -> torch.Tensor:
    """q [B, H*D] f32 (H a multiple of KV); k, v [B, S, KV, D] bf16, the
    head axis contiguous. pos, mask_from: [B] int32 tensors on the card
    (or, with B = 1, ints or 0-d int32 tensors). Returns [B, H*D] f32.

    CPU tensors run the plain version (decode_attention_ref); CUDA tensors
    launch the kernel, on the current stream without synchronising, or
    raise."""
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, pos, mask_from, window)
    dev = q.device
    B, S, KV, D = k.shape
    HD = q.shape[-1]
    if q.ndim != 2 or q.shape[0] != B or HD % (KV * D):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"caches {tuple(k.shape)}")
    rep = HD // (KV * D)
    why = decode_limits(D, rep)
    if why:
        raise ValueError(why)
    if q.dtype != torch.float32:
        raise ValueError(f"decode_attention: q must be f32, got {q.dtype}")
    if q.stride(-1) != 1 or q.stride(0) % 4 or q.data_ptr() % 16:
        raise ValueError("decode_attention: q rows must be contiguous and "
                         "16-byte aligned")
    if v.shape != k.shape:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention: {name} must be bf16, got "
                             f"{t.dtype}")
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"decode_attention: {name} rows must be "
                             f"contiguous and 16-byte aligned")
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"decode_attention: tensors on {t.device} and "
                             f"{dev}")
    if window < 0:
        raise ValueError("decode_attention: negative window")
    slots = (_ints_ptr("pos", pos, B, dev),
             _ints_ptr("mask_from", mask_from, B, dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = decode_plan(B, KV, rep, S, D, sms)
    rows = B * KV * plan.groups
    if rows > _MAX_ROWS:
        raise ValueError(f"decode_attention: {B} slots x {KV} KV heads x "
                         f"{plan.groups} head groups past {_MAX_ROWS}")
    out = torch.empty((B, HD), dtype=torch.float32, device=dev)
    part = (torch.empty(rows * plan.n_chunks * plan.repg * (2 + D),
                        dtype=torch.float32, device=dev)
            if plan.n_chunks > 1 else None)
    stream = torch.cuda.current_stream(dev)
    _build.kernel_fn("decode_attention", "effort_decode_attention",
                     "plplllplllplpp" + "i" * 10 + "ppip")(
        q.data_ptr(), q.stride(0), k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], out.data_ptr(), out.stride(0),
        *slots, B, KV, rep, S, D, int(window), plan.repg, plan.tile,
        plan.chunk_tiles, plan.n_chunks,
        0 if part is None else part.data_ptr(),
        _tickets(dev, stream).data_ptr(), dev.index, stream.cuda_stream)
    LAUNCHES["decode_attention"] += 1
    return out
