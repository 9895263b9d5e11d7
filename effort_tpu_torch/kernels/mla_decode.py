"""Decode attention of multi-head latent attention in absorbed form (K9):
the CUDA kernel's wrapper and its plain PyTorch version.

Replaces no TPU kernel: the JAX package has no latent attention. DeepSeek-V2
caches one row a position and layer, [c | k_pe] (the normalised latent and
the shared rotary key, kv_lora_rank + qk_rope_head_dim wide, bf16), and its
absorbed decode (models/mla.py) gives every query head h the query [W_UK[h]
q_nope[h] | q_pe[h]] over those rows, whose first kv_lora_rank columns are
also the value. This module computes that attention:

  q [B, H, W] f32 against cache [B, S, W] bf16 -> [B, H, R] f32, where slot b
  sees rows [max(mask_from[b], 0), min(pos[b], S - 1)], s = scale * q . row,
  out = softmax(s) @ rows[:, :R]; a slot with no live row gets 0.

The kernel (csrc/mla_decode.cu) reads each live row once for all H heads,
f32 throughout; it takes DeepSeek-V2's widths (mla_limits). pos and mask_from
are [B] int32 tensors on the card (with B = 1 also ints or 0-d int32
tensors), read by the kernel and never by the host, so a captured step
replays the launch as the position moves. On CPU tensors the wrapper runs
the plain version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from effort_tpu_torch.kernels import LAUNCHES, _build
from effort_tpu_torch.kernels.decode_attention import _ints_ptr

LAUNCHES["mla_decode"] = 0
_HEADS, _WIDTH, _VALUE = 16, 576, 512   # csrc kHeads, kWidth, kValue
_TILE = 16                              # rows a tile (csrc kTile)
# a chunk's fewest tiles: 1 was as fast as 2, 4 and 8 or faster at 256, 1024
# and 4096 live rows on an H100 (scripts/torch_k9_times.py)
_MIN_TILES = 1
_MAX_BLOCKS = 1024                      # csrc kMaxChunks


def mla_limits(H: int, W: int, R: int):
    """Why the kernel cannot take H heads over W-wide rows whose first R
    columns are the value, or None."""
    if (H, W, R) != (_HEADS, _WIDTH, _VALUE):
        return (f"mla_decode: {H} heads over rows {W} wide, value {R}: the "
                f"kernel takes {_HEADS} heads over {_WIDTH}-wide rows, value "
                f"{_VALUE} (DeepSeek-V2's)")
    return None


class MlaPlan(NamedTuple):
    """K9's launch shape: `blocks` chunks a slot at most, each at least
    min_tiles tiles of 16 rows; the kernel cuts each slot's live range into
    chunks itself, from its position."""
    blocks: int
    min_tiles: int


def mla_plan(S: int, sms: int) -> MlaPlan:
    """One block an SM at most, and no more than the cache holds chunks of
    _MIN_TILES tiles."""
    tiles = -(-S // _TILE)
    return MlaPlan(max(1, min(sms, -(-tiles // _MIN_TILES), _MAX_BLOCKS)),
                   _MIN_TILES)


def mla_decode_ref(q: torch.Tensor, cache: torch.Tensor, pos, mask_from=0,
                   scale: float = 1.0, R: int = _VALUE) -> torch.Tensor:
    """Plain PyTorch version: q [B, H, W], cache [B, S, W] -> [B, H, R]
    f32, every row of the cache widened to f32 and masked; slots with no
    live row 0."""
    B, S, W = cache.shape
    c = cache.to(torch.float32)
    t = torch.arange(S, device=q.device)
    p = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    mf = torch.as_tensor(mask_from, device=q.device).reshape(-1, 1)
    live = ((t <= p) & (t >= mf)).expand(B, S)
    s = torch.einsum("bhw,bsw->bhs", q.to(torch.float32), c) * scale
    s = torch.where(live[:, None, :], s, torch.full_like(s, -torch.inf))
    out = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c[..., :R])
    return torch.where(live.any(dim=-1)[:, None, None], out,
                       torch.zeros_like(out))


def mla_decode(q: torch.Tensor, cache: torch.Tensor, pos, mask_from=0,
               scale: float = 1.0, R: int = _VALUE) -> torch.Tensor:
    """q [B, H, W] f32 (a slot's heads contiguous); cache [B, S, W] bf16,
    rows contiguous and 16-byte aligned. pos, mask_from: [B] int32 tensors
    on the card (or, with B = 1, ints or 0-d int32 tensors). Returns [B, H,
    R] f32.

    CPU tensors run the plain version (mla_decode_ref); CUDA tensors launch
    the kernel, on the current stream without synchronising, or raise."""
    if not q.is_cuda:
        return mla_decode_ref(q, cache, pos, mask_from, scale, R)
    dev = q.device
    if q.ndim != 3 or cache.ndim != 3 or q.shape[0] != cache.shape[0] \
            or q.shape[2] != cache.shape[2]:
        raise ValueError(f"mla_decode: q {tuple(q.shape)} against the cache "
                         f"{tuple(cache.shape)}")
    B, H, W = q.shape
    S = cache.shape[1]
    why = mla_limits(H, W, R)
    if why:
        raise ValueError(why)
    if q.dtype != torch.float32:
        raise ValueError(f"mla_decode: q must be f32, got {q.dtype}")
    if (q.stride(2) != 1 or q.stride(1) != W or q.stride(0) % 2
            or q.data_ptr() % 8):
        raise ValueError("mla_decode: q's heads must be contiguous and "
                         "8-byte aligned")
    if cache.dtype != torch.bfloat16:
        raise ValueError(f"mla_decode: the cache must be bf16, got "
                         f"{cache.dtype}")
    if (cache.stride(2) != 1 or cache.data_ptr() % 16
            or cache.stride(1) % 8 or cache.stride(0) % 8):
        raise ValueError("mla_decode: cache rows must be contiguous and "
                         "16-byte aligned")
    if cache.device != dev:
        raise ValueError(f"mla_decode: tensors on {cache.device} and {dev}")
    slots = (_ints_ptr("pos", pos, B, dev),
             _ints_ptr("mask_from", mask_from, B, dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = mla_plan(S, sms)
    out = torch.empty((B, H, R), dtype=torch.float32, device=dev)
    part = (torch.empty(B * plan.blocks * H * (2 + R), dtype=torch.float32,
                        device=dev) if plan.blocks > 1 else None)
    stream = torch.cuda.current_stream(dev)
    _build.kernel_fn("mla_decode", "effort_mla_decode",
                     "plpllplppiifiipip")(
        q.data_ptr(), q.stride(0), cache.data_ptr(), cache.stride(0),
        cache.stride(1), out.data_ptr(), out.stride(0), *slots, B, S,
        float(scale), plan.blocks, plan.min_tiles,
        0 if part is None else part.data_ptr(), dev.index,
        stream.cuda_stream)
    LAUNCHES["mla_decode"] += 1
    return out
