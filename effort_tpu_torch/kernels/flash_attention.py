"""Blockwise (flash) causal attention for prefill: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces the TPU kernel effort_tpu/kernels/flash_attention.py:
flash_attention -> _kernel, in csrc/flash_attention.cu. GQA is folded per
KV head (each K/V tile serves the rep query heads that share it); masks are
slot-based, so left-padded prompts work: query t sits at cache slot
start_slot + t and sees slots in [mask_from, start_slot + t], and with
window > 0 only the last `window` of them. Q is rounded to bf16, scores and
the softmax are f32, P@V keeps the probabilities to about 24 bits (pv_f32,
three bf16 parts) or takes them rounded to bf16; a query with no live key
gets 0. Both products run on the tensor cores; the launch shape comes from
flash_plan.

start_slot and mask_from are ints or 0-d int32 tensors on the card. The
kernel reads both from device memory, as the TPU kernel reads them from its
scalar-prefetch array: a tensor through its own address, an int through its
entry of the card's table of ints (prefix_stream.instance_ptr), so the two
forms run one code path, and a captured launch reads a device position anew
at every replay. Ints are checked on the host; a tensor is not read (the
kernel clamps it at 0; callers check lengths on the host). The launch shape
depends only on T, rep, KV and the card.

The public functions keep the JAX package's layouts: flash_attention takes
Q [KV, rep, T, D] and K, V [KV, S, D]; flash_attention_seq is the
forward_seq adapter, Q2 [T, H*D] against the layer's caches [S, KV, D]. On
the card both hand the kernel their tensors in place, through strides.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from effort_tpu_torch.kernels import LAUNCHES, _build
from effort_tpu_torch.kernels.prefix_stream import instance_ptr

LAUNCHES["flash_attention"] = 0
_MAX_D = 256
_MAX_REP = 64


class FlashPlan(NamedTuple):
    """K3's launch shape: rw row warps a block (16 score rows each; block
    row r is query head r // bq, query qb*bq + r % bq: rep * bq <= 16 * rw
    rows), kw key warps (2 or 4) for each (splitting the keys of every
    group of tiles between them; rw * kw <= 8), and the grid (q_blocks,
    kv)."""
    rw: int
    kw: int
    bq: int
    q_blocks: int
    kv: int

    @property
    def blocks(self) -> int:
        return self.q_blocks * self.kv


def flash_plan(T: int, rep: int, KV: int, sms: int) -> FlashPlan:
    """The most row warps a block (4, 2 or 1; at least rep/16 of them, so a
    block holds every query head of its KV head) that still gives a card
    of `sms` SMs a block each, the fewest where none does: fewer row warps
    mean fewer rows sharing each K/V tile but more blocks at small T (at T
    = 64, rep = 4, KV = 8 every row warp is a block: 128 blocks). Then key
    warps up to 8 warps a block (2 or 4 a row warp): a lone warp hides
    no latency, and its block's copies are issued by 32 threads. On an
    H100 this plan is the fastest, or within 5% of it, of all the plans
    the kernel takes at each of chip_smoke.py's attention cases
    (scripts/torch_k3_plans.py)."""
    if not 1 <= rep <= _MAX_REP:
        raise ValueError(f"flash_attention: rep {rep} outside 1..{_MAX_REP}")
    for rw in (w for w in (4, 2, 1) if 16 * w >= rep):
        bq = 16 * rw // rep
        if -(-T // bq) * KV >= sms:
            break
    return FlashPlan(rw, min(4, 8 // rw), bq, -(-T // bq), KV)


def flash_limits(D: int):
    """Why the kernel cannot take heads D wide, or None (the plain version
    takes any D, as JAX's kernel does)."""
    if not (8 <= D <= _MAX_D and D % 8 == 0):
        return (f"flash_attention: head_dim {D} outside the kernel's limits "
                f"(a multiple of 8 from 8 to {_MAX_D})")
    return None


def flash_attention_ref(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                        start_slot, mask_from=0, window: int = 0,
                        pv_f32: bool = True) -> torch.Tensor:
    """Plain PyTorch version: Q [KV, rep, T, D] (rounded to bf16), K and V
    [KV, S, D] -> [KV, rep, T, D] f32. Masked softmax in f32, fully masked
    rows 0. start_slot, mask_from: ints or 0-d int tensors (read on the
    device, the same result)."""
    T, D = Q.shape[2], Q.shape[3]
    S = K.shape[1]
    dev = Q.device
    q = Q.to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("krtd,ksd->krts", q, K.to(torch.float32)) \
        * (float(D) ** -0.5)
    q_slot = start_slot + torch.arange(T, device=dev)[:, None]
    k_slot = torch.arange(S, device=dev)[None, :]
    live = (k_slot <= q_slot) & (k_slot >= mask_from)
    if window:
        live &= k_slot > q_slot - window
    s = torch.where(live, s, torch.full_like(s, -math.inf))
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    if not pv_f32:
        p = p.to(torch.bfloat16).to(torch.float32)
    out = torch.einsum("krts,ksd->krtd", p, V.to(torch.float32))
    return out / torch.clamp(l, min=1e-30)


def _slot_ptr(name: str, x, dev) -> int:
    """The device address the kernel reads `name` from: a 0-d int32
    tensor's on `dev` (not read), or a non-negative int's entry of the
    card's table of ints."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32 or x.numel() != 1 or x.device != dev:
            raise ValueError(f"flash_attention: {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}: want one "
                             f"int32 on {dev}")
        return x.data_ptr()
    if int(x) < 0:
        raise ValueError(f"flash_attention: negative {name}")
    return instance_ptr(int(x), dev)


def _launch(q, q_strides, k, k_strides, v, v_strides, out, o_strides,
            KV: int, rep: int, T: int, S: int, D: int, start_slot,
            mask_from, window: int, pv_f32: bool) -> None:
    """Checks what the kernel takes, then one launch on the current stream.
    Strides are element strides: q/out (kv, rep, t), k/v (kv, s).
    start_slot, mask_from: ints or 0-d int32 tensors on the card."""
    dev = q.device
    why = flash_limits(D)
    if why:
        raise ValueError(why)
    if q.dtype != torch.float32 or out.dtype != torch.float32:
        raise ValueError("flash_attention: q and out must be f32")
    for name, t, st in (("q", q, q_strides), ("out", out, o_strides)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(x % 4 for x in st):
            raise ValueError(f"flash_attention: {name} rows must be "
                             f"contiguous and 16-byte aligned")
    for name, t, st in (("k", k, k_strides), ("v", v, v_strides)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bf16, got "
                             f"{t.dtype}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(x % 8 for x in st):
            raise ValueError(f"flash_attention: {name} rows must be "
                             f"contiguous and 16-byte aligned")
    for t in (q, k, v, out):
        if t.device != dev:
            raise ValueError(f"flash_attention: tensors on {t.device} and "
                             f"{dev}")
    if window < 0:
        raise ValueError("flash_attention: negative window")
    slots = (_slot_ptr("start_slot", start_slot, dev),
             _slot_ptr("mask_from", mask_from, dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = flash_plan(T, rep, KV, sms)
    _build.kernel_fn("flash_attention", "effort_flash_attention",
                     "plllpllpllplll" + "i" * 8 + "ppii" + "fip")(
        q.data_ptr(), *q_strides, k.data_ptr(), *k_strides, v.data_ptr(),
        *v_strides, out.data_ptr(), *o_strides, KV, rep, T, S, D,
        plan.rw, plan.kw, plan.bq, *slots, int(window),
        int(bool(pv_f32)), float(D) ** -0.5, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["flash_attention"] += 1


def flash_attention(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                    start_slot, mask_from=0, window: int = 0,
                    pv_f32: bool = True) -> torch.Tensor:
    """Q [KV, rep, T, D]; K, V [KV, S, D] bf16. Returns [KV, rep, T, D]
    f32. window > 0 limits each query to the last `window` slots.
    start_slot, mask_from: ints or 0-d int32 tensors on Q's device.

    CPU tensors run the plain version (flash_attention_ref); CUDA tensors
    launch the kernel, on the current stream without synchronising, or
    raise."""
    if not Q.is_cuda:
        return flash_attention_ref(Q, K, V, start_slot, mask_from, window,
                                   pv_f32)
    KV, rep, T, D = Q.shape
    S = K.shape[1]
    q = Q.to(torch.float32)
    out = torch.empty((KV, rep, T, D), dtype=torch.float32, device=Q.device)
    _launch(q, q.stride()[:3], K, K.stride()[:2], V, V.stride()[:2], out,
            out.stride()[:3], KV, rep, T, S, D, start_slot, mask_from,
            window, pv_f32)
    return out


def flash_attention_seq(Q2: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, start_slot, mask_from,
                        n_heads: int, head_dim: int,
                        window: int = 0, pv_f32: bool = True,
                        plain: bool = False) -> torch.Tensor:
    """Adapter for forward_seq: Q2 [T, H*D] (RoPE'd; q head h uses kv head
    h // rep), caches [S, KV, D] -> [T, H*D] f32. plain=True runs the plain
    version on any device (the kernel's semantics without the kernel).
    start_slot, mask_from: ints or 0-d int32 tensors on Q2's device."""
    T = Q2.shape[0]
    S, KV, D = k_cache.shape
    rep = n_heads // KV
    if D != head_dim:
        raise ValueError(f"cache head_dim {D} vs {head_dim}")
    if plain or not Q2.is_cuda:
        Q = Q2.reshape(T, KV, rep, D).permute(1, 2, 0, 3)
        out = flash_attention_ref(Q, k_cache.permute(1, 0, 2),
                                  v_cache.permute(1, 0, 2), start_slot,
                                  mask_from, window, pv_f32)
        return out.permute(2, 0, 1, 3).reshape(T, n_heads * D)
    q = Q2.to(torch.float32)
    if q.stride(-1) != 1 or q.stride(0) % 4 or q.data_ptr() % 16:
        q = q.contiguous()
    out = torch.empty((T, n_heads * D), dtype=torch.float32, device=Q2.device)
    _launch(q, (rep * D, D, q.stride(0)),
            k_cache, (k_cache.stride(1), k_cache.stride(0)),
            v_cache, (v_cache.stride(1), v_cache.stride(0)),
            out, (rep * D, D, n_heads * D), KV, rep, T, S, D, start_slot,
            mask_from, window, pv_f32)
    return out
