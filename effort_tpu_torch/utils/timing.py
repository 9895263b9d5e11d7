"""Device timing with CUDA events.

  - chain_time: the slope between two lengths of a chain of data-dependent
    iterations, which cancels the fixed launch and read-back cost.
  - fold_bounce: a chain bounce that consumes every element of y.
  - fresh_vectors: distinct inputs made on the device, one per timed call.
  - gpu_ms: the device time of one call, measured with the host ahead of
    the card so the launch cost on the host is not in the interval.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _event_s(f: Callable, args) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    f(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def chain_time(make_chain: Callable[[int], Callable], n_lo: int, n_hi: int,
               args_per_rep: Sequence[tuple], reps: int = 3) -> float:
    """Seconds per chain iteration, slope-based.

    make_chain(n) returns a callable running n dependent iterations.
    args_per_rep: one distinct args tuple per timed call (>= 2*reps + 2 of
    them); none is reused."""
    args_iter = iter(args_per_rep)
    f_lo, f_hi = make_chain(n_lo), make_chain(n_hi)
    f_lo(*next(args_iter))            # warm up
    f_hi(*next(args_iter))
    torch.cuda.synchronize()
    lo = _median([_event_s(f_lo, next(args_iter)) for _ in range(reps)])
    hi = _median([_event_s(f_hi, next(args_iter)) for _ in range(reps)])
    return max(hi - lo, 1e-9) / (n_hi - n_lo)


def fold_bounce(y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v' = v * sign(folded y): |v'| == |v|, so the next iteration's effort
    selection and read volume are unchanged, yet v' depends on every
    element of y (a bounce that slices y lets unused columns go unread).
    y: [..., N_out]; v: [..., N_in]."""
    n_in, n_out = v.shape[-1], y.shape[-1]
    k = -(-n_out // n_in)
    pad = k * n_in - n_out
    if pad:
        y = torch.cat([y, y.new_zeros(y.shape[:-1] + (pad,))], dim=-1)
    folded = y.reshape(y.shape[:-1] + (k, n_in)).sum(dim=-2)
    return v * torch.where(folded >= 0, 1.0, -1.0)


def fresh_vectors(shape, n: int, seed0: int = 1234, scale: float = 1.0,
                  device="cuda") -> list:
    """n distinct f32 inputs made on the device."""
    out = []
    for i in range(n):
        g = torch.Generator(device=device)
        g.manual_seed(seed0 + i)
        out.append(torch.randn(shape, generator=g, device=device) * scale)
    return out


def gpu_ms(f: Callable, args: tuple, flush: torch.Tensor = None,
           lead_cycles: int = 2_000_000) -> float:
    """Device milliseconds of f(*args) on the current stream.

    A busy-wait kernel of lead_cycles runs first, so the host has queued
    the start event, f's launches and the end event before the card
    reaches them, and the interval holds device time only. `flush`, when
    given, is overwritten first to evict the 50 MB L2, as a decode step
    finds the weights of its next matrix cold."""
    if flush is not None:
        flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(lead_cycles)
    start.record()
    f(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)
