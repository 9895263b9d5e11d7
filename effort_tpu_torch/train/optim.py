"""The trainer's optimizer: the port's own copy of the optax chain the JAX
package's trainer builds (effort_tpu/train/trainer.py:250-256),

    chain(clip_by_global_norm(clip_norm),
          adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps,
                                             0.1 * lr),
                weight_decay, mu_dtype=...))

with optax's arithmetic step for step (optax 0.2.6):
  - the schedule reads the step count BEFORE it is incremented, and the
    count starts at 0, so the first update has lr 0 and changes nothing,
    weight decay included; past `steps` it holds the end value;
  - the clip scales by max_norm / norm only when the global norm is >=
    max_norm, with no epsilon (torch.nn.utils.clip_grad_norm_ adds 1e-6);
  - Adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected moments;
    the update reads the f32 first moment, which is cast to mu_dtype only
    for storage afterwards;
  - decoupled weight decay on every parameter (optax's mask=None: norms
    and embeddings too), then the update scaled by -lr.

Everything stays on the parameters' device: the count is a 0-d int32
tensor and the learning rate a 0-d f32 tensor computed from it, so a step
reads nothing back to the host. torch.optim.AdamW is not used: it cannot
hold the first moment in bfloat16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# b1 as optax applies it to the stored first moment: JAX rounds the weakly
# typed constant to the moment's dtype (0.9 -> 0.8984375 in bfloat16)
_B1_IN = {dt: float(torch.tensor(B1, dtype=dt)) for dt in _DTYPES.values()}


def warmup_cosine_decay(count: torch.Tensor, peak: float, warmup: int,
                        steps: int, end: float) -> torch.Tensor:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, steps, end) at
    `count` (an int32 tensor), in float32: linear from 0 to peak over
    `warmup` steps, then a cosine from peak to end over steps - warmup
    steps, then end."""
    if steps - warmup <= 0:
        raise ValueError(f"the cosine needs steps > warmup ({steps}, "
                         f"{warmup})")
    if warmup > 0:
        frac = 1 - count.clamp(0, warmup).to(torch.float32) / warmup
        linear = (0.0 - peak) * frac + peak
    else:
        linear = torch.zeros_like(count, dtype=torch.float32)
    alpha = 0.0 if peak == 0.0 else end / peak
    decay = float(steps - warmup)
    t = (count - warmup).to(torch.float32).clamp(max=decay)
    cosine = 0.5 * (1 + torch.cos(math.pi * t / decay))
    return torch.where(count < warmup, linear,
                       peak * ((1 - alpha) * cosine + alpha))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.stack([(g * g).sum() for g in grads]).sum().sqrt()


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: each g becomes g / norm *
    max_norm when norm >= max_norm. Returns the norm before clipping."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor            # 0-d int32: updates applied so far
    mu: List[torch.Tensor]         # first moments, mu_dtype
    nu: List[torch.Tensor]         # second moments, f32


def adamw_init(params: List[torch.Tensor],
               mu_dtype: str = "float32") -> AdamWState:
    dev = params[0].device
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros_like(p, dtype=_DTYPES[mu_dtype]) for p in params],
        nu=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 state: AdamWState, lr: torch.Tensor,
                 weight_decay: float) -> None:
    """One optax adamw update of `params` in place; `lr` is the schedule's
    value at state.count (before this update)."""
    count = state.count + 1
    bc1 = 1 - torch.pow(B1, count)
    bc2 = 1 - torch.pow(B2, count)
    neg_lr = -lr
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        # optax.tree.update_moment: (1 - b) * g**order + b * moment, the
        # product b * moment in the moment's own dtype
        mu = (1 - B1) * g + _B1_IN[m.dtype] * m
        nu = (1 - B2) * (g * g) + B2 * v
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        u = u + weight_decay * p
        p.add_(neg_lr * u)
        m.copy_(mu)
        v.copy_(nu)
    state.count.copy_(count)
