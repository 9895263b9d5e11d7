"""Generation loop: greedy decode with per-step predictions.

The decode loop runs on the device end to end: the token ids, the
predictions and the end-of-sequence flag live in device tensors, and
nothing is read back until the loop ends, so the host never waits for the
card inside it. Effort is converted once per call into the kernels' 16.16
fixed-point device tensor.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.models.transformer import (ModelWeights, forward_token,
                                                 make_kv_cache,
                                                 resolve_device)
from effort_tpu_torch.ops.effort import effort_q16


@dataclasses.dataclass
class Reply:
    token_ids: list
    predictions: list          # argmax id after every consumed position
    text: str = ""
    tokens_per_s: float = 0.0
    eval_ms_per_token: float = 0.0


def _pick_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy choice (first index among ties)."""
    return torch.argmax(logits).to(torch.int32)


def _decode(w: ModelWeights, cfg: ModelConfig, prompt_ids: torch.Tensor,
            prompt_len: int, n_new: int, effort, impl: str, eos_id: int):
    """prompt_ids: [P] int32 padded on the device. Feeds the prompt, then
    writes each prediction at pos >= prompt_len-1 into the id buffer until
    EOS. Returns (all_ids [P+n_new], preds [P+n_new-1]) on the device."""
    P = prompt_ids.shape[0]
    dev = prompt_ids.device
    total = P + n_new
    k_cache, v_cache = make_kv_cache(cfg, dev)
    ids = torch.cat([prompt_ids,
                     torch.zeros(n_new, dtype=torch.int32, device=dev)])
    preds = torch.empty(total - 1, dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for pos in range(total - 1):
        logits = forward_token(w, cfg, ids[pos], pos, k_cache, v_cache,
                               effort=effort, impl=impl)
        pred = _pick_token(logits)
        preds[pos] = pred
        if pos >= prompt_len - 1:          # generating from here on
            ids[pos + 1] = torch.where(done, ids[pos + 1], pred)
            done = done | (pred == eos_id)
    return ids, preds


class Engine:
    """Holds the weights and runs greedy generation on one device.

    impl: "auto" (dense copy at effort >= 0.999 when present, the kernel
    otherwise), "kernel", "reference" or "dense" (ops/bucketmul.py).
    device: the card unless named; weights are moved there."""

    def __init__(self, weights: ModelWeights, cfg: ModelConfig,
                 tokenizer=None, impl: str = "auto", eos_id: int = 2,
                 pad_to: int = 32, device=None):
        self.device = resolve_device(device)
        self.w = weights.to(self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.impl = impl
        self.eos_id = eos_id
        self.pad_to = pad_to

    def _effort_arg(self, effort: float):
        """A python float where the dense fast path may take it, else the
        16.16 device tensor, made once for the whole call."""
        has_dense = self.w.layers.wo.dense is not None
        if (effort >= 0.999 and has_dense
                and self.impl in ("auto", "dense")) or self.impl == "dense":
            return float(effort)
        return effort_q16(float(effort), self.device)

    def generate(self, prompt_ids: Sequence[int], n_new: int = 30,
                 effort: float = 1.0) -> Reply:
        """Greedy continuation of prompt_ids by n_new tokens at `effort`
        (stops early at eos_id). The prompt is padded to a multiple of
        pad_to, as the JAX engine pads it."""
        P = max(self.pad_to,
                -(-len(prompt_ids) // self.pad_to) * self.pad_to)
        if P + n_new > self.cfg.max_seq_len:
            raise ValueError(f"{P} + {n_new} positions exceed max_seq_len "
                             f"{self.cfg.max_seq_len}")
        padded = list(prompt_ids) + [0] * (P - len(prompt_ids))
        t0 = time.perf_counter()
        ids = torch.tensor(padded, dtype=torch.int32, device=self.device)
        ids, preds = _decode(self.w, self.cfg, ids, len(prompt_ids), n_new,
                             self._effort_arg(effort), self.impl,
                             self.eos_id)
        ids, preds = ids.cpu().tolist(), preds.cpu().tolist()
        dt = time.perf_counter() - t0
        new_ids = ids[len(prompt_ids):len(prompt_ids) + n_new]
        if self.eos_id in new_ids:
            new_ids = new_ids[:new_ids.index(self.eos_id) + 1]
        text = (self.tokenizer.decode(new_ids)
                if self.tokenizer is not None else "")
        n_steps = P + n_new - 1
        return Reply(token_ids=new_ids, predictions=preds, text=text,
                     tokens_per_s=n_steps / dt,
                     eval_ms_per_token=dt / n_steps * 1e3)


def generate(weights, cfg, prompt_ids, n_new=30, effort=1.0, impl="auto",
             tokenizer=None, device=None) -> Reply:
    return Engine(weights, cfg, tokenizer=tokenizer, impl=impl,
                  device=device).generate(prompt_ids, n_new=n_new,
                                          effort=effort)
