"""Generation loop: greedy decode with per-step predictions, optionally
after a one-pass prefill of the prompt; teacher-forced logits and scores.

The decode loop runs on the device end to end: the token ids, the
predictions and the end-of-sequence flag live in device tensors, and
nothing is read back until the loop ends, so the host never waits for the
card inside it. Effort is converted once per call into the kernels' 16.16
fixed-point device tensor for the decode steps (K1, or K4 and K5 on a
rank-prefix model), and into an f32 device tensor for the prefill pass (K2
takes f32 efforts, as on the TPU); the gather route (K6) takes the python
float, from which it sizes its block list.

Sampling, presence/frequency penalties, logprobs and speculative decode
are not ported yet: Engine.generate raises NotImplementedError when asked
for them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.models.transformer import (ModelWeights, forward_seq,
                                                 forward_token,
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


def _left_pad(prompt_ids: Sequence[int], P: int) -> list:
    """The prompt at the tail of a [P] buffer (prefill layout): slots
    0..P-len hold pad id 0, masked out by mask_from = P - len."""
    return [0] * (P - len(prompt_ids)) + list(prompt_ids)


def _prefill_decode(w: ModelWeights, cfg: ModelConfig, ids_lp: torch.Tensor,
                    offset: int, n_new: int, eff_seq, eff_tok, impl: str,
                    prefill_impl: str):
    """The left-padded prompt ids_lp [P] through forward_seq in one pass,
    then n_new - 1 greedy decode steps (the last token consumed needs no
    step: its prediction is not returned). Rotary positions are slot -
    offset and attention masks slots < offset. Returns (gen_ids [n_new],
    prefill_preds [P], left-pad layout) on the device."""
    P = ids_lp.shape[0]
    k_cache, v_cache = make_kv_cache(cfg, ids_lp.device)
    logits = forward_seq(w, cfg, ids_lp, k_cache, v_cache, start_slot=0,
                         rope_offset=offset, mask_from=offset,
                         effort=eff_seq, impl=prefill_impl)
    prefill_preds = torch.argmax(logits, dim=-1).to(torch.int32)
    gen = [prefill_preds[-1]]
    for i in range(n_new - 1):
        logits = forward_token(w, cfg, gen[-1], P + i, k_cache, v_cache,
                               effort=eff_tok, impl=impl,
                               rope_offset=offset, mask_from=offset)
        gen.append(_pick_token(logits))
    return torch.stack(gen), prefill_preds


# Engine.generate's options of the JAX engine that the port does not run
# yet, with the value that means "off"
_NOT_PORTED = {"temperature": 0.0, "top_k": 0, "top_p": 1.0, "seed": 0,
               "presence_penalty": 0.0, "frequency_penalty": 0.0,
               "logprobs": 0, "spec_k": 0}


class Engine:
    """Holds the weights and runs greedy generation on one device.

    impl: "auto" (dense copy at effort >= 0.999 when present, the kernel
    otherwise), "kernel", "plain", "reference" or "dense", and on a
    rank-prefix model "stream" (K5) or "gather" (K6) (ops/bucketmul.py).
    prefill=True runs the prompt through forward_seq
    in one pass (projections routed by prefill_impl; attention by K3 on
    the card, by materialized scores on the CPU) before the decode
    steps.
    device: the card unless named; weights are moved there."""

    def __init__(self, weights: ModelWeights, cfg: ModelConfig,
                 tokenizer=None, impl: str = "auto", eos_id: int = 2,
                 pad_to: int = 32, prefill: bool = False,
                 prefill_impl: str = "auto", device=None):
        self.device = resolve_device(device)
        self.w = weights.to(self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.impl = impl
        self.eos_id = eos_id
        self.pad_to = pad_to
        self.prefill = prefill
        self.prefill_impl = prefill_impl

    def _dense(self, effort: float, impl: str) -> bool:
        return impl == "dense" or (effort >= 0.999 and impl == "auto"
                                   and self.w.layers.wo.dense is not None)

    def _effort_arg(self, effort: float):
        """For the decode steps: a python float where the dense fast path
        may take it, or the gather route, which sizes its block list from
        it; else the 16.16 device tensor, made once per call."""
        if self._dense(effort, self.impl) or self.impl == "gather":
            return float(effort)
        return effort_q16(float(effort), self.device)

    def _effort_seq(self, effort: float):
        """For the prefill pass: a python float where the dense fast path
        may take it, else an f32 device tensor (K2's per-slot effort)."""
        if self._dense(effort, self.prefill_impl):
            return float(effort)
        return torch.tensor(float(effort), dtype=torch.float32,
                            device=self.device)

    def _padded_len(self, n: int) -> int:
        return max(self.pad_to, -(-n // self.pad_to) * self.pad_to)

    def _forward_seq(self, prompt_ids: Sequence[int], effort: float):
        """Prefill logits [P, vocab] of the left-padded prompt."""
        P = self._padded_len(len(prompt_ids))
        ids = torch.tensor(_left_pad(prompt_ids, P), dtype=torch.int32,
                           device=self.device)
        k_cache, v_cache = make_kv_cache(self.cfg, self.device)
        off = P - len(prompt_ids)
        return forward_seq(self.w, self.cfg, ids, k_cache, v_cache,
                           rope_offset=off, mask_from=off,
                           effort=self._effort_seq(effort),
                           impl=self.prefill_impl)

    def _token_logits(self, prompt_ids: Sequence[int], effort: float):
        """Logits [len, vocab] of the prompt, one forward_token a
        position."""
        ids = torch.tensor(list(prompt_ids), dtype=torch.int32,
                           device=self.device)
        k_cache, v_cache = make_kv_cache(self.cfg, self.device)
        eff = self._effort_arg(effort)
        return torch.stack([forward_token(self.w, self.cfg, ids[p], p,
                                          k_cache, v_cache, effort=eff,
                                          impl=self.impl)
                            for p in range(len(prompt_ids))])

    def generate(self, prompt_ids: Sequence[int], n_new: int = 30,
                 effort: float = 1.0, **options) -> Reply:
        """Greedy continuation of prompt_ids by n_new tokens at `effort`
        (stops early at eos_id). The prompt is padded to a multiple of
        pad_to, as the JAX engine pads it: at the tail (token loop) or,
        with prefill, at the head. options: the JAX engine's sampling,
        penalty, logprobs and speculative options, accepted at their "off"
        values only."""
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected option {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(f"{name}={value!r}: sampling, "
                                          f"penalties, logprobs and "
                                          f"speculative decode are not "
                                          f"ported yet")
        n = len(prompt_ids)
        P = self._padded_len(n)
        if P + n_new > self.cfg.max_seq_len:
            raise ValueError(f"{P} + {n_new} positions exceed max_seq_len "
                             f"{self.cfg.max_seq_len}")
        t0 = time.perf_counter()
        if self.prefill:
            ids = torch.tensor(_left_pad(prompt_ids, P), dtype=torch.int32,
                               device=self.device)
            gen, pre = _prefill_decode(
                self.w, self.cfg, ids, P - n, n_new,
                self._effort_seq(effort), self._effort_arg(effort),
                self.impl, self.prefill_impl)
            gen, pre = gen.cpu().tolist(), pre.cpu().tolist()
            new_ids, preds = gen, pre[P - n:] + gen[1:]
        else:
            ids = torch.tensor(list(prompt_ids) + [0] * (P - n),
                               dtype=torch.int32, device=self.device)
            ids, preds = _decode(self.w, self.cfg, ids, n, n_new,
                                 self._effort_arg(effort), self.impl,
                                 self.eos_id)
            ids, preds = ids.cpu().tolist(), preds.cpu().tolist()
            new_ids = ids[n:n + n_new]
        dt = time.perf_counter() - t0
        if self.eos_id in new_ids:
            new_ids = new_ids[:new_ids.index(self.eos_id) + 1]
        text = (self.tokenizer.decode(new_ids)
                if self.tokenizer is not None else "")
        n_steps = P + n_new - 1
        return Reply(token_ids=new_ids, predictions=preds, text=text,
                     tokens_per_s=n_steps / dt,
                     eval_ms_per_token=dt / n_steps * 1e3)

    def position_logits(self, prompt_ids: Sequence[int],
                        effort: float = 1.0) -> np.ndarray:
        """[len(prompt_ids), vocab] logits at every real prompt position
        (the next-token distribution after each)."""
        n = len(prompt_ids)
        if self.prefill:
            logits = self._forward_seq(prompt_ids, effort)[-n:]
        else:
            logits = self._token_logits(prompt_ids, effort)
        return logits.cpu().numpy()

    def prompt_logits(self, prompt_ids: Sequence[int], effort: float = 1.0):
        """(logits [vocab] after the prompt, per-position argmax ids)."""
        logits = self.position_logits(prompt_ids, effort)
        return logits[-1], [int(p) for p in np.argmax(logits, axis=-1)]

    def score(self, token_ids: Sequence[int],
              effort: float = 1.0) -> np.ndarray:
        """Teacher-forced log-probabilities of a text: entry i is
        log p(token_ids[i+1] | token_ids[:i+1]) at `effort`."""
        x = self.position_logits(token_ids, effort)[:-1].astype(np.float64)
        nxt = np.asarray(token_ids[1:], np.int64)
        m = x.max(axis=-1)
        lse = m + np.log(np.exp(x - m[:, None]).sum(axis=-1))
        return x[np.arange(len(nxt)), nxt] - lse

    def answer_limited(self, prompt_ids: Sequence[int],
                       allowed_ids: Sequence[int],
                       effort: float = 1.0) -> int:
        """0-based index into allowed_ids of the best allowed next token
        after the prompt (limit-logits question answering)."""
        logits, _ = self.prompt_logits(prompt_ids, effort)
        return int(np.argmax(logits[np.asarray(allowed_ids)]))


def generate(weights, cfg, prompt_ids, n_new=30, effort=1.0, impl="auto",
             tokenizer=None, device=None) -> Reply:
    return Engine(weights, cfg, tokenizer=tokenizer, impl=impl,
                  device=device).generate(prompt_ids, n_new=n_new,
                                          effort=effort)
