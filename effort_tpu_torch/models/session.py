"""Stateful chat sessions: the KV cache persists across turns and across
process restarts (the JAX package's models/session.py).

A ChatSession keeps the cache between turns (no re-prefill of the
conversation so far) and can be saved to / loaded from a safetensors file
(the JAX package's layout: files written by either package load in the
other), so long conversations survive restarts.

A turn is one loop of one step body (_turn_step) over device state: the
step consumes ids[i] at cache position pos; from the turn boundary on (the
last prompt token) it writes its pick at ids[i + 1], so the same step
first consumes the prompt and then generates. The JAX package feeds a
prompt right-padded to a bucket, where a pad runs at the slot of the next
real token (whose cache write then overwrites the pad's) and its output is
discarded; the port feeds the valid tokens alone, which leaves the same
cache and the same outputs. On the card each step is a replay of one
captured CUDA graph (models/graphs.StepGraph, through the session's own
Engine), keyed by the dense switch, sampling, top_k and penalties: the
position, the prompt, the 16.16 effort, the sampling and penalty values,
the counts and the seed are contents of the step's buffers, and the KV
cache is the graph's static buffer (load and reset write it in place,
never rebind it). A turn reads the host once, at its end (its tokens and
the position), as the JAX package's int(pos) and device_get(toks).
capture=False runs the same steps eagerly on the card (tests,
chip_smoke.py); on the CPU nothing is captured.

Semantics kept from the JAX package: the first generated token of a turn
is the greedy argmax after the prompt, even when sampling; generation
does not stop at EOS: pos advances by the full n_new, while the returned
tokens and the history are cut after EOS; the prediction after the last
consumed token is kept for continue_turn; penalty counts cover the whole
history plus the turn-boundary token. Sampled tokens come from a
torch.Generator (Philox), so they are not the JAX package's (threefry).

Spans (utils/profiling.py, recorded only while a profiler or recording()
is on): session.turn around turn / continue_turn, with the cache
positions its steps attend over and those their attention reads as
attributes (_turn_attrs);
session.launch (_launch: the upload, the fill, the steps' enqueue) and
session.read (_finish's host read) inside it.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np
import torch

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.models.generate import (Engine, _Key, _pick_token,
                                              _q16, _StepState, _to_device)
from effort_tpu_torch.models.transformer import (ModelWeights, active_window,
                                                 attention_reads,
                                                 forward_token)
from effort_tpu_torch.utils.profiling import annotate


def _turn_step(w: ModelWeights, cfg: ModelConfig, st: _StepState, kv,
               effort, impl: str, key: _Key) -> None:
    """One step of the JAX package's _consume_scan / _gen_scan, in place on
    st: consume ids[i] at pos, i = pos - base (base: the turn's first
    position); at the boundary i = prompt_len - 1 write the greedy pick as
    ids[i + 1] (the turn's first token) and count it; after it write the
    pick (sampled, penalized) and count it."""
    k_cache, v_cache, kv_up, attn = kv
    i = st.pos - st.base
    i1 = i.reshape(1).long()
    logits = forward_token(w, cfg, st.ids.index_select(0, i1)[0], st.pos,
                           k_cache, v_cache, effort=effort, impl=impl,
                           kv_update_fn=kv_up, attn_fn=attn)
    pred = torch.argmax(logits).to(torch.int32)
    boundary = st.prompt_len - 1
    if key.sampled or key.penalized:
        pick = _pick_token(logits, st.generator, key.sampled, key.top_k,
                           st.temperature, st.top_p, counts=st.counts,
                           presence=st.presence, frequency=st.frequency)
        pred = torch.where(i == boundary, pred, pick)
    gen = i >= boundary
    at = i1 + 1
    st.ids.index_copy_(0, at, torch.where(
        gen, pred, st.ids.index_select(0, at)[0]).reshape(1))
    if st.counts is not None:
        st.counts.index_add_(0, pred.reshape(1).long(),
                             gen.to(torch.int32).reshape(1))
    st.pos += 1


def live_positions(pos0: int, n: int, slots: int) -> int:
    """The cache positions n steps from position pos0 attend over: step i
    over min(pos0 + i + 1, slots) (a ring holds the last `slots`), summed
    in closed form."""
    full = max(0, min(n, slots - pos0))
    return full * (pos0 + 1) + full * (full - 1) // 2 + (n - full) * slots


def _bf16_of(a: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bits (a safetensors BF16 tensor) as a bf16 tensor."""
    return torch.from_numpy(np.array(a, copy=True).view(np.uint16)).view(
        torch.bfloat16)


class ChatSession:
    """Multi-turn generation with a persistent KV cache.

    impl: the port's route ("auto", "kernel", "reference", "dense", ...;
    the JAX package's "jnp" is "reference", "pallas" "kernel").
    device: the card unless named (weights are moved there). capture: each
    step a replayed CUDA graph, the default on the card; capture=False
    runs the same steps eagerly there."""

    def __init__(self, weights: ModelWeights, cfg: ModelConfig,
                 impl: str = "auto", eos_id: int = 2, pad_to: int = 32,
                 tokenizer=None, ring_kv: bool = False, device=None,
                 capture=None):
        """ring_kv=True keeps the conversation in a rolling
        O(sliding_window) cache: sessions are then unbounded by
        max_seq_len (the model attends to the last window anyway)."""
        if ring_kv and not cfg.sliding_window:
            raise ValueError("ring_kv requires cfg.sliding_window")
        self.engine = Engine(weights, cfg, tokenizer=tokenizer, impl=impl,
                             eos_id=eos_id, pad_to=pad_to, ring_kv=ring_kv,
                             device=device, capture=capture)
        self.w = self.engine.w
        self.cfg = cfg
        self.impl = impl
        self.eos_id = eos_id
        self.pad_to = pad_to
        self.tokenizer = tokenizer
        self.ring_kv = ring_kv
        self.device = self.engine.device
        self._kv = self.engine._kv(self.engine.kv_mode)
        # an MLA model's latent cache is k_cache, v_cache None
        # (transformer.make_kv_cache)
        self.k_cache, self.v_cache = self._kv[:2]
        self.pos = 0
        self.history: List[int] = []
        self._next_tok = None

    # ---------------- the step loop ----------------

    def _launch(self, ids: Sequence[int], n_prompt: int, n_steps: int,
                effort: float, temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0, seed: int = 0,
                presence_penalty: float = 0.0,
                frequency_penalty: float = 0.0,
                counts0=None) -> _StepState:
        """Every launch of one turn, with no host read: ids at the head of
        the id buffer, n_steps steps from cache position self.pos (replays
        of the key's captured step on the card), the greedy first token
        picked after the n_prompt-th (none when 0). Returns the state."""
        eng = self.engine
        sampled = temperature > 0.0
        penalized = presence_penalty != 0.0 or frequency_penalty != 0.0
        dense = eng._dense(effort, self.impl)
        # the steps write ids[1 .. n_steps]: one position past the
        # engine's own buffer
        key = _Key("turn", eng._cap(n_steps) + 1, dense, eng.kv_mode,
                   sampled, top_k if sampled else 0, penalized)
        st = eng._state(key)
        eff = float(effort) if dense or self.impl == "gather" else st.eff
        n = len(ids)
        ids_dev = _to_device(list(ids), self.device)
        counts_dev = None
        if penalized:
            c = torch.from_numpy(np.asarray(counts0, np.int32))
            counts_dev = (c.pin_memory().to(self.device, non_blocking=True)
                          if self.device.type == "cuda" else c)
        pos0 = self.pos

        def fill():
            st.ids[:n].copy_(ids_dev)
            st.ids[n:].zero_()
            st.pos.fill_(pos0)
            st.base.fill_(pos0)
            st.prompt_len.fill_(n_prompt)
            st.eff.fill_(_q16(effort))
            st.temperature.fill_(temperature)
            st.top_p.fill_(top_p)
            st.presence.fill_(presence_penalty)
            st.frequency.fill_(frequency_penalty)
            if st.counts is not None:
                st.counts.copy_(counts_dev)
            if st.generator is not None:
                st.generator.manual_seed(seed)

        def step():
            _turn_step(self.w, self.cfg, st, self._kv, eff, self.impl, key)

        eng._run(key, st, step, fill, n_steps, eng._eager_route())
        return st

    def _finish(self, st: _StepState, lo: int, n_new: int,
                consumed: list) -> List[int]:
        """The turn's one host read (its tokens ids[lo : lo + n_new], the
        next prediction after them, and the position); cut at EOS."""
        with annotate("session.read"):
            host = torch.cat([st.ids[lo:lo + n_new + 1],
                              st.pos.reshape(1)]).tolist()
        self.pos = int(host[-1])
        self._next_tok = int(host[n_new])
        out = [int(t) for t in host[:n_new]]
        if self.eos_id in out:
            out = out[:out.index(self.eos_id) + 1]
        self.history.extend(consumed + out)
        return out

    def _check_len(self, n: int) -> None:
        if not self.ring_kv and self.pos + n > self.cfg.max_seq_len:
            raise ValueError("session exceeds max_seq_len (use "
                             "ring_kv=True for unbounded)")

    # ---------------- turns ----------------

    def turn(self, prompt_ids: Sequence[int], n_new: int = 30,
             effort: float = 1.0, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             presence_penalty: float = 0.0,
             frequency_penalty: float = 0.0) -> List[int]:
        """Feed one user turn, generate up to n_new tokens. Only the NEW
        tokens are processed: the conversation so far lives in the cache.
        Sampling/penalty knobs match Engine.generate; penalty counts cover
        the WHOLE conversation history."""
        with annotate("session.turn") as span:
            if span:
                self._turn_attrs(span, len(prompt_ids) + n_new)
            return self._finish(*self._start_turn(
                prompt_ids, n_new, effort, temperature, top_k, top_p, seed,
                presence_penalty, frequency_penalty))

    def _turn_attrs(self, span, n_steps: int) -> None:
        """A turn span's attributes: the cache positions its n_steps steps
        attend over (within the sliding window) and those their attention
        reads (transformer.attention_reads: K8 loads the live rows, the
        plain version and the KV modes' hooks every slot). Stated in
        closed form, not measured."""
        slots = self.k_cache.shape[1]
        live = live_positions(self.pos, n_steps,
                              active_window(self.cfg) or slots)
        span["live_positions"] = live
        span["read_positions"] = attention_reads(
            live, n_steps, slots, self.cfg, self.k_cache.dtype, self.device,
            hooked=self._kv[3] is not None)

    def _start_turn(self, prompt_ids: Sequence[int], n_new: int = 30,
                    effort: float = 1.0, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                    presence_penalty: float = 0.0,
                    frequency_penalty: float = 0.0) -> tuple:
        """turn() up to its host read: every launch of the turn. Returns
        _finish's arguments."""
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("a turn needs at least one prompt token")
        P = max(self.pad_to, -(-len(ids) // self.pad_to) * self.pad_to)
        self._check_len(P + n_new)
        counts0 = None
        if presence_penalty != 0.0 or frequency_penalty != 0.0:
            counts0 = np.bincount(self.history + ids,
                                  minlength=self.cfg.vocab_size)
        with annotate("session.launch"):
            st = self._launch(ids, len(ids), len(ids) + n_new, effort,
                              temperature, top_k, top_p, seed,
                              presence_penalty, frequency_penalty, counts0)
        return st, len(ids), n_new, ids

    def continue_turn(self, n_new: int = 30, effort: float = 1.0,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, seed: int = 0,
                      presence_penalty: float = 0.0,
                      frequency_penalty: float = 0.0) -> List[int]:
        """Generate n_new MORE tokens continuing the last turn (no new
        prompt consumed): the chunked building block of turn_stream."""
        if self._next_tok is None:
            raise ValueError("continue_turn needs a prior turn")
        with annotate("session.turn") as span:
            if span:
                self._turn_attrs(span, n_new)
            self._check_len(n_new)
            counts0 = None
            if presence_penalty != 0.0 or frequency_penalty != 0.0:
                counts0 = np.bincount(self.history,
                                      minlength=self.cfg.vocab_size)
                counts0[self._next_tok] += 1   # the turn-boundary token
            with annotate("session.launch"):
                st = self._launch([self._next_tok], 0, n_new, effort,
                                  temperature, top_k, top_p, seed,
                                  presence_penalty, frequency_penalty,
                                  counts0)
            return self._finish(st, 0, n_new, [])

    def turn_stream(self, prompt_ids: Sequence[int], n_new: int = 30,
                    chunk: int = 8, **kw):
        """Generator: yields lists of token ids as they decode (a chunked
        turn, then continue_turn a chunk at a time: the streaming
        REPL/serving surface)."""
        done = 0
        n = min(chunk, n_new)
        toks = self.turn(prompt_ids, n_new=n, **kw)
        yield toks
        done += len(toks)
        while done < n_new and self.eos_id not in toks:
            n = min(chunk, n_new - done)
            toks = self.continue_turn(n_new=n, **kw)
            yield toks
            done += len(toks)

    def _named_caches(self) -> tuple:
        """The caches save() writes, by name: keys and values, or an MLA
        model's latent cache."""
        if self.cfg.is_mla:
            return (("latent_cache", self.k_cache),)
        return (("k_cache", self.k_cache), ("v_cache", self.v_cache))

    def reset(self) -> None:
        """Forget the conversation (cache rows are overwritten lazily)."""
        self.pos = 0
        self.history = []
        self._next_tok = None

    # ---------------- persistence ----------------

    def save(self, path: str) -> None:
        """Persist the session (KV cache + position + history) so a long
        conversation resumes without re-prefill: session.json and the
        cache rows [:, :pos + 1] (a ring session's whole ring) as bf16; an
        MLA model's latent rows as "latent_cache"."""
        from effort_tpu_torch.runtime.safetensors_io import SafeTensorWriter
        os.makedirs(path, exist_ok=True)
        wmeta = {"pos": self.pos, "history": self.history,
                 "model": self.cfg.name, "ring_kv": self.ring_kv}
        with open(os.path.join(path, "session.json"), "w") as f:
            json.dump(wmeta, f)
        wr = SafeTensorWriter(path, "session")
        # the ring wraps: every slot may be live, save it whole
        rows = (self.k_cache.shape[1] if self.ring_kv
                else max(1, self.pos + 1))
        for name, c in self._named_caches():
            wr.add(name, c[:, :rows].contiguous().cpu().view(torch.uint16)
                   .numpy(),
                   bf16_bits=True)
        wr.save()

    @classmethod
    def load(cls, path: str, weights: ModelWeights, cfg: ModelConfig,
             **kw) -> "ChatSession":
        """A session saved by save() (by either package), its cache rows
        written in place into the new session's cache."""
        from effort_tpu_torch.runtime.safetensors_io import MultiShardReader
        with open(os.path.join(path, "session.json")) as f:
            meta = json.load(f)
        kw.setdefault("ring_kv", bool(meta.get("ring_kv", False)))
        self = cls(weights, cfg, **kw)
        rd = MultiShardReader(path, "session")
        try:
            for name, c in self._named_caches():
                rows = _bf16_of(rd[name])
                c[:, :rows.shape[1]].copy_(rows.to(self.device))
        finally:
            rd.close()
        self.pos = int(meta["pos"])
        self.history = list(meta["history"])
        return self
