"""Continuous batching: slot-based batched decode with per-request effort.

  - B decode slots share one [L, B, S, KV, D] KV cache, bf16 or int8
    (kv_dtype="int8": one f32 scale a slot, position and kv head, about
    half the bytes); each slot has its own cache position, left-pad
    offset, effort and end-of-sequence state;
  - a new request is admitted into a free slot between decode steps: its
    prompt runs through one forward_seq pass (K2 per projection, K3 for
    attention) that writes only its slot's cache, then the slot joins the
    next batched decode step, so requests do not wait for each other;
  - one batched decode step (forward_token_batch) advances every slot:
    each projection is one K2 launch over the B slots, each slot selecting
    at its own effort (an MoE FFN runs slot by slot: K1 a slot and
    routed expert). Slots without a request run at effort 0. On the card
    (row-prefix weights) the step is one captured CUDA graph a (batch size,
    KV mode), replayed
    once a step over static buffers (tokens, positions, offsets, efforts,
    live slots); the host reads the step's picks after it, as the JAX
    package's does;
  - spec_k > 0 makes each step speculative (the JAX package's
    _spec_step_fn): every slot drafts spec_k tokens through the batched
    step at the draft effort (idle slots at 0), then one verify pass
    (forward_seq_batch) scores all of them at each slot's own effort,
    each projection one K2 launch over the B * spec_k rows and K3 once a
    slot, reading the slot's position and offset on the card; a slot
    emits the agreeing prefix of its drafts plus the verifier's next
    token (1 .. spec_k tokens a step). On the card the whole step is one
    captured graph, and the host reads the verified tokens and their
    counts after it.

ContinuousBatcher is the scheduler loop the HTTP server drives. Its
counts (always kept) and the spans of both classes (utils/profiling.py,
recorded only while a profiler or recording() is on) name the boundaries:
batcher.tick, batcher.queued, batcher.admit (.launch, .read),
batcher.step (.launch, .read) and batcher.callback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import torch

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.kernels.decode_attention import live_rows
from effort_tpu_torch.models.generate import _to_device
from effort_tpu_torch.models.graphs import StepGraph
from effort_tpu_torch.models.transformer import (ModelWeights, active_window,
                                                 attention_reads,
                                                 forward_seq,
                                                 forward_seq_batch,
                                                 forward_token_batch,
                                                 make_batch_kv_cache,
                                                 make_kv_cache,
                                                 make_quant_kv_cache,
                                                 quantize_kv_rows,
                                                 resolve_device)
from effort_tpu_torch.utils.profiling import annotate, mark


@dataclasses.dataclass
class SlotState:
    request_id: int = -1
    prompt_len: int = 0
    offset: int = 0          # left-pad offset inside the padded prompt
    generated: List[int] = dataclasses.field(default_factory=list)
    n_new: int = 0
    done: bool = True


class BatchEngine:
    """Batched decode over B slots of one shared KV cache.

    impl routes the decode step's projections and prefill_impl the
    admission pass's (ops/bucketmul.py). The default "auto" takes K2 on
    the card and its plain version on the CPU, so the batched step reaches
    the kernel; the JAX package's BatchEngine defaults to its "jnp" route,
    which is the port's "reference" (every weight read).
    kv_dtype: "bf16" or "int8" (the cache quantized per row and kv head).
    spec_k > 0: speculative steps (the module docstring), drafts at
    spec_draft_effort; the bf16 cache only, as in the JAX package.
    capture: the step as a replayed CUDA graph, the default on the card
    for row-prefix weights; capture=False runs it eagerly there (tests,
    chip_smoke.py).
    device: the card unless named; weights are moved there."""

    def __init__(self, weights: ModelWeights, cfg: ModelConfig,
                 batch_size: int = 4, pad_to: int = 32, eos_id: int = 2,
                 impl: str = "auto", prefill_impl: str = "auto",
                 kv_dtype: str = "bf16", spec_k: int = 0,
                 spec_draft_effort: float = 0.25, device=None, capture=None):
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r}: bf16 or int8")
        if spec_k < 0:
            raise ValueError(f"spec_k {spec_k} < 0")
        if spec_k and kv_dtype == "int8":
            raise ValueError("speculative batching verifies through "
                             "forward_seq_batch, which writes bf16 cache "
                             "rows: kv_dtype='bf16' only")
        self.spec_k = spec_k
        self.spec_draft_effort = spec_draft_effort
        self.device = resolve_device(device)
        self.w = weights.to(self.device)
        self.cfg = cfg
        self.B = batch_size
        self.pad_to = pad_to
        self.eos_id = eos_id
        self.impl = impl
        self.prefill_impl = prefill_impl
        self.kv_quant = kv_dtype == "int8"
        if self.kv_quant:
            self.k_cache, self.v_cache = make_quant_kv_cache(
                cfg, self.device, batch_size)
            # admissions prefill into one bf16 slot, then quantize its rows
            self._scratch = make_kv_cache(cfg, self.device)
        else:
            self.k_cache, self.v_cache = make_batch_kv_cache(
                cfg, batch_size, self.device)
        # the step is captured on the card for row-prefix weights; a
        # rank-prefix model's step takes the per-row reference semantics
        # (bucket_matmul), which is not captured
        on_card = self.device.type == "cuda"
        row = self.w.layers.wo.bucket_size == 1
        self.capture = on_card and row if capture is None else bool(capture)
        if self.capture and not on_card:
            raise ValueError("capture=True needs a CUDA device")
        self._graph = None
        # the step's static buffers on the device (picks, tokens,
        # positions, offsets, efforts, live slots, the last step's logits),
        # and the positions on the host too (the end-of-sequence test
        # reads them every step)
        z = torch.zeros(batch_size, dtype=torch.int32, device=self.device)
        self.preds, self.tokens, self.pos, self.offs = (z, z.clone(),
                                                        z.clone(), z.clone())
        self.efforts = torch.ones(batch_size, dtype=torch.float32,
                                  device=self.device)
        self.live = torch.zeros(batch_size, dtype=torch.bool,
                                device=self.device)
        self.logits = torch.zeros((batch_size, cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        # speculative steps: tokens each slot may still emit, the draft
        # effort, and the step's output: the verified tokens [B, spec_k]
        # with each slot's count of emitted ones in the last column
        self.remaining = z.clone()
        self.draft_eff = torch.full((), float(spec_draft_effort),
                                    dtype=torch.float32, device=self.device)
        self.spec_out = torch.zeros((batch_size, spec_k + 1),
                                    dtype=torch.int32, device=self.device)
        self.pos_host = [0] * batch_size
        self.slots = [SlotState() for _ in range(batch_size)]

    # ---------------- slot management ----------------

    def free_slots(self) -> List[int]:
        return [b for b, s in enumerate(self.slots) if s.done]

    def active(self) -> List[int]:
        return [b for b, s in enumerate(self.slots) if not s.done]

    def admit(self, b: int, request_id: int, prompt_ids: Sequence[int],
              n_new: int, effort: float = 1.0) -> None:
        """Prefill the prompt into slot b's cache; the slot joins the next
        decode step. The effort rides in as an f32 device tensor, so the
        pass takes K2 at every effort, 1.0 included."""
        P = max(self.pad_to,
                -(-len(prompt_ids) // self.pad_to) * self.pad_to)
        if P + n_new + self.spec_k > self.cfg.max_seq_len:
            raise ValueError(f"{P} + {n_new} (+ spec_k {self.spec_k}) "
                             f"positions exceed max_seq_len "
                             f"{self.cfg.max_seq_len}")
        with annotate("batcher.admit", request_id):
            self._admit(b, request_id, prompt_ids, n_new, effort, P)

    def _admit(self, b: int, request_id: int, prompt_ids: Sequence[int],
               n_new: int, effort: float, P: int) -> None:
        offset = P - len(prompt_ids)
        with annotate("batcher.admit.launch", request_id):
            ids_lp = _to_device([0] * offset + list(prompt_ids),
                                self.device)
            eff = torch.full((), float(effort), dtype=torch.float32,
                             device=self.device)
            if self.kv_quant:
                kc, vc = self._scratch
            else:
                kc, vc = self.k_cache[:, b], self.v_cache[:, b]
            logits = forward_seq(self.w, self.cfg, ids_lp, kc, vc,
                                 start_slot=0, rope_offset=offset,
                                 mask_from=offset, effort=eff,
                                 impl=self.prefill_impl)
            if self.kv_quant:
                # only the P rows written: rows >= P are masked until
                # rewritten
                for (data, scale), rows in ((self.k_cache, kc),
                                            (self.v_cache, vc)):
                    xq, xs = quantize_kv_rows(rows[:, :P].to(torch.float32))
                    data[:, b, :P] = xq
                    scale[:, b, :P] = xs
        with annotate("batcher.admit.read", request_id):
            first = int(torch.argmax(logits[-1]))
        st = self.slots[b]
        st.request_id = request_id
        st.prompt_len = len(prompt_ids)
        st.offset = offset
        st.n_new = n_new
        st.generated = [first]
        st.done = (n_new <= 1) or (first == self.eos_id)
        self.tokens[b] = first
        self.pos[b] = P
        self.offs[b] = offset
        self.efforts[b] = float(effort)
        self.live[b] = not st.done
        self.remaining[b] = max(1, n_new - 1)
        self.pos_host[b] = P

    def _step(self) -> None:
        """The batched step on the static buffers, in place: slots without
        a request decode at effort 0 (near-zero weight reads) and keep
        their token; every position advances (idle slots harmlessly: their
        stale cache rows are rewritten by a later occupant before they are
        read)."""
        logits = forward_token_batch(
            self.w, self.cfg, self.tokens, self.pos, self.k_cache,
            self.v_cache, torch.where(self.live, self.efforts, 0.0),
            offs=self.offs, impl=self.impl, kv_quant=self.kv_quant)
        self.logits.copy_(logits)
        self.preds.copy_(torch.argmax(logits, dim=-1))
        self.tokens.copy_(torch.where(self.live, self.preds, self.tokens))
        self.pos.copy_(torch.clamp(self.pos + 1,
                                   max=self.cfg.max_seq_len - 1))

    def _spec_step(self) -> None:
        """The speculative step on the static buffers, in place: spec_k
        batched draft steps at the draft effort (0 for idle slots; cache
        positions clamped to the last row), one forward_seq_batch verify
        of the consumed tokens at each slot's own effort (0 for idle
        slots), and the JAX package's acceptance: while the next consumed
        token equals the verifier's pick, clipped to the slot's remaining
        tokens. Every slot's token and position advance (idle slots
        harmlessly); spec_out gets the verified tokens and the counts."""
        k, last = self.spec_k, self.cfg.max_seq_len - 1
        effs = torch.where(self.live, self.efforts, 0.0)
        d_eff = torch.where(effs > 0, self.draft_eff, 0.0)
        t, consumed = self.tokens, []
        for i in range(k):
            consumed.append(t)
            logits = forward_token_batch(
                self.w, self.cfg, t, torch.clamp(self.pos + i, max=last),
                self.k_cache, self.v_cache, d_eff, offs=self.offs,
                impl=self.impl)
            t = torch.argmax(logits, dim=-1).to(torch.int32)
        consumed = torch.stack(consumed, dim=1)                   # [B, k]
        vtoks = torch.argmax(forward_seq_batch(
            self.w, self.cfg, consumed, self.k_cache, self.v_cache,
            self.pos, self.offs, effs, impl=self.prefill_impl),
            dim=-1).to(torch.int32)                               # [B, k]
        acc = torch.cumprod((consumed[:, 1:] == vtoks[:, :-1]).to(
            torch.int32), dim=1).sum(dim=1).to(torch.int32)
        n_emit = torch.clamp(torch.minimum(acc + 1, self.remaining), min=1)
        self.spec_out.copy_(torch.cat([vtoks, n_emit[:, None]], dim=1))
        self.tokens.copy_(vtoks.gather(1, (n_emit - 1).long()[:, None])[:, 0])
        self.pos.copy_(torch.clamp(self.pos + n_emit, max=last))
        self.remaining.copy_(torch.clamp(self.remaining - n_emit, min=1))

    def _replay(self, step, key, saved) -> None:
        """step() as a replay of its captured graph on the card (captured
        on the first call; its warm-up changes the buffers `saved`, which
        are restored), or step() itself."""
        if not self.capture:
            step()
            return
        if self._graph is None:
            keep = [t.clone() for t in saved]
            self._graph = StepGraph(step, key, self.device)
            for t, s in zip(saved, keep):
                t.copy_(s)
        self._graph.replay()

    def positions(self, act: List[int]) -> tuple:
        """(live, read): the cache positions the next step's attention
        needs over the active slots `act` (each slot's rows from its left
        pad, or its sliding window, to its position) and those it reads
        over every slot, idle ones included (the step runs them all):
        transformer.attention_reads, K8's live rows or the plain version's
        whole cache; a speculative step's spec_k draft passes at
        positions + i, clamped to the last row (its verify pass is not
        counted). Stated, not measured."""
        S, last = self.cfg.max_seq_len, self.cfg.max_seq_len - 1
        win = active_window(self.cfg)

        def rows(slots, i):
            return sum(live_rows(min(self.pos_host[b] + i, last),
                                 self.slots[b].offset, win, S)
                       for b in slots)
        passes = range(self.spec_k or 1)
        live = sum(rows(act, i) for i in passes)
        cache = self.k_cache[0] if self.kv_quant else self.k_cache
        read = attention_reads(sum(rows(range(self.B), i) for i in passes),
                               len(passes) * self.B, S, self.cfg,
                               cache.dtype, self.device)
        return live, read

    def step(self, positions: tuple = None) -> List[int]:
        """One batched decode step (a replay of the captured step on the
        card), speculative when spec_k > 0; returns the slots that
        finished. positions: positions(active()), where the caller has
        it already."""
        act = self.active()
        if not act:
            return []
        with annotate("batcher.step", live_slots=len(act)) as span:
            if span:
                span["live_positions"], span["read_positions"] = \
                    positions or self.positions(act)
            if self.spec_k:
                return self._step_spec(act)
            return self._step_plain(act)

    def _step_plain(self, act: List[int]) -> List[int]:
        with annotate("batcher.step.launch"):
            self._replay(self._step, ("batch", self.B, self.kv_quant),
                         (self.preds, self.tokens, self.pos))
        with annotate("batcher.step.read"):
            preds_host = self.preds.tolist()
        finished = []
        last = self.cfg.max_seq_len - 1
        for b in act:
            st = self.slots[b]
            tok = preds_host[b]
            st.generated.append(tok)
            if (tok == self.eos_id or len(st.generated) >= st.n_new
                    or self.pos_host[b] + 1 >= last):
                st.done = True
                self.live[b] = False
                finished.append(b)
        self.pos_host = [min(p + 1, last) for p in self.pos_host]
        return finished

    def _step_spec(self, act: List[int]) -> List[int]:
        """A speculative step: each active slot emits its n_emit verified
        tokens (cut after an EOS), then finishes at EOS, at n_new tokens,
        or when spec_k more positions would pass the cache (the JAX
        package's _step_spec)."""
        with annotate("batcher.step.launch"):
            self._replay(self._spec_step, ("spec", self.B, self.spec_k),
                         (self.tokens, self.pos, self.remaining))
        with annotate("batcher.step.read"):
            out = self.spec_out.tolist()
        last = self.cfg.max_seq_len - 1
        finished = []
        self.pos_host = [min(p + row[-1], last)
                         for p, row in zip(self.pos_host, out)]
        for b in act:
            st = self.slots[b]
            for tok in out[b][:out[b][-1]]:
                st.generated.append(tok)
                if tok == self.eos_id:
                    break
            if (self.eos_id in st.generated
                    or len(st.generated) >= st.n_new
                    or self.pos_host[b] + self.spec_k >= last):
                st.done = True
                self.live[b] = False
                finished.append(b)
        return finished

    def result(self, b: int) -> List[int]:
        gen = self.slots[b].generated
        if self.eos_id in gen:
            gen = gen[:gen.index(self.eos_id) + 1]
        return gen


class ContinuousBatcher:
    """Synchronous scheduler over a BatchEngine: admit-when-free,
    step-while-active. The HTTP server drives it from a worker thread.

    counts, kept always (a few adds a tick): requests submitted and
    admitted, prompt tokens admitted, batched steps, tokens emitted (to
    on_token and the callbacks), queue_wait_s (submission to admission,
    summed), live_slot_steps (active slots summed over steps) and
    live_positions / read_positions (BatchEngine.positions, summed)."""

    def __init__(self, engine: BatchEngine):
        self.eng = engine
        self.pending: List[tuple] = []      # (request_id, ids, n_new,
        #                         effort, callback, on_token, submitted at)
        self.counts = {"submitted": 0, "admitted": 0, "prompt_tokens": 0,
                       "steps": 0, "tokens": 0, "queue_wait_s": 0.0,
                       "live_slot_steps": 0, "live_positions": 0,
                       "read_positions": 0}
        self._next_id = 0
        self._callbacks: Dict[int, object] = {}
        self._on_token: Dict[int, object] = {}

    def submit(self, prompt_ids: Sequence[int], n_new: int,
               effort: float, callback, on_token=None) -> int:
        """on_token(token_id): called as each token lands (streaming);
        callback(token_ids) still fires once with the full result."""
        rid = self._next_id
        self._next_id += 1
        self.pending.append((rid, list(prompt_ids), n_new, effort,
                             callback, on_token, time.perf_counter()))
        self.counts["submitted"] += 1
        return rid

    def has_work(self) -> bool:
        return bool(self.pending) or bool(self.eng.active())

    def tick(self) -> None:
        """Admit pending requests into free slots, then one decode step."""
        with annotate("batcher.tick"):
            c = self.counts
            free = self.eng.free_slots()
            while self.pending and free:
                rid, ids, n_new, effort, cb, on_tok, t_sub = \
                    self.pending.pop(0)
                b = free.pop(0)
                self._callbacks[rid] = cb
                if on_tok is not None:
                    self._on_token[rid] = on_tok
                t_admit = time.perf_counter()
                mark("batcher.queued", t_sub, t_admit, rid)
                c["queue_wait_s"] += t_admit - t_sub
                c["admitted"] += 1
                c["prompt_tokens"] += len(ids)
                self.eng.admit(b, rid, ids, n_new, effort)
                with annotate("batcher.callback", rid):
                    self._emit_from(b, 0)   # prefill produced a first token
                    if self.eng.slots[b].done:   # finished at prefill
                        self._finish(b)
            act = self.eng.active()
            live, read = self.eng.positions(act)
            if act:
                c["steps"] += 1
                c["live_slot_steps"] += len(act)
                c["live_positions"] += live
                c["read_positions"] += read
            pre = {b: len(self.eng.slots[b].generated) for b in act}
            finished = self.eng.step((live, read))
            with annotate("batcher.callback"):
                for b in act:
                    self._emit_from(b, pre[b])
                for b in finished:
                    self._finish(b)

    def _emit_from(self, b: int, start: int) -> None:
        st = self.eng.slots[b]
        self.counts["tokens"] += len(st.generated) - start
        on_tok = self._on_token.get(st.request_id)
        if on_tok is not None:
            for tok in st.generated[start:]:
                on_tok(tok)

    def _finish(self, b: int) -> None:
        st = self.eng.slots[b]
        self._on_token.pop(st.request_id, None)
        cb = self._callbacks.pop(st.request_id, None)
        if cb is not None:
            cb(self.eng.result(b))

    def run_until_drained(self) -> None:
        while self.has_work():
            self.tick()
