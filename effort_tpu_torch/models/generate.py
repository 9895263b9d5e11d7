"""Generation loop: decode with per-step predictions, optionally after a
one-pass prefill of the prompt; sampling, presence/frequency penalties and
logprobs; the full, ring and int8 KV caches; teacher-forced logits and
scores; self-speculative greedy decode (generate_speculative).

The JAX package runs a whole generation as one jitted lax.scan
(_decode_scan, _prefill_decode_scan). The port runs the same step body
(_decode_step, _prefill_step) over state on the device: the ids, the
position, the end-of-sequence flag, the token counts and the generator
stay on the card, and nothing is read back until the loop ends. On the
card each step is one captured CUDA graph (models/graphs.StepGraph),
replayed once a token. Engine keeps one graph per key (route, dense copy
or kernel, KV mode, sampled, top_k, penalized, logprobs_k and the
buffers' capacity), as the JAX Engine keeps one jitted program per key in
_fn. Effort (below the dense switch), temperature, top_p, penalty values
and seed are contents of the step's buffers, so new values capture
nothing.

A speculative round (_spec_round: k draft steps at a low effort, one
forward_seq verify of the k tokens at effort 1.0 with its start slot on the
card, the acceptance) is one captured graph too, under the loop "spec";
the host reads one small status tensor after each round to decide whether
to replay again (the JAX package's while_loop cond runs on its device).

Stays eager: the "gather" route (it sizes its block list from a python
float effort), the "stream" route on an MoE model (it reads the routed
instance to the host), the "plain" route on a rank-prefix model (the
plain versions of K4 and K5 read the coverage to the host), the prefill
pass itself (one forward_seq a request), and everything on the CPU. Engine(capture=False) runs the same
step eagerly on the card; it is for tests and chip_smoke.py, as
jax.disable_jit is.

Effort reaches the kernels of a decode step as a 16.16 device tensor (K1,
or K4 and K5 on a rank-prefix model), and the prefill pass as an f32
device tensor (K2 takes f32 efforts, as on the TPU).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.models.graphs import StepGraph
from effort_tpu_torch.models.transformer import (HOST_READS, ModelWeights,
                                                 forward_seq, forward_token,
                                                 make_kv_cache,
                                                 make_quant_kv_cache,
                                                 make_ring_kv_cache,
                                                 quant_kv_hooks,
                                                 resolve_device,
                                                 ring_kv_hooks)


@dataclasses.dataclass
class Reply:
    token_ids: list
    predictions: list          # the step's pick after every consumed position
    text: str = ""
    tokens_per_s: float = 0.0
    prep_ms: float = 0.0       # time_it: warm-up and capture of a cold key
    eval_ms_per_token: float = 0.0
    spec_tokens_per_iter: float = 0.0  # speculative decode: mean tokens
    #                                    emitted a draft/verify round
    logprobs: list = None      # per emitted token (when asked for):
    #                            {token_id: logprob} of the top-N


def _scalar(x, device) -> torch.Tensor:
    """x as a 0-d f32 tensor: a tensor as it is, a number filled on the
    device (no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _pick_token(logits: torch.Tensor, generator=None, sampled: bool = False,
                top_k: int = 0, temperature=0.0, top_p=1.0, counts=None,
                presence=0.0, frequency=0.0) -> torch.Tensor:
    """The next token (0-d int32), the JAX package's _pick_token: greedy
    (first index among ties) when not sampled; else softmax sampling at
    `temperature`, truncated to the top_k logits (top_k > 0, ties at the
    k-th kept) and then to the nucleus (the smallest prefix of the sorted
    distribution whose mass reaches top_p; the argmax is always kept, and
    top_p >= 1 keeps everything).

    counts [vocab] int32 (when given): the occurrences of each token so
    far; presence * (count > 0) + frequency * count is taken from the
    logits first (OpenAI's penalties, greedy included).

    sampled and top_k change the step (they are part of a graph's key);
    temperature, top_p, presence and frequency may be 0-d device tensors,
    read at run time. The draw is Gumbel-max over uniforms from
    `generator`, a torch.Generator on the logits' device: the distribution
    is JAX's categorical's, but the tokens are not JAX's, since torch's
    Philox bits are not JAX's threefry bits."""
    if counts is not None:
        logits = logits - (presence * (counts > 0)
                           + frequency * counts.to(torch.float32))
    if not sampled:
        return torch.argmax(logits).to(torch.int32)
    lg = _truncated(logits, temperature, top_k, top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    return torch.argmax(lg - torch.log(-torch.log(u))).to(torch.int32)


def _truncated(logits: torch.Tensor, temperature, top_k: int,
               top_p) -> torch.Tensor:
    """The logits _pick_token samples from: f32, over temperature, -inf
    outside the top_k and then outside the nucleus of mass top_p."""
    dev = logits.device
    lg = logits.to(torch.float32) / torch.clamp(_scalar(temperature, dev),
                                                min=1e-6)
    if top_k > 0:
        kth = torch.topk(lg, top_k).values[-1]
        lg = torch.where(lg >= kth, lg, -math.inf)
    srt = torch.sort(lg, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p
    cutoff = torch.min(torch.where(keep, srt, math.inf))
    cutoff = torch.where(_scalar(top_p, dev) >= 1.0, -math.inf, cutoff)
    return torch.where(lg >= cutoff, lg, -math.inf)


def _q16(effort: float) -> int:
    """The 16.16 effort as ops.effort.effort_q16 rounds it (f32 multiply,
    round half to even), computed on the host."""
    return int(np.round(np.float32(effort) * np.float32(65536.0)))


def _to_device(ids: list, device) -> torch.Tensor:
    """int32 ids on `device`; to the card from pinned memory without a
    wait."""
    t = torch.tensor(ids, dtype=torch.int32)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# the sampling and penalty values of a step's buffers, at "off"
_OFF = {"temperature": 0.0, "top_p": 1.0, "presence": 0.0, "frequency": 0.0}


@dataclasses.dataclass(frozen=True)
class _Key:
    """What a captured step depends on (the JAX Engine._fn key without
    P, n_new and effort: those are buffer contents here)."""
    loop: str           # "decode", "logits" (teacher-forced), "prefill"
    #                     or "spec" (a speculative round)
    cap: int            # positions of the id buffers
    dense: bool         # the dense copies (a python float effort; for
    #                     "spec", the draft's)
    kv_mode: str
    sampled: bool = False
    top_k: int = 0
    penalized: bool = False
    logprobs_k: int = 0
    spec_k: int = 0     # "spec": tokens drafted a round


class _StepState:
    """The device state a step carries (the JAX scan's carry) and writes
    (its outputs), at `cap` positions. Decode: ids [cap] (the prompt, then
    each written pick), preds [cap], the position, prompt length, total and
    done flag. Prefill: ids holds the generated tokens, pos the cache slot,
    base the padded prompt length P and offset its left pad."""

    def __init__(self, cfg: ModelConfig, key: _Key, device):
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.ids, self.preds = z(key.cap), z(key.cap)
        self.pos, self.prompt_len, self.total = z(), z(), z()
        self.base, self.offset = z(), z()
        self.done = z(dtype=torch.bool)
        self.eff = z(1)                                    # 16.16
        for name in _OFF:                  # temperature, top_p, penalties
            setattr(self, name, z(dtype=torch.float32))
        self.counts = z(cfg.vocab_size) if key.penalized else None
        k = key.logprobs_k
        self.top_lp = z(key.cap, k, dtype=torch.float32) if k else None
        self.top_ids = z(key.cap, k) if k else None
        self.logits = (z(cfg.vocab_size, dtype=torch.float32)
                       if key.loop == "logits" else None)
        self.generator = (torch.Generator(device=device) if key.sampled
                          else None)


def _decode_step(w: ModelWeights, cfg: ModelConfig, st: _StepState, kv,
                 effort, impl: str, eos_id: int, key: _Key) -> None:
    """One step of the JAX package's _decode_scan on st, in place: consume
    ids[pos] at pos, pick, and from pos >= prompt_len - 1 on write the pick
    at pos + 1 until EOS; count it for the penalties; keep the pick, the
    top-N logprobs (logprobs_k) or the logits (the "logits" loop)."""
    k_cache, v_cache, kv_up, attn = kv
    pos = st.pos
    p1 = pos.reshape(1).long()
    logits = forward_token(w, cfg, st.ids.index_select(0, p1)[0], pos,
                           k_cache, v_cache, effort=effort, impl=impl,
                           kv_update_fn=kv_up, attn_fn=attn)
    pred = _pick_token(logits, st.generator, key.sampled, key.top_k,
                       st.temperature, st.top_p, counts=st.counts,
                       presence=st.presence, frequency=st.frequency)
    is_gen = pos >= st.prompt_len - 1          # generating from here on
    nxt = pos + 1
    write = is_gen & (nxt < st.total) & ~st.done
    at = torch.minimum(nxt, st.total - 1).reshape(1).long()
    st.ids.index_copy_(0, at, torch.where(
        write, pred, st.ids.index_select(0, at)[0]).reshape(1))
    if st.counts is not None:
        st.counts.index_add_(0, pred.reshape(1).long(),
                             write.to(torch.int32).reshape(1))
    st.done |= is_gen & (pred == eos_id)
    st.preds.index_copy_(0, p1, pred.reshape(1))
    if key.logprobs_k:
        topv, topi = torch.topk(
            torch.log_softmax(logits.to(torch.float32), dim=-1),
            key.logprobs_k)
        st.top_lp.index_copy_(0, p1, topv[None])
        st.top_ids.index_copy_(0, p1, topi.to(torch.int32)[None])
    if st.logits is not None:
        st.logits.copy_(logits)
    st.pos += 1


def _prefill_step(w: ModelWeights, cfg: ModelConfig, st: _StepState, kv,
                  effort, impl: str, key: _Key) -> None:
    """One decode step after the prefill pass (the JAX package's
    _prefill_decode_scan): consume generated token i = pos - P at cache
    slot pos (rotary position pos - offset, slots < offset masked) and
    write the pick as token i + 1."""
    k_cache, v_cache = kv[:2]
    i = st.pos - st.base
    logits = forward_token(w, cfg, st.ids.index_select(
        0, i.reshape(1).long())[0], st.pos, k_cache, v_cache,
        effort=effort, impl=impl, rope_offset=st.offset,
        mask_from=st.offset)
    pred = _pick_token(logits, st.generator, key.sampled, key.top_k,
                       st.temperature, st.top_p)
    st.ids.index_copy_(0, (i + 1).reshape(1).long(), pred.reshape(1))
    st.pos += 1


class _SpecState:
    """A speculative round's own buffers, beside the decode state it
    shares (ids, pos, done): the tokens to generate n_new, the tokens
    emitted so far n_gen (the first from the prompt pass included), the
    rounds n_it, the draft effort (16.16) and the verify's (f32 1.0), the
    last round's consumed tokens [k] (the last token, then the drafts) and
    verify logits [k, vocab], and status = (n_gen, done, n_it), the one
    tensor the host reads a round."""

    def __init__(self, cfg: ModelConfig, k: int, device):
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.k = k
        self.n_new, self.n_gen, self.n_it = z(), z(), z()
        self.d_eff = z(1)                                  # 16.16
        self.one = torch.ones((), dtype=torch.float32, device=device)
        self.consumed = z(k)
        self.logits = z(k, cfg.vocab_size, dtype=torch.float32)
        self.status = z(3)


def _spec_round(w: ModelWeights, cfg: ModelConfig, st: _StepState,
                sp: _SpecState, kv, d_eff, v_eff, impl: str,
                eos_id: int) -> None:
    """One round of the JAX package's _spec_decode (its while_loop body,
    guarded by its cond, so a round past the end changes nothing but the
    cache rows past the last token), in place on st and sp. The last token
    is ids[pos]: k forward_token drafts at d_eff from it (cache rows pos ..
    pos+k-1), one forward_seq verify of the k consumed tokens at v_eff
    (effort 1.0) that rewrites those rows, and the acceptance: the prefix
    where the drafts agreed with the verifier, plus the verifier's next
    token, cut at the first EOS and at n_new; those tokens are written at
    ids[pos+1 ..], and pos, n_gen, done and n_it advance."""
    k_cache, v_cache = kv[:2]
    k, dev = sp.k, st.pos.device
    pos = st.pos
    active = (sp.n_gen < sp.n_new) & ~st.done        # the while_loop cond
    toks = [st.ids.index_select(0, pos.reshape(1).long())]
    for i in range(k):
        lg = forward_token(w, cfg, toks[-1][0], pos + i, k_cache, v_cache,
                           effort=d_eff, impl=impl)
        toks.append(torch.argmax(lg).to(torch.int32).reshape(1))
    consumed, dtoks = torch.cat(toks[:k]), torch.cat(toks[1:])
    logits = forward_seq(w, cfg, consumed, k_cache, v_cache, start_slot=pos,
                         effort=v_eff, impl=impl, moe_grouped=False)
    sp.consumed.copy_(consumed)
    sp.logits.copy_(logits)
    vtoks = torch.argmax(logits, dim=-1).to(torch.int32)            # [k]
    acc = torch.cumprod((dtoks[:-1] == vtoks[:-1]).to(torch.int32),
                        dim=0).sum().to(torch.int32)                # 0..k-1
    iota = torch.arange(k, dtype=torch.int32, device=dev)
    is_eos = (vtoks == eos_id) & (iota <= acc)
    has_eos = is_eos.any()
    first_eos = torch.argmax(is_eos.to(torch.int32)).to(torch.int32)
    n_emit = torch.where(has_eos, first_eos + 1, acc + 1)
    n_emit = torch.clamp(torch.minimum(n_emit, sp.n_new - sp.n_gen), min=1)
    n_emit = n_emit * active.to(torch.int32)
    at = (pos + 1 + iota).long()
    st.ids.index_copy_(0, at, torch.where(iota < n_emit, vtoks,
                                          st.ids.index_select(0, at)))
    st.pos += n_emit
    sp.n_gen += n_emit
    st.done |= has_eos & active
    sp.n_it += active.to(torch.int32)
    sp.status.copy_(torch.stack([sp.n_gen, st.done.to(torch.int32),
                                 sp.n_it]))


def _left_pad(prompt_ids: Sequence[int], P: int) -> list:
    """The prompt at the tail of a [P] buffer (prefill layout): slots
    0..P-len hold pad id 0, masked out by mask_from = P - len."""
    return [0] * (P - len(prompt_ids)) + list(prompt_ids)


class Engine:
    """Holds the weights and runs generation on one device.

    impl: "auto" (dense copy at effort >= 0.999 when present, the kernel
    otherwise), "kernel", "plain", "reference" or "dense", and on a
    rank-prefix model "stream" (K5) or "gather" (K6) (ops/bucketmul.py).
    prefill=True runs the prompt through forward_seq in one pass
    (projections routed by prefill_impl; attention by K3 on the card, by
    materialized scores on the CPU) before the decode steps.

    ring_kv=True decodes over a cache of cfg.sliding_window slots, so
    decode runs past max_seq_len; quant_kv=True over the int8 cache (the
    token-loop engine only, one of the two, as in the JAX package).

    dynamic_effort=True passes the effort as the 16.16 device tensor at
    every value, 1.0 included, so "auto" never takes the dense copies (a
    traced effort cannot take the JAX package's static dense path either)
    and one captured step serves every effort. Below the dense switch it
    changes nothing: there the effort already rides in a device buffer.

    capture: each decode step as a replayed CUDA graph; the default on the
    card. capture=False runs the same steps eagerly there, for tests and
    chip_smoke.py. On the CPU nothing is captured.
    device: the card unless named; weights are moved there."""

    def __init__(self, weights: ModelWeights, cfg: ModelConfig,
                 tokenizer=None, impl: str = "auto", eos_id: int = 2,
                 pad_to: int = 32, prefill: bool = False,
                 prefill_impl: str = "auto", dynamic_effort: bool = False,
                 ring_kv: bool = False, quant_kv: bool = False,
                 device=None, capture=None):
        if dynamic_effort and prefill:
            raise ValueError("dynamic_effort works with the token-loop "
                             "engine")
        if (ring_kv or quant_kv) and prefill:
            raise ValueError("ring_kv/quant_kv work with the token-loop "
                             "engine")
        if ring_kv and quant_kv:
            raise ValueError("pick one KV-cache mode")
        if ring_kv and not cfg.sliding_window:
            raise ValueError("ring_kv requires cfg.sliding_window")
        if (ring_kv or quant_kv) and cfg.is_mla:
            raise ValueError("an MLA model decodes over its latent cache: "
                             "no ring or int8 KV cache")
        self.device = resolve_device(device)
        self.w = weights.to(self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.impl = impl
        self.eos_id = eos_id
        self.pad_to = pad_to
        self.prefill = prefill
        self.prefill_impl = prefill_impl
        self.dynamic_effort = dynamic_effort
        self.kv_mode = "ring" if ring_kv else ("int8" if quant_kv
                                               else "full")
        on_card = self.device.type == "cuda"
        self.capture = on_card if capture is None else bool(capture)
        if self.capture and not on_card:
            raise ValueError("capture=True needs a CUDA device")
        self._caches = {}
        self._states = {}
        self._spec_states = {}
        self._graphs = {}
        self._pool = None

    # ---------------- routes and buffers ----------------

    def _dense(self, effort: float, impl: str) -> bool:
        return impl == "dense" or (
            effort >= 0.999 and impl == "auto" and not self.dynamic_effort
            and self.w.layers.wo.dense is not None)

    def _eager_route(self) -> bool:
        """Routes whose step reads host values: "gather" (its capacity
        from a python float), "stream" on an MoE model (the routed
        instance read to the host), and "plain" on a rank-prefix model
        (K4's and K5's plain versions size their sums from the coverage
        read to the host)."""
        rank = self.w.layers.wo.bucket_size > 1
        return (self.impl == "gather"
                or (self.impl == "stream" and self.cfg.n_experts > 1)
                or (self.impl == "plain" and rank))

    def _effort_seq(self, effort: float):
        """For the prefill pass: a python float where the dense fast path
        may take it, else an f32 device tensor (K2's per-slot effort)."""
        if self._dense(effort, self.prefill_impl):
            return float(effort)
        return _scalar(effort, self.device)

    def _padded_len(self, n: int) -> int:
        return max(self.pad_to, -(-n // self.pad_to) * self.pad_to)

    def _cap(self, needed: int) -> int:
        """Positions of a step's id buffers: max_seq_len, or on the ring
        cache (which decodes past it) the next power of two that holds
        `needed`."""
        if needed <= self.cfg.max_seq_len:
            return self.cfg.max_seq_len
        if self.kv_mode != "ring":
            raise ValueError(f"{needed} positions exceed max_seq_len "
                             f"{self.cfg.max_seq_len}")
        return 1 << (needed - 1).bit_length()

    def _kv(self, mode: str):
        """(k_cache, v_cache, kv_update_fn, attn_fn) of a KV mode, made once
        an engine: each call writes every slot it reads before reading it,
        so the caches are reused as they are."""
        if mode not in self._caches:
            cfg, dev = self.cfg, self.device
            if mode == "ring":
                kv = make_ring_kv_cache(cfg, dev) + ring_kv_hooks(cfg)
            elif mode == "int8":
                kv = make_quant_kv_cache(cfg, dev) + quant_kv_hooks(cfg)
            else:
                kv = make_kv_cache(cfg, dev) + (None, None)
            self._caches[mode] = kv
        return self._caches[mode]

    def _state(self, key: _Key) -> _StepState:
        if key not in self._states:
            self._states[key] = _StepState(self.cfg, key, self.device)
        return self._states[key]

    def _run(self, key: _Key, st: _StepState, step, fill, n_steps: int,
             eager: bool = False) -> float:
        """fill(), then n_steps steps: replays of key's captured graph
        (captured first on a cold key, then fill() again), or step() itself
        when the engine does not capture or the route is eager. Returns the
        seconds spent capturing."""
        fill()
        if not self.capture or eager:
            for _ in range(n_steps):
                step()
            return 0.0
        prep = 0.0
        graph = self._graphs.get(key)
        if graph is None:
            t0 = time.perf_counter()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = StepGraph(step, key, self.device, self._pool,
                              st.generator)
            self._graphs[key] = graph
            prep = time.perf_counter() - t0
            fill()
        for _ in range(n_steps):
            graph.replay()
        return prep

    # ---------------- the two loops ----------------

    def _decode(self, prompt_ids: Sequence[int], n_new: int, effort: float,
                key_opts: dict, values: dict, loop: str = "decode",
                steps: int = None):
        """The token loop over the prompt, padded at the tail to P, and
        n_new steps more (the JAX package's _decode_scan): P + n_new - 1
        steps, or `steps` (the speculative prompt pass). loop="logits"
        feeds the prompt alone (n_new = 0, P = its length) and keeps each
        step's logits. Returns (state, total, logits or None, capture
        seconds)."""
        n = len(prompt_ids)
        P = n if loop == "logits" else self._padded_len(n)
        total = P + n_new
        dense = self._dense(effort, self.impl)
        key = _Key(loop, self._cap(total), dense, self.kv_mode, **key_opts)
        st = self._state(key)
        eff = (float(effort) if dense or self.impl == "gather" else st.eff)
        kv = self._kv(self.kv_mode)
        ids = _to_device(list(prompt_ids) + [0] * (P - n), self.device)

        def fill():
            st.ids[:P].copy_(ids)
            st.ids[P:].zero_()
            st.pos.zero_()
            st.prompt_len.fill_(n)
            st.total.fill_(total)
            st.done.zero_()
            st.eff.fill_(_q16(effort))
            for name, off in _OFF.items():
                getattr(st, name).fill_(values.get(name, off))
            if st.counts is not None:
                st.counts.zero_()
                st.counts.index_add_(0, st.ids[:n].long(),
                                     torch.ones_like(st.ids[:n]))
            if st.generator is not None:
                st.generator.manual_seed(values.get("seed", 0))

        def step():
            _decode_step(self.w, self.cfg, st, kv, eff, self.impl,
                         self.eos_id, key)

        if loop != "logits":
            return st, total, None, self._run(
                key, st, step, fill, total - 1 if steps is None else steps,
                self._eager_route())
        out = torch.empty((n, self.cfg.vocab_size),
                          dtype=torch.float32, device=self.device)
        graph = None
        if self.capture and not self._eager_route():
            self._run(key, st, step, fill, 0)
            graph = self._graphs[key]
        else:
            fill()
        for p in range(n):
            graph.replay() if graph is not None else step()
            out[p].copy_(st.logits)
        return st, total, out, 0.0

    def _prefill_decode(self, prompt_ids: Sequence[int], n_new: int,
                        effort: float, key_opts: dict, values: dict):
        """The left-padded prompt through forward_seq in one pass (eager),
        the first token picked from its last logits, then n_new - 1 decode
        steps (the JAX package's _prefill_decode_scan; its last step's pick
        is not returned, so the port does not run it). Rotary positions are
        slot - offset and attention masks slots < offset. Returns (state,
        the prefill pass's argmax ids [P] in left-pad layout, capture
        seconds)."""
        n = len(prompt_ids)
        P = self._padded_len(n)
        offset = P - n
        dense = self._dense(effort, self.impl)
        key = _Key("prefill", self._cap(P + n_new), dense, "full",
                   **key_opts)
        st = self._state(key)
        eff = (float(effort) if dense or self.impl == "gather" else st.eff)
        kv = self._kv("full")
        logits = forward_seq(self.w, self.cfg,
                             _to_device(_left_pad(prompt_ids, P),
                                        self.device),
                             kv[0], kv[1], start_slot=0, rope_offset=offset,
                             mask_from=offset,
                             effort=self._effort_seq(effort),
                             impl=self.prefill_impl)
        prefill_preds = torch.argmax(logits, dim=-1).to(torch.int32)

        def fill():
            st.pos.fill_(P)
            st.base.fill_(P)
            st.offset.fill_(offset)
            st.eff.fill_(_q16(effort))
            st.temperature.fill_(values.get("temperature", 0.0))
            st.top_p.fill_(values.get("top_p", 1.0))
            if st.generator is not None:
                st.generator.manual_seed(values.get("seed", 0))
            st.ids[:1].copy_(_pick_token(
                logits[-1], st.generator, key.sampled, key.top_k,
                st.temperature, st.top_p).reshape(1))

        def step():
            _prefill_step(self.w, self.cfg, st, kv, eff, self.impl, key)

        prep = self._run(key, st, step, fill, n_new - 1, self._eager_route())
        return st, prefill_preds, prep

    # ---------------- entry points ----------------

    def _launch(self, prompt_ids: Sequence[int], n_new: int, effort: float,
                key_opts: dict, values: dict):
        """Every launch of one generation, with no host read: (device
        tensors to read, capture seconds)."""
        if self.prefill:
            st, pre, prep = self._prefill_decode(prompt_ids, n_new, effort,
                                                 key_opts, values)
            return {"gen": st.ids[:n_new], "pre": pre}, prep
        st, total, _, prep = self._decode(prompt_ids, n_new, effort,
                                          key_opts, values)
        out = {"ids": st.ids[:total], "preds": st.preds[:total - 1]}
        if st.top_lp is not None:
            out["top_lp"], out["top_ids"] = (st.top_lp[:total - 1],
                                             st.top_ids[:total - 1])
        return out, prep

    def generate(self, prompt_ids: Sequence[int], n_new: int = 30,
                 effort: float = 1.0, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 presence_penalty: float = 0.0,
                 frequency_penalty: float = 0.0, logprobs: int = 0,
                 time_it: bool = False) -> Reply:
        """Continuation of prompt_ids by n_new tokens at `effort` (stops
        early at eos_id). The prompt is padded to a multiple of pad_to, as
        the JAX engine pads it: at the tail (token loop) or, with prefill,
        at the head.

        temperature = 0 is greedy; temperature > 0 samples, truncated by
        top_k and top_p (see _pick_token); seed fixes the draws (same seed,
        same tokens on one device). presence/frequency penalties (the
        token loop only) apply to greedy too. logprobs = N (the token loop
        only) returns the top-N log-probabilities of each emitted token's
        step. top_k, and whether sampling, penalties or logprobs are on,
        select the captured step; the values do not.

        time_it=False: one run; its times include a cold key's capture.
        time_it=True: a second, timed run, and prep_ms the first run's
        capture time."""
        n = len(prompt_ids)
        P = self._padded_len(n)
        if self.kv_mode != "ring" and P + n_new > self.cfg.max_seq_len:
            raise ValueError(f"{P} + {n_new} positions exceed max_seq_len "
                             f"{self.cfg.max_seq_len} (ring_kv decodes past "
                             f"it)")
        sampled = temperature > 0.0
        penalized = presence_penalty != 0.0 or frequency_penalty != 0.0
        if self.prefill and (penalized or logprobs):
            raise ValueError("penalties and logprobs run in the token-loop "
                             "engine only, as in the JAX package")
        key_opts = dict(sampled=sampled, top_k=top_k if sampled else 0,
                        penalized=penalized, logprobs_k=logprobs)
        values = dict(temperature=temperature, top_p=top_p, seed=seed,
                      presence=presence_penalty,
                      frequency=frequency_penalty)

        def run():
            out, prep = self._launch(prompt_ids, n_new, effort, key_opts,
                                     values)
            return {k: v.cpu() for k, v in out.items()}, prep

        t0 = time.perf_counter()
        host, prep = run()
        dt = time.perf_counter() - t0
        if time_it:
            t0 = time.perf_counter()
            host, _ = run()
            dt = time.perf_counter() - t0
        if self.prefill:
            new_ids = host["gen"].tolist()
            preds = host["pre"].tolist()[P - n:] + new_ids[1:]
        else:
            ids, preds = host["ids"].tolist(), host["preds"].tolist()
            new_ids = ids[n:n + n_new]
        if self.eos_id in new_ids:
            new_ids = new_ids[:new_ids.index(self.eos_id) + 1]
        lp_out = None
        if logprobs:
            # step i predicts the token consumed at i + 1: the emitted
            # tokens were picked at steps n - 1, n, ...
            lp = host["top_lp"].tolist()
            ti = host["top_ids"].tolist()
            lp_out = [dict(zip(ti[n - 1 + i], lp[n - 1 + i]))
                      for i in range(len(new_ids))]
        text = (self.tokenizer.decode(new_ids)
                if self.tokenizer is not None else "")
        n_steps = P + n_new - 1
        return Reply(token_ids=new_ids, predictions=preds, text=text,
                     tokens_per_s=n_steps / dt,
                     prep_ms=prep * 1e3 if time_it else 0.0,
                     eval_ms_per_token=dt / n_steps * 1e3, logprobs=lp_out)

    # ---------------- speculative decode ----------------

    def _spec_launch(self, prompt_ids: Sequence[int], n_new: int,
                     draft_effort: float, k: int, on_round=None):
        """Every launch of one speculative generation: the prompt pass (the
        decode key of generate(effort=1.0), n steps: each writes its cache
        row, and step n - 1 writes the first token at ids[n]), then rounds
        until the status read after one says n_new tokens or EOS;
        on_round(spec state), when given, after each read (chip_smoke.py
        inspects rounds with it). Returns (state, spec state, capture
        seconds)."""
        n = len(prompt_ids)
        P = self._padded_len(n)
        cap = self._cap(P + n_new + k)
        d_dense = self._dense(draft_effort, self.impl)
        key = _Key("spec", cap, d_dense, "full", spec_k=k)
        st = self._state(_Key("decode", cap, self._dense(1.0, self.impl),
                              "full"))
        if key not in self._spec_states:
            self._spec_states[key] = _SpecState(self.cfg, k, self.device)
        sp = self._spec_states[key]
        kv = self._kv("full")
        d_eff = (float(draft_effort) if d_dense or self.impl == "gather"
                 else sp.d_eff)
        v_eff = 1.0 if self._dense(1.0, self.impl) else sp.one

        def round_():
            _spec_round(self.w, self.cfg, st, sp, kv, d_eff, v_eff,
                        self.impl, self.eos_id)

        eager = not self.capture or self._eager_route()
        prep = 0.0
        graph = self._graphs.get(key)
        if graph is None and not eager:
            # the capture's warm-up round runs on this state: a round past
            # the end (n_gen = n_new = 0) at pos 0, which writes cache rows
            # 0 .. k-1 only (the prompt pass below rewrites them)
            t0 = time.perf_counter()
            st.pos.zero_()
            sp.n_new.zero_()
            sp.n_gen.zero_()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = StepGraph(round_, key, self.device, self._pool)
            self._graphs[key] = graph
            prep = time.perf_counter() - t0
        _, _, _, p2 = self._decode(prompt_ids, n_new, 1.0, {}, {}, steps=n)
        sp.n_new.fill_(n_new)
        sp.n_gen.fill_(1)
        sp.n_it.zero_()
        sp.d_eff.fill_(_q16(draft_effort))
        while True:
            graph.replay() if not eager else round_()
            n_gen, done, _ = sp.status.tolist()
            HOST_READS["spec_status"] += 1
            if on_round is not None:
                on_round(sp)
            if n_gen >= n_new or done:
                return st, sp, prep + p2

    def generate_speculative(self, prompt_ids: Sequence[int],
                             n_new: int = 30, draft_effort: float = 0.25,
                             k: int = 8, time_it: bool = False) -> Reply:
        """Self-speculative greedy decode (the JAX package's
        generate_speculative): the greedy continuation at effort 1.0, with
        each round drafting k tokens at draft_effort and verifying all k in
        one forward_seq pass at effort 1.0 (every emitted token is the
        verifier's pick, and the verify rewrites the drafted cache rows).
        On the card a round is one replayed graph, and the host reads one
        status tensor a round (HOST_READS["spec_status"]). The prompt runs
        through the token loop, on a prefill engine too, as in the JAX
        package. The full bf16 cache only, as in the JAX package.
        spec_tokens_per_iter: tokens emitted a round."""
        if self.kv_mode != "full":
            raise ValueError("generate_speculative runs on the full bf16 "
                             "cache: the verify pass (forward_seq) writes "
                             "the cache rows itself")
        n = len(prompt_ids)
        P = self._padded_len(n)
        if k < 1 or P + n_new + k > self.cfg.max_seq_len:
            raise ValueError(f"{P} + {n_new} + k={k} positions exceed "
                             f"max_seq_len {self.cfg.max_seq_len}")

        def run():
            st, sp, prep = self._spec_launch(prompt_ids, n_new,
                                             draft_effort, k)
            n_gen, _, n_it = sp.status.tolist()
            return st.ids[n:n + min(n_gen, n_new)].tolist(), n_gen, n_it, \
                prep

        t0 = time.perf_counter()
        toks, n_gen, n_it, prep = run()
        dt = time.perf_counter() - t0
        if time_it:
            t0 = time.perf_counter()
            toks, n_gen, n_it, _ = run()
            dt = time.perf_counter() - t0
        if self.eos_id in toks:
            toks = toks[:toks.index(self.eos_id) + 1]
        text = (self.tokenizer.decode(toks)
                if self.tokenizer is not None else "")
        return Reply(token_ids=toks, predictions=[], text=text,
                     tokens_per_s=len(toks) / max(dt, 1e-9),
                     prep_ms=prep * 1e3 if time_it else 0.0,
                     eval_ms_per_token=dt * 1e3 / max(len(toks), 1),
                     spec_tokens_per_iter=n_gen / max(n_it, 1))

    def _forward_seq(self, prompt_ids: Sequence[int], effort: float):
        """Prefill logits [P, vocab] of the left-padded prompt."""
        P = self._padded_len(len(prompt_ids))
        ids = _to_device(_left_pad(prompt_ids, P), self.device)
        k_cache, v_cache = make_kv_cache(self.cfg, self.device)
        off = P - len(prompt_ids)
        return forward_seq(self.w, self.cfg, ids, k_cache, v_cache,
                           rope_offset=off, mask_from=off,
                           effort=self._effort_seq(effort),
                           impl=self.prefill_impl)

    def token_logits(self, prompt_ids: Sequence[int],
                     effort: float = 1.0) -> torch.Tensor:
        """Teacher-forced logits [len, vocab] on the device,
        one decode step a position (replays of the captured step on the
        card), through the engine's KV mode: the full cache, or the ring
        or int8 cache (JAX's position_logits always takes the full
        cache)."""
        return self._decode(prompt_ids, 0, effort, {}, {},
                            loop="logits")[2]

    def position_logits(self, prompt_ids: Sequence[int],
                        effort: float = 1.0) -> np.ndarray:
        """[len(prompt_ids), vocab] logits at every real prompt position
        (the next-token distribution after each)."""
        n = len(prompt_ids)
        if self.prefill:
            logits = self._forward_seq(prompt_ids, effort)[-n:]
        else:
            logits = self.token_logits(prompt_ids, effort)
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
