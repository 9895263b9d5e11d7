"""Driver of request traffic: N clients, closed loop, through
ContinuousBatcher over a BatchEngine, ticked from one thread.

Each client sends its next request of the plan as soon as its reply
lands. Set-up warms one admission at every padded prompt length the plan
holds, then runs the clients until every slot has been filled and as
many requests as slots have finished; the window continues from there
with the requests in flight, ticking until --seconds have passed (a
traced run: trace_ticks ticks).

The judged sample is drawn while the window runs: of the requests that
finish in it, every `sample_every`-th from a phase drawn from the seed,
and the longest so far. As each finishes, its keys and values (its
slot's cache rows, the program's state) are copied to pinned host
buffers made before set-up, without a wait: the reference then takes
each position one step from the program's own state.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness.traffic import padded


class Request:
    __slots__ = ("rid", "prompt", "n_new", "t_submit", "times", "tokens",
                 "t_done", "state")

    def __init__(self, prompt, n_new, t_submit):
        self.prompt, self.n_new, self.t_submit = prompt, n_new, t_submit
        self.times, self.tokens, self.t_done, self.rid = [], [], None, -1
        self.state = None


class Driver:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.reqs: list = []
        self.finished = 0
        self._items = iter(run.plan.items)
        d = run.dims
        rows = max(p + r for p, r in run.plan.items)
        shape = (d.n_layers, rows, d.n_kv_heads, d.head_dim)
        pin = run.device == "cuda"
        # one buffer for the longest request, the rest for the sample
        self.pool = [tuple(torch.empty(shape, dtype=torch.bfloat16,
                                       pin_memory=pin) for _ in range(2))
                     for _ in range(self.mix["check_requests"])]
        self.long_buf = self.pool.pop()
        self.longest, self.longest_n = None, 0
        self.t_window = None
        self.n_done_window = 0
        self.phase = int(np.random.default_rng(run.seed + 1).integers(
            self.mix["sample_every"]))

    def setup(self) -> None:
        from effort_tpu_torch.serving.batcher import (BatchEngine,
                                                      ContinuousBatcher)
        run, mix = self.run, self.mix
        w, cfg, self.src = run.build()
        # random weights have no end of sequence: every reply runs to the
        # length the traffic drew
        self.eng = BatchEngine(w, cfg, batch_size=mix["batch_size"],
                               pad_to=mix["pad_to"],
                               kv_dtype=mix["kv_dtype"], eos_id=-1,
                               device=run.device)
        self.bat = ContinuousBatcher(self.eng)
        run.spans.wrap(self.eng, "admit", "admit")
        run.spans.wrap(self.eng, "step", "step")
        # one admission at each padded prompt length (a one-token request
        # finishes at its admission)
        for P in sorted({padded(p, mix["pad_to"])
                         for p, _ in run.plan.items}):
            self.bat.submit(run.plan.ids(P), 1, mix["effort"],
                            lambda toks: None)
            self.bat.tick()
        for _ in range(mix["clients"]):
            self._send()
        while (self.finished < mix["batch_size"]
               or len(self.eng.free_slots()) == mix["batch_size"]):
            self.bat.tick()
        self.run.sync()

    def _send(self) -> None:
        p, r = next(self._items)
        req = Request(self.run.plan.ids(p), r, time.perf_counter())
        self.reqs.append(req)

        def on_token(tok, req=req):
            req.times.append(time.perf_counter())
            req.tokens.append(tok)

        def done(toks, req=req):
            req.t_done = time.perf_counter()
            self.finished += 1
            if self.t_window is not None:
                self._judge(req)
            self._send()
        req.rid = self.bat.submit(req.prompt, r, self.mix["effort"], done,
                                  on_token)

    def _judge(self, req: Request) -> None:
        """Keep a finished request's state when it falls on the sample's
        stride (while buffers last), or is the longest of the window so
        far (in a buffer of its own, taken over by the next longest)."""
        k = self.n_done_window
        self.n_done_window += 1
        if k % self.mix["sample_every"] == self.phase and self.pool:
            self._copy(req, self.pool.pop(0))
            self.sampled.append(req)
        n = len(req.prompt) + req.n_new
        if self.longest is None or n > self.longest_n:
            if self.longest is not None and self.longest not in self.sampled:
                self.longest.state = None
            if req.state is None:
                self._copy(req, self.long_buf)
            self.longest, self.longest_n = req, n

    def _copy(self, req: Request, buf: tuple) -> None:
        """The request's cache rows (its slot's, from its left pad on) to
        buf, without a wait; the rows stay until the slot's next
        admission, which comes after this callback."""
        eng = self.eng
        b = next(i for i, s in enumerate(eng.slots)
                 if s.request_id == req.rid)
        off = eng.slots[b].offset
        n = len(req.prompt) + req.n_new - 1       # every consumed token
        k, v = buf
        k[:, :n].copy_(eng.k_cache[:, b, off:off + n], non_blocking=True)
        v[:, :n].copy_(eng.v_cache[:, b, off:off + n], non_blocking=True)
        req.state = (k[:, :n], v[:, :n])

    def window(self, seconds: float, traced: bool) -> dict:
        ticks = 0
        self.sampled = []
        with self.run.spans.span("window"):
            t0 = time.perf_counter()
            self.t_window = t0
            while True:
                self.bat.tick()
                ticks += 1
                if traced and ticks >= self.mix["trace_ticks"]:
                    break
                if not traced and time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        self.t_window = None
        return {"t0": t0, "t1": t1, "ticks": ticks}

    def end_to_end(self, rec: dict) -> dict:
        t0, t1 = rec["t0"], rec["t1"]
        emitted, ttft, itl = 0, [], []
        for q in self.reqs:
            ts = q.times
            emitted += sum(t0 <= t <= t1 for t in ts)
            if ts and t0 <= ts[0] <= t1:
                ttft.append(ts[0] - q.t_submit)
            itl += [b - a for a, b in zip(ts, ts[1:]) if t0 <= b <= t1]
        return {"serve_tokens_per_s": emitted / (t1 - t0),
                "ttft_ms_p90": 1e3 * float(np.percentile(ttft, 90)),
                "itl_ms_p95": 1e3 * float(np.percentile(itl, 95)),
                "_counts": {"requests_first_token": len(ttft),
                            "gaps": len(itl), "tokens": emitted,
                            "ttft_ms_median": 1e3 * float(np.median(ttft)),
                            "itl_ms_median": 1e3 * float(np.median(itl))}}

    def release(self) -> None:
        del self.bat, self.eng

    def items(self, rec: dict, traced: bool) -> dict:
        """What the reference runs over. "judged": the sample of requests
        finished in the window (the longest, and every sample_every-th
        from the seed's phase), each (tokens, positions whose logits chose
        a served token, the served tokens); "state": their keys and
        values. In a traced run, "work_items": every request that took
        part in the traced window, with its whole known sequence, and
        "steps": each admission and batched step of the window in order,
        as {"kind", "tokens": [(work item, position consumed)]}."""
        t0, t1 = rec["t0"], rec["t1"]
        judged = [q for q in self.reqs if q.state is not None]
        out = {"judged": [self._item(q) for q in judged],
               "state": [q.state for q in judged], "work_items": None,
               "steps": []}
        if not traced:
            return out
        spans = self.run.spans
        marks = sorted([(b, "admit") for _, b in spans.spans.get("admit", [])
                        if t0 <= b <= t1]
                       + [(b, "step") for _, b in spans.spans.get("step", [])
                          if t0 <= b <= t1])
        ends = [m[0] for m in marks]
        steps = [{"kind": k, "tokens": []} for _, k in marks]
        used = {}
        for q in self.reqs:
            p = len(q.prompt)
            for j, t in enumerate(q.times):
                k = int(np.searchsorted(ends, t, side="right")) - 1
                if k < 0 or not t0 <= t <= t1:
                    continue
                i = used.setdefault(id(q), (len(used), q))[0]
                if j == 0:
                    steps[k]["tokens"] += [(i, pos) for pos in range(p)]
                else:
                    steps[k]["tokens"].append((i, p + j - 1))
        traced_q = [q for _, q in sorted(used.values(), key=lambda v: v[0])]
        out.update(work_items=[self._item(q) for q in traced_q],
                   steps=steps)
        return out

    @staticmethod
    def _item(q: Request) -> tuple:
        """(every token the program consumed: the prompt and each served
        token but the last, positions whose logits chose a served token,
        the served tokens)."""
        p, toks = len(q.prompt), list(q.tokens)
        return (q.prompt + toks[:-1], list(range(p - 1, p - 1 + len(toks))),
                toks)
