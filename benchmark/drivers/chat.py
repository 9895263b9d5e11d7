"""Driver of session traffic: one user, closed loop, through ChatSession.

Each conversation of the plan starts a fresh session (reset), and each
turn feeds its prompt and decodes its reply through the session's one
captured step, greedy at the mix's effort. The window runs whole turns
until --seconds have passed (a traced run: until trace_tokens tokens).

When a conversation ends, its cache rows (the program's state, as its
architecture names them: keys and values for Mistral) are copied to
pinned host buffers made before set-up, without a wait: the reference
then takes each position one step from the program's own state.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Driver:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        pin = run.device == "cuda"
        shapes = run.arch.state_shapes(run.dims, run.dims.max_seq_len)
        self.pool = [tuple(torch.empty(shape, dtype=dtype, pin_memory=pin)
                           for shape, dtype in shapes)
                     for _ in range(self.mix["snapshots"])]

    def setup(self) -> None:
        """Build the model, open the session and capture its step with one
        short turn (the only graph key the traffic uses)."""
        from effort_tpu_torch.models.session import ChatSession
        w, cfg, self.src = self.run.build()
        # random weights have no end of sequence: every reply runs to the
        # length the traffic drew
        self.sess = ChatSession(w, cfg, eos_id=-1, device=self.run.device)
        warm = self.mix["warm_turn"]
        self.sess.turn(self.run.plan.ids(warm[0]), n_new=warm[1],
                       effort=self.mix["effort"])
        self.sess.reset()
        self.run.sync()

    def window(self, seconds: float, traced: bool) -> dict:
        run, eff = self.run, self.mix["effort"]
        limit = self.mix["trace_tokens"] if traced else None
        convs, tokens, prompts, replies = [], 0, [], []
        done = False
        with run.spans.span("window"):
            t0 = time.perf_counter()
            for conv in run.plan.items:
                self.sess.reset()
                seq, want, targets = [], [], []
                c = {"seq": seq, "want": want, "targets": targets}
                convs.append(c)
                for p, r in conv:
                    ids = run.plan.ids(p)
                    with run.spans.span("turn"):
                        out = self.sess.turn(ids, n_new=r, effort=eff)
                    base = len(seq) + p - 1
                    want.extend(range(base, base + r))
                    targets.extend(out)
                    seq.extend(ids + out)
                    tokens += p + r
                    prompts.append(p)
                    replies.append(r)
                    elapsed = time.perf_counter() - t0
                    done = (tokens >= limit if limit is not None
                            else elapsed >= seconds)
                    if done:
                        break
                self._snapshot(c)
                if done:
                    break
            t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "tokens": tokens, "convs": convs,
                "lengths": {"prompt": prompts, "reply": replies}}

    def _snapshot(self, c: dict) -> None:
        """The conversation's cache rows to a free pinned buffer (none
        left: the conversation is not judged)."""
        if not self.pool:
            return
        bufs = self.pool.pop(0)
        n = len(c["seq"])
        for buf, rows in zip(bufs, self.run.arch.state_of(self.sess, None,
                                                          0, n)):
            buf[:, :n].copy_(rows, non_blocking=True)
        c["state"] = tuple(buf[:, :n] for buf in bufs)

    def end_to_end(self, rec: dict) -> dict:
        """The rate over the whole window; beside it, for the run's
        standard error, each turn's ms a token (its span over its
        tokens) as quartiles."""
        per = [1e3 * (b - a) / (p + r) for (a, b), p, r in zip(
            self.run.spans.spans.get("turn", []), rec["lengths"]["prompt"],
            rec["lengths"]["reply"])]
        q = np.percentile(per, [0, 25, 50, 75, 100]).tolist() if per else []
        return {"decode_ms_per_token":
                1e3 * (rec["t1"] - rec["t0"]) / rec["tokens"],
                "_counts": {"turns": len(per), "tokens": rec["tokens"],
                            "turn_ms_per_token_quartiles": q}}

    def release(self) -> None:
        del self.sess

    def items(self, rec: dict, traced: bool) -> dict:
        """What the reference runs over. "judged": every conversation of
        the window that has its state (the first `snapshots`), each
        (tokens, positions whose logits chose a served token, the served
        tokens); "state": their cache rows. In a traced run "steps":
        every token of a judged conversation is one step, each {"kind":
        "step", "tokens": [(item, position consumed)]}; their work is read
        from the same pass."""
        convs = [c for c in rec["convs"] if c["seq"] and "state" in c]
        items = [(c["seq"], c["want"], c["targets"]) for c in convs]
        steps = []
        if traced:
            for i, (seq, _, _) in enumerate(items):
                steps += [{"kind": "step", "tokens": [(i, p)]}
                          for p in range(len(seq))]
        return {"judged": items, "state": [c["state"] for c in convs],
                "work_items": None, "steps": steps}
