"""What the per-layer readers read: the traced window's device operations
and host spans, the steps the window ran, and the work the reference
found those steps' inputs need.

A reader (metrics/<name>.py) is `read(r) -> float | None`, r a Readings.
It returns None where it finds nothing to read; the harness then leaves
the metric out of the line.
"""

from __future__ import annotations

import torch

from harness import work as W
from harness.trace import breakdown, union_us


class WorkLog:
    """The reference's record of every effort product: per (layer,
    matrix), entries (token indices, rows needed, in_dim, out_dim)."""

    def __init__(self):
        self.entries: list = []

    def __call__(self, layer, name, idx, in_dim, out_dim, rows) -> None:
        self.entries.append((layer, name, idx.cpu(), rows.cpu(), in_dim,
                             out_dim))


class Readings:
    def __init__(self, run, trace, items: list, steps: list, work: WorkLog,
                 card: str):
        self.run, self.trace, self.items, self.steps = run, trace, items, \
            steps
        self.d = run.dims
        self.probes = run.cfg_file["bucket"]["probes"]
        self.peaks = W.peaks(card)
        self.t0, self.t1 = trace.window()
        self.ops = trace.in_window()
        offs, at = [], 0
        for seq, _, _ in items:
            offs.append(at)
            at += len(seq)
        # each step's tokens as global indices into the reference's input
        self.step_tokens = [[offs[i] + p for i, p in s["tokens"]]
                            for s in steps]
        self.step_pos = [[p for _, p in s["tokens"]] for s in steps]
        self.entries = work.entries if work is not None else []

    # ---- the window ----

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_us([(a, min(b, self.t1)) for _, a, b in self.ops]) \
            * 1e-6

    def breakdown(self) -> dict:
        return breakdown(self.ops, self.trace.notes, self.t0, self.t1)

    def host_spans(self, name: str) -> list:
        """The benchmark's host spans `name` inside the window, seconds."""
        s0 = self.run.spans.spans.get("window", [(0, 0)])[-1][0]
        s1 = self.run.spans.spans.get("window", [(0, 0)])[-1][1]
        return [(a, b) for a, b in self.run.spans.spans.get(name, [])
                if s0 <= a and b <= s1]

    # ---- device calls by kernel name ----

    def calls(self, first: str, rest: tuple, within: str = None) -> list:
        """A kernel's calls in the window as (start, end) us: a call opens
        at an operation whose name holds `first` and takes the following
        ones whose names hold one of `rest`; within names a host
        annotation that must cover the call's start."""
        out = []
        for name, a, b in self.ops:
            if first in name:
                out.append([a, b])
            elif out and any(r in name for r in rest) and a >= out[-1][0]:
                out[-1][1] = max(out[-1][1], b)
        if within is not None:
            spans = [(a, b) for n, a, b in self.trace.notes if n == within]
            out = [c for c in out if any(a <= c[0] < b for a, b in spans)]
        return [tuple(c) for c in out]

    # ---- work the traced steps need ----

    def _entries_of(self, tokens: list) -> list:
        """[(in_dim, out_dim, rows of each of these tokens the entry
        holds)] over every product entry."""
        tok = torch.as_tensor(tokens, dtype=torch.long)
        out = []
        for _, _, idx, rows, i, o in self.entries:
            hit = torch.isin(idx, tok)
            if bool(hit.any()):
                out.append((i, o, rows[hit]))
        return out

    def products(self, kind: str = None) -> W.Work:
        """The effort products of the traced steps (of one kind when
        given): a step of one token is one product a matrix (K1); a step
        of several shares the longest prefix among them (K2)."""
        total = W.Work()
        sel = [t for s, t in zip(self.steps, self.step_tokens)
               if kind is None or s["kind"] == kind]
        if all(len(t) == 1 for t in sel):
            # one token a step: one product a matrix, linear in the rows
            tok = torch.as_tensor([t[0] for t in sel], dtype=torch.long)
            for _, _, idx, rows, i, o in self.entries:
                r = rows[torch.isin(idx, tok)]
                n = int(r.numel())
                if n:
                    one = W.effort_product(i, o, 0, self.probes)
                    total += W.Work(bytes=n * one.bytes + float(r.sum()) * o,
                                    flops=2.0 * float(r.sum()) * o)
            return total
        for s, toks in zip(self.steps, self.step_tokens):
            if kind is not None and s["kind"] != kind:
                continue
            for i, o, rows in self._entries_of(toks):
                total += W.effort_product(i, o, int(rows.max()),
                                          self.probes, T=len(rows))
        return total

    def step_work(self) -> W.Work:
        """Everything the traced steps need: the products, attention over
        the live keys, the head (one row a step and sequence), embeddings,
        norms, router and the new cache rows."""
        total = self.products()
        L = self.d.n_layers
        for s, pos in zip(self.steps, self.step_pos):
            if s["kind"] == "admit":
                n = len(pos)
                total += _times(W.attention(n * (n + 1) // 2, n, n, self.d),
                                L)
                total += W.head(self.d, 1)
            else:
                for p in pos:
                    total += _times(W.attention(p + 1, p + 1, 1, self.d), L)
                total += W.head(self.d, len(pos))
            total += W.token_overhead(self.d, len(pos))
        return total

    def least_s(self, work: W.Work) -> float:
        return work.least_s(self.peaks)


def _times(w: W.Work, n: int) -> W.Work:
    return W.Work(bytes=w.bytes * n, flops=w.flops * n)
