"""Host spans and the device trace.

Spans: the benchmark's own host-clock intervals around its calls into the
program (a turn, an admission, a batched step, the window). In a traced
run each span is also a torch.profiler annotation, so it lands in the
trace on the kernels' clock.

Trace: torch.profiler over the traced window, exported as a Chrome trace
and read back as plain lists: the device operations (kernels, copies,
sets) and the host annotations, each (name, start_us, end_us).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock spans by name: spans[name] = [(t0, t1), ...] seconds."""

    def __init__(self, annotate: bool = False):
        self.spans: dict = {}
        self.annotate = annotate

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.annotate:
            import torch
            rf = torch.profiler.record_function(name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.setdefault(name, []).append(
                    (t0, time.perf_counter()))

    def wrap(self, obj, method: str, name: str) -> None:
        """Record a span around every call of obj.method (on the instance:
        the program's code is not touched)."""
        fn = getattr(obj, method)

        def timed(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        setattr(obj, method, timed)


class Trace:
    """Device operations and host annotations of one profiled window,
    times in microseconds on the profiler's clock."""

    def __init__(self, ops: list, notes: list):
        self.ops = sorted(ops, key=lambda e: e[1])     # (name, t0, t1)
        self.notes = notes                             # (name, t0, t1)

    @staticmethod
    def from_chrome(path: str, device_cats=DEVICE_CATS) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        ops, notes = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e["ts"])
            rec = (e.get("name", ""), t0, t0 + float(e.get("dur", 0.0)))
            if cat in device_cats:
                ops.append(rec)
            elif cat == "user_annotation":
                notes.append(rec)
        return Trace(ops, notes)

    def window(self, name: str = "window") -> tuple:
        """(t0, t1) of the one host annotation `name`."""
        w = [n for n in self.notes if n[0] == name]
        if len(w) != 1:
            raise RuntimeError(f"{len(w)} annotations {name!r} in the trace")
        return w[0][1], w[0][2]

    def in_window(self, name: str = "window") -> list:
        t0, t1 = self.window(name)
        return [o for o in self.ops if o[1] >= t0 and o[1] < t1]


def union_us(intervals) -> float:
    """Length of the union of (t0, t1) intervals: overlaps count once."""
    total, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def idle_gaps(ops: list, notes: list, t0: float, t1: float) -> list:
    """Gaps between device operations inside [t0, t1], each labelled by
    the innermost host annotation (other than the window) covering its
    start: [(label, us)], longest first."""
    gaps, end = [], t0
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        a, b = max(a, t0), min(b, t1)
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    inner = [n for n in notes if n[0] != "window"]
    out = []
    for a, b in gaps:
        cover = [n for n in inner if n[1] <= a < n[2]]
        label = min(cover, key=lambda n: n[2] - n[1])[0] if cover else "host"
        out.append((label, b - a))
    return sorted(out, key=lambda g: -g[1])


def breakdown(ops: list, notes: list, t0: float, t1: float) -> dict:
    """The ten device operations that took the most time, by name, and
    the ten longest idle gaps by what the host was doing, in seconds."""
    by = {}
    for name, a, b in ops:
        by[name] = by.get(name, 0.0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    gaps = idle_gaps(ops, notes, t0, t1)[:10]
    return {"device_ops": [[n, s * 1e-6] for n, s in top],
            "idle_gaps": [[n, s * 1e-6] for n, s in gaps]}


@contextlib.contextmanager
def profiled(enabled: bool, out: dict, on_card: bool = True):
    """torch.profiler over the block when enabled; afterwards out["trace"]
    holds the Trace read from its exported Chrome trace (a temporary file
    under TMPDIR, removed once read). Off the card (the benchmark's own
    tests) the host's operators stand in for the device's."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["trace"] = Trace.from_chrome(
            path, DEVICE_CATS if on_card else ("cpu_op",))
    finally:
        os.remove(path)
