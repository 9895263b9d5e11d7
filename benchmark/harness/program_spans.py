"""The program's own spans, as the per-layer readers read them.

The port records spans at its layer boundaries (effort_tpu_torch's
utils/profiling.py: annotate, mark) while a profiler session is active,
as a traced run's window is. Each span is both a trace annotation (in
r.trace.notes, on the kernels' clock) and an entry of the program's
in-memory log on time.perf_counter(), the clock of the benchmark's own
Spans. A program without those spans leaves both empty, and every helper
here then returns nothing.
"""

from __future__ import annotations


def logged(r, names) -> list:
    """The program's logged spans of `names` that lie inside the
    benchmark's window span."""
    w = r.run.spans.spans.get("window")
    if not w:
        return []
    try:
        from effort_tpu_torch.utils import profiling
        spans = profiling.recorded()
    except (ImportError, AttributeError):
        return []
    s0, s1 = w[-1]
    return [s for s in spans if s.name in names and s.t1 is not None
            and s0 <= s.t0 and s.t1 <= s1]


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_us(r) -> list:
    """The card's idle intervals inside the traced window: the window less
    the union of its device operations (idle_share's complement)."""
    busy = _merged((max(a, r.t0), min(b, r.t1)) for _, a, b in r.ops)
    gaps, end = [], r.t0
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if r.t1 > end:
        gaps.append((end, r.t1))
    return gaps


def idle_under(r, name: str):
    """The card's idle time inside the window that any trace annotation
    `name` covers (each such span, not only the innermost), as % of the
    window; None where the trace holds no such annotation."""
    spans = [(max(a, r.t0), min(b, r.t1)) for n, a, b in r.trace.notes
             if n == name and b > r.t0 and a < r.t1]
    if not spans:
        return None
    cover = _merged(spans)
    idle, i = 0.0, 0
    for a, b in idle_us(r):
        while i < len(cover) and cover[i][1] <= a:
            i += 1
        j = i
        while j < len(cover) and cover[j][0] < b:
            idle += min(b, cover[j][1]) - max(a, cover[j][0])
            j += 1
    return 100.0 * idle / (r.t1 - r.t0)

