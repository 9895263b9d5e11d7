"""Active slots a batched step, the mean over the program's batcher.step
spans in the traced window (their live_slots attribute)."""

from harness.program_spans import logged


def read(r):
    spans = logged(r, ("batcher.step",))
    if not spans:
        return None
    return sum(s.attrs["live_slots"] for s in spans) / len(spans)
