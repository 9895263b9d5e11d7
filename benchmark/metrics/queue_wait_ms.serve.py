"""Host ms a request waits in the scheduler's queue (ContinuousBatcher:
from submit to the start of its admission, the program's batcher.queued
spans), the mean over the requests both submitted and admitted inside the
traced window, so each wait is whole on the program's own clock."""

from harness.program_spans import logged


def read(r):
    spans = logged(r, ("batcher.queued",))
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)
