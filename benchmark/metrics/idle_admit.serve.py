"""The card's idle share of the traced window under the program's
admissions (batcher.admit spans: BatchEngine.admit's left-pad upload, its
eager prefill's launches, the first token's host read), in %."""

from harness.program_spans import idle_under


def read(r):
    return idle_under(r, "batcher.admit")
