"""The card's idle share of the traced window under the scheduler's calls
into the caller's code (batcher.callback spans: on_token and the done
callbacks of an admission or of a step), in %."""

from harness.program_spans import idle_under


def read(r):
    return idle_under(r, "batcher.callback")
