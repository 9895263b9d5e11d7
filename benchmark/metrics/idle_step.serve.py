"""The card's idle share of the traced window under the program's batched
steps (batcher.step spans: BatchEngine.step's replay and the host read of
its picks), in %."""

from harness.program_spans import idle_under


def read(r):
    return idle_under(r, "batcher.step")
