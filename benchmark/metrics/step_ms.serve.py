"""Host ms per batched step (BatchEngine.step: one replay of the captured
step, ending in the host read of the picks), over the traced window's
steps."""


def read(r):
    spans = r.host_spans("step")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
