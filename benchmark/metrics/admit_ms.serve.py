"""Host ms per admission (BatchEngine.admit: the prompt's prefill, K2 at
T = prompt and K3; each call ends in a host read of its first token, so
it is synchronous), over the traced window's admissions."""


def read(r):
    spans = r.host_spans("admit")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
