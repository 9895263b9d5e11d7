"""The whole traced window's share of the card's peak: the least time
everything its steps need takes at the data sheet's peaks (the effort
products the reference selection covers, attention over the live keys
and values, the int8 head, embeddings, norms and router) over the
window's wall time."""


def read(r):
    if not r.steps:
        return None
    return 100.0 * r.least_s(r.step_work()) / r.window_s
