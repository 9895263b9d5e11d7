"""The device's idle share of the traced window: one minus the union of
every device operation's span over the window's own wall span."""


def read(r):
    if not r.ops:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
