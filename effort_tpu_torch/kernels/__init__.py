"""Hand-written Hopper kernels: wrappers, plain versions and the build.

Every kernel wrapper adds one to its entry of LAUNCHES each time it launches
its kernel on the card, and nowhere else (a call on CPU tensors runs the
plain version and counts nothing). A run shows that it went through the
kernels by zeroing the counts first and reading them after.

A captured CUDA graph (models/graphs.StepGraph) launches its kernels with
no wrapper call, so it keeps its own count: the wrappers' launches while it
was captured (launches_since), taken back from LAUNCHES because a capture
launches nothing (with those of the eager warm-up step before it, which
is set-up), and added again on every replay (add_launches).
"""

LAUNCHES: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches_since(before: dict) -> dict:
    """The launches counted since the snapshot `before` (dict(LAUNCHES)),
    by kernel; kernels with none are left out."""
    return {name: n - before.get(name, 0) for name, n in LAUNCHES.items()
            if n != before.get(name, 0)}


def add_launches(delta: dict) -> None:
    """Count the launches of `delta` (a replayed graph's)."""
    for name, n in delta.items():
        LAUNCHES[name] += n
