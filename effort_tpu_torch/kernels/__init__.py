"""Hand-written Hopper kernels: wrappers, plain versions and the build.

Every kernel wrapper adds one to its entry of LAUNCHES each time it launches
its kernel on the card, and nowhere else (a call on CPU tensors runs the
plain version and counts nothing). A run shows that it went through the
kernels by zeroing the counts first and reading them after.
"""

LAUNCHES: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
