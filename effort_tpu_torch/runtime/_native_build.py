"""Locate (and if needed, build) the C++ host IO library.

The native components (native/safetensors.cc, the mmap reader, and
native/tokenizer.cc, the BPE encoder) compile into one libeffort_io.so in
this package's own native/ directory. The .so is a build artifact, not
committed: on first use a `make` runs, so a fresh checkout gets the native
path instead of running the Python fallbacks forever. Any failure (no
compiler, read-only tree) falls back to Python and is stamped
(native/.build_failed), so later processes skip the doomed make instead of
paying for it again. Every first use takes an flock, so no process races
make on the same output or loads a library another is still writing; a
.so that exists but cannot be loaded (torn by a crashed build) is removed
and stamped.

This is host IO, not a device kernel: the CUDA sources are built by
kernels/_build.py.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")

_CHECKED = False
_PATH: str | None = None


def _loadable(path: str) -> bool:
    try:
        ctypes.CDLL(path)
        return True
    except OSError:
        return False


def _stamp_failure(why: str) -> None:
    try:
        with open(os.path.join(NATIVE_DIR, ".build_failed"), "w") as f:
            f.write(why[-2000:])
    except OSError:
        pass


def _build_or_check(path: str, stamp: str) -> None:
    """Under the lock: build when the library is missing (and no failure is
    stamped); remove and stamp a library that does not load."""
    if (not os.path.exists(path) and not os.path.exists(stamp)
            and os.path.exists(os.path.join(NATIVE_DIR, "Makefile"))):
        r = subprocess.run(["make", "-C", NATIVE_DIR], timeout=120,
                           capture_output=True, check=False)
        if r.returncode != 0:
            _stamp_failure(r.stderr.decode("utf-8", "replace"))
    if os.path.exists(path) and not _loadable(path):
        # a torn artifact (a crashed build): remove it so the failure is
        # visible and can be retried, and stamp why
        _stamp_failure("built .so failed to load; removed")
        os.remove(path)


def native_lib_path() -> str | None:
    """Absolute path of libeffort_io.so, building it once if possible;
    None when the Python fallbacks are in use. Every process checks the
    library under the build lock, so none reads it half written."""
    global _CHECKED, _PATH
    if _CHECKED:
        return _PATH
    _CHECKED = True
    path = os.path.join(NATIVE_DIR, "libeffort_io.so")
    stamp = os.path.join(NATIVE_DIR, ".build_failed")
    try:
        with open(os.path.join(NATIVE_DIR, ".build_lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)       # serialize builders
            _build_or_check(path, stamp)
    except (OSError, subprocess.SubprocessError) as e:
        _stamp_failure(repr(e))
    _PATH = path if os.path.exists(path) and _loadable(path) else None
    return _PATH
