"""Tracing / profiling hooks (the JAX package's utils/profiling.py, in
PyTorch's idiom).

  - trace(): context manager around torch.profiler.profile (CPU and, on
    the card, CUDA activities), writing a Chrome trace (chrome://tracing,
    Perfetto) into log_dir: per-kernel device timelines;
  - annotate() / mark(): the program's spans, at its layer boundaries.
    Each recorded span is a torch.profiler.record_function annotation (in
    the trace, on the kernels' clock) and an entry of an in-memory log on
    time.perf_counter() (recorded(), clear()). Spans are on while a
    profiler session is active or inside recording(); otherwise annotate
    does one flag check and returns a shared null context;
  - sass_dump(): what the compiler made of a kernel: `cuobjdump -sass` of
    the library kernels/_build.py built from csrc/<name>.cu (the JAX
    package's hlo_dump shows XLA's optimized HLO; the port's kernels are
    nvcc's, so their machine code is what there is to inspect);
  - warn_of_sync(): torch.cuda.set_sync_debug_mode("warn") inside the
    context, restored on exit: every operation that waits for the card
    warns (catching accidental per-token syncs in a decode loop).

Default output directories are under build/ at the root of the checkout.
"""

from __future__ import annotations

import collections
import contextlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OUT = Path(__file__).resolve().parents[2] / "build"


def _on_card() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          host_profiling: bool = True) -> Iterator[str]:
    """Capture a trace of everything run inside the context; on exit it is
    written to log_dir as trace_<time>_<pid>.json (Chrome trace format).
    host_profiling: record the host (CPU) activity too; the card's kernels
    are recorded whenever a card is present."""
    log_dir = str(_OUT / "trace") if log_dir is None else log_dir
    os.makedirs(log_dir, exist_ok=True)
    acts = []
    if host_profiling or not _on_card():
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if _on_card():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        if _on_card():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
                 f".json"))


# spans the log keeps; the oldest go first (about 100 MB of host memory
# when full)
LOG_MAX = 1 << 18


class SpanRecord(NamedTuple):
    """One span of the log: name, start and end (seconds on
    time.perf_counter(); t1 is None while the span is open), parent (the
    position in the same recorded() list of the span open around it, None
    at the top or when that span has left the log), rid (the request or
    key it belongs to, or None) and attrs (ints set by the code)."""
    name: str
    t0: float
    t1: Optional[float]
    parent: Optional[int]
    rid: object
    attrs: dict


class _Span:
    """An open span: the context annotate() returns when spans are on.
    `span[key] = n` sets an attribute before the span ends."""
    __slots__ = ("name", "rid", "attrs", "t0", "t1", "parent", "at", "_rf")

    def __init__(self, name: str, rid, attrs: dict):
        self.name, self.rid, self.attrs = name, rid, attrs
        self.t0 = self.t1 = self.parent = None

    def __setitem__(self, key: str, value: int) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "_Span":
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        _LOG.add(self, push=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        _LOG.pop()
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        return False


class _Off:
    """The shared null context of annotate() when spans are off: it is
    false, and ignores attributes set on it."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def __setitem__(self, key: str, value: int) -> None:
        pass


_OFF = _Off()


class _Log:
    """The spans recorded in this process, oldest first, at most maxlen;
    each span takes an index when it opens (its place among every span
    ever added), so a child names its parent before the parent ends.
    Open spans are kept a stack a thread."""

    def __init__(self, maxlen: int = LOG_MAX):
        self.spans = collections.deque(maxlen=maxlen)
        self.added = 0
        self.dropped = 0
        self.recording = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def _stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, span: _Span, push: bool) -> None:
        stack = self._stack()
        with self.lock:
            span.parent = stack[-1].at if stack else None
            span.at = self.added
            self.added += 1
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(span)
        if push:
            stack.append(span)

    def pop(self) -> None:
        self._stack().pop()


_LOG = _Log()


def annotate(name: str, rid=None, **attrs):
    """A span of the program around the `with` block: `name`, the request
    or key it serves (rid), int attributes (set here, or on the yielded
    span before it ends). On while a torch.profiler session is active or
    inside recording(): a record_function annotation (in the trace, on the
    kernels' clock) and an entry of the log (time.perf_counter(), the host
    clock). Off otherwise: one flag check, and a shared null context that
    reads no clock and calls nothing."""
    if not (_autograd_profiler._is_profiler_enabled or _LOG.recording):
        return _OFF
    return _Span(name, rid, attrs)


def mark(name: str, t0: float, t1: float, rid=None, **attrs) -> None:
    """Record a span whose start lies in an earlier call (t0, t1 on
    time.perf_counter()), under the span open now; the log only (a trace
    annotation cannot start in the past). On and off as annotate()."""
    if not (_autograd_profiler._is_profiler_enabled or _LOG.recording):
        return
    span = _Span(name, rid, attrs)
    span.t0, span.t1 = t0, t1
    _LOG.add(span, push=False)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans on inside the context, with no profiler session (for
    operators and tests); the log keeps what they record."""
    with _LOG.lock:
        _LOG.recording += 1
    try:
        yield
    finally:
        with _LOG.lock:
            _LOG.recording -= 1


def recorded() -> list:
    """The log's spans, oldest first, as SpanRecords."""
    with _LOG.lock:
        spans = list(_LOG.spans)
        first = _LOG.added - len(spans)
    return [SpanRecord(s.name, s.t0, s.t1,
                       s.parent - first if s.parent is not None
                       and s.parent >= first else None,
                       s.rid, dict(s.attrs)) for s in spans]


def dropped() -> int:
    """Spans the log's bound has dropped since the last clear()."""
    return _LOG.dropped


def clear() -> None:
    """Empty the log (spans open now stay open; their children name no
    parent)."""
    with _LOG.lock:
        _LOG.spans.clear()
        _LOG.dropped = 0


def sass_dump(name: str = "mxu_matvec",
              dump_dir: Optional[str] = None) -> str:
    """The SASS of the library built from csrc/<name>.cu (built first if
    missing), as `cuobjdump -sass` prints it; also written to
    dump_dir/<name>.sass.txt. Raises without a card or without the CUDA
    toolkit."""
    from effort_tpu_torch.kernels import _build
    if not _on_card():
        raise RuntimeError("sass_dump needs a CUDA device and the CUDA "
                           "toolkit (the kernels are built with nvcc)")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found (CUDA toolkit)")
    path = _build.library_paths()[name]
    if not path.exists():
        _build.build_all()
    txt = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    dump_dir = str(_OUT / "sass") if dump_dir is None else dump_dir
    os.makedirs(dump_dir, exist_ok=True)
    with open(os.path.join(dump_dir, f"{name}.sass.txt"), "w") as f:
        f.write(txt)
    return txt


@contextlib.contextmanager
def warn_of_sync():
    """Warn on every operation that waits for the card inside the context
    (torch.cuda.set_sync_debug_mode("warn"); the previous mode restored on
    exit). Without a card there is nothing to wait for, and it does
    nothing."""
    if not _on_card():
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)
