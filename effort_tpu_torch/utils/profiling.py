"""Tracing / profiling hooks (the JAX package's utils/profiling.py, in
PyTorch's idiom).

  - trace(): context manager around torch.profiler.profile (CPU and, on
    the card, CUDA activities), writing a Chrome trace (chrome://tracing,
    Perfetto) into log_dir: per-kernel device timelines;
  - annotate(): a named span (torch.profiler.record_function, plus an NVTX
    range on the card) for host-side regions in the trace;
  - sass_dump(): what the compiler made of a kernel: `cuobjdump -sass` of
    the library kernels/_build.py built from csrc/<name>.cu (the JAX
    package's hlo_dump shows XLA's optimized HLO; the port's kernels are
    nvcc's, so their machine code is what there is to inspect);
  - StepTimer: the prep/eval split of the reference's per-token print
    (eval waits for the device: dispatch is asynchronous);
  - warn_of_sync(): torch.cuda.set_sync_debug_mode("warn") inside the
    context, restored on exit: every operation that waits for the card
    warns (catching accidental per-token syncs in a decode loop).

Default output directories are under build/ at the root of the checkout.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

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


@contextlib.contextmanager
def annotate(name: str):
    """Host-side span annotation visible in the trace timeline (and, on
    the card, as an NVTX range)."""
    with torch.profiler.record_function(name):
        if _on_card():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


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


class StepTimer:
    """prep/eval split timer, the analog of the reference's per-token
    "prep ms / eval ms / tps" print: prep = host time before dispatch,
    eval = until the device is done (synchronized on exit)."""

    def __init__(self):
        self.prep_s = 0.0
        self.eval_s = 0.0
        self.steps = 0

    @contextlib.contextmanager
    def prep(self):
        t0 = time.perf_counter()
        yield
        self.prep_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def eval(self):
        t0 = time.perf_counter()
        yield
        if _on_card():
            torch.cuda.synchronize()
        self.eval_s += time.perf_counter() - t0
        self.steps += 1

    def summary(self, n_layers_norm: int = 32) -> str:
        n = max(1, self.steps)
        tps = n / max(self.eval_s, 1e-9)
        return (f"prep {self.prep_s / n * 1e3:.1f} ms, "
                f"eval {self.eval_s / n * 1e3:.1f} ms/token, "
                f"{tps:.1f} tps")


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
