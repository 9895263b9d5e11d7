"""Build the CUDA sources under csrc/ with nvcc, at first use.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, loaded through ctypes (no PyTorch headers, so a source builds in
seconds). All sources that need building are compiled at once, one nvcc
process each. A library's file name carries a hash of its source, of the
csrc headers and of the flags, so an edited source is rebuilt and an
unchanged one is reused; a lock file serialises concurrent builders.
Libraries go to build/kernels/ at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC")
_BUILD_TIMEOUT_S = 600

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ with the CUDA toolkit on first use")
    return path


def library_paths() -> dict:
    """name -> path of the library each csrc/*.cu builds into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(_SRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    out = {}
    for src in sorted(_SRC_DIR.glob("*.cu")):
        hs = h.copy()
        hs.update(src.read_bytes())
        out[src.stem] = BUILD_DIR / f"lib{src.stem}-{hs.hexdigest()[:16]}.so"
    return out


def build_all() -> dict:
    """Build every library that is missing, all nvcc runs at once; return
    {name: compiler output} for the ones built now. Raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {}
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name, so in library_paths().items():
            if so.exists():
                continue
            tmp = so.with_name(so.name + ".tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(_SRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            try:
                log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                log += f"\n(nvcc timed out after {_BUILD_TIMEOUT_S} s)"
            logs[name] = log
            if proc.returncode == 0:
                os.replace(tmp, so)
            else:
                failed.append(f"--- {name}.cu ---\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from csrc/<name>.cu (built if missing)."""
    if name not in _LIBS:
        path = library_paths()[name]
        if not path.exists():
            build_all()
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
