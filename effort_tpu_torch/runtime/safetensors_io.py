"""safetensors I/O: mmap'd lazy reader + multi-shard writer.

  - SafeTensorReader: lazy per-tensor reads backed by the C++ mmap core
    (native/safetensors.cc) with a pure-Python fallback; tensors surface as
    zero-copy numpy views over the mapping.
  - SafeTensorWriter / MultiShardReader: a multi-shard writer with a
    <model>.safetensors.index.json weight_map, and its reader.

numpy in and numpy out, as in the JAX package, so either package reads
the other's files and the writers give the same bytes. BF16 has no numpy
dtype: it is read and written as its uint16 bit pattern, and get_f32
widens it. Callers move arrays to a torch device themselves.

Format: 8-byte little-endian header length, JSON header mapping names to
{dtype, shape, data_offsets}, then the raw tensor bytes.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import struct
from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_, "U16": np.uint16, "U32": np.uint32,
}
_RDTYPES = {np.dtype(v): k for k, v in _DTYPES.items()}
# BF16 has no numpy dtype: surfaced as uint16 raw bits with bf16 flag.
_BF16 = "BF16"


def _native_lib():
    """Load the C++ mmap helper (native/libeffort_io.so), building it
    on first use when only the sources are present."""
    from effort_tpu_torch.runtime._native_build import native_lib_path
    path = native_lib_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.effort_mmap_open.restype = ctypes.c_void_p
        lib.effort_mmap_open.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_uint64)]
        lib.effort_mmap_ptr.restype = ctypes.c_void_p
        lib.effort_mmap_ptr.argtypes = [ctypes.c_void_p]
        lib.effort_mmap_close.argtypes = [ctypes.c_void_p]
        lib.effort_mmap_advise_sequential.argtypes = [ctypes.c_void_p]
        return lib
    except OSError:
        return None


_LIB = None


def _get_lib():
    global _LIB
    if _LIB is None:
        _LIB = _native_lib() or False
    return _LIB or None


class SafeTensorReader:
    """Lazy reader over one .safetensors file (zero-copy numpy views)."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        self._handle = None
        self._mm = None
        lib = _get_lib() if use_native else None
        if lib is not None:
            size = ctypes.c_uint64()
            h = lib.effort_mmap_open(path.encode(), ctypes.byref(size))
            if h:
                self._handle = h
                self._lib = lib
                ptr = lib.effort_mmap_ptr(h)
                buf = (ctypes.c_ubyte * size.value).from_address(ptr)
                self._view = np.frombuffer(buf, dtype=np.uint8)
        if self._handle is None:
            f = open(path, "rb")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            f.close()
            self._view = np.frombuffer(self._mm, dtype=np.uint8)
        (hlen,) = struct.unpack("<Q", bytes(self._view[:8]))
        self.header = json.loads(bytes(self._view[8:8 + hlen]))
        self.header.pop("__metadata__", None)
        self._data_off = 8 + hlen

    @property
    def native(self) -> bool:
        """True when the file is mapped by the C++ core, False on the
        Python fallback."""
        return self._handle is not None

    def keys(self):
        return list(self.header.keys())

    def info(self, name: str):
        return self.header[name]

    def __contains__(self, name):
        return name in self.header

    def __getitem__(self, name: str) -> np.ndarray:
        """Zero-copy view (bf16 returned as uint16 bit pattern)."""
        meta = self.header[name]
        b0, b1 = meta["data_offsets"]
        raw = self._view[self._data_off + b0:self._data_off + b1]
        dt = meta["dtype"]
        np_dt = np.uint16 if dt == _BF16 else _DTYPES[dt]
        arr = raw.view(np_dt).reshape(meta["shape"])
        return arr

    def get_f32(self, name: str) -> np.ndarray:
        """Tensor converted to float32 (handles BF16/F16)."""
        meta = self.header[name]
        arr = self[name]
        if meta["dtype"] == _BF16:
            out = np.zeros(arr.shape, np.uint32)
            out |= arr.astype(np.uint32) << 16
            return out.view(np.float32)
        return arr.astype(np.float32)

    def close(self):
        if self._handle is not None:
            self._lib.effort_mmap_close(self._handle)
            self._handle = None
        self._view = None
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # Zero-copy views handed out by __getitem__ are still alive;
                # the mapping is released when the last view is GC'd.
                pass
            self._mm = None


class MultiShardReader:
    """Reads a sharded checkpoint via its index.json weight_map, or every
    .safetensors file of a directory that has none."""

    def __init__(self, directory: str, model: Optional[str] = None):
        self.dir = directory
        idx = None
        for fn in sorted(os.listdir(directory)):
            if fn.endswith(".safetensors.index.json") and (
                    model is None or fn.startswith(model)):
                idx = os.path.join(directory, fn)
                break
        if idx is not None:
            with open(idx) as f:
                self.weight_map = json.load(f)["weight_map"]
        else:  # single-file checkpoint
            files = [fn for fn in sorted(os.listdir(directory))
                     if fn.endswith(".safetensors") and (
                         model is None or fn.startswith(model))]
            if not files:
                raise FileNotFoundError(f"no safetensors under {directory}")
            self.weight_map = {}
            for fn in files:
                r = SafeTensorReader(os.path.join(directory, fn))
                for k in r.keys():
                    self.weight_map[k] = fn
                r.close()
        self._readers: Dict[str, SafeTensorReader] = {}

    def keys(self):
        return list(self.weight_map.keys())

    def __contains__(self, name):
        return name in self.weight_map

    def _reader(self, name) -> SafeTensorReader:
        fn = self.weight_map[name]
        if fn not in self._readers:
            self._readers[fn] = SafeTensorReader(os.path.join(self.dir, fn))
        return self._readers[fn]

    def __getitem__(self, name) -> np.ndarray:
        return self._reader(name)[name]

    def get_f32(self, name) -> np.ndarray:
        return self._reader(name).get_f32(name)

    def close(self):
        for r in self._readers.values():
            r.close()
        self._readers.clear()


class SafeTensorWriter:
    """Multi-shard safetensors writer + index.json.

    Tensors are held until save(), which writes the shards (rolled over
    at shard_bytes) and the index."""

    def __init__(self, directory: str, model: str,
                 shard_bytes: int = 2 << 30):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.model = model
        self.shard_bytes = shard_bytes
        self._pending: Dict[str, np.ndarray] = {}
        self._pending_bytes = 0
        self._shards = []          # list of dicts name->tensor
        self.weight_map: Dict[str, str] = {}

    def add(self, name: str, tensor: np.ndarray, bf16_bits: bool = False):
        """bf16_bits: tensor is uint16 holding bf16 bit patterns."""
        self._pending[name] = (tensor, bf16_bits)
        self._pending_bytes += tensor.nbytes
        if self._pending_bytes >= self.shard_bytes:
            self._flush_shard()

    def _flush_shard(self):
        if not self._pending:
            return
        self._shards.append(self._pending)
        self._pending = {}
        self._pending_bytes = 0

    def save(self):
        self._flush_shard()
        n = len(self._shards)
        for i, shard in enumerate(self._shards):
            fn = f"{self.model}-{i+1:05d}-of-{n:05d}.safetensors"
            self._write_file(os.path.join(self.dir, fn), shard)
            for name in shard:
                self.weight_map[name] = fn
        with open(os.path.join(
                self.dir, f"{self.model}.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"format": "effort-tpu"},
                       "weight_map": self.weight_map}, f, indent=1)

    @staticmethod
    def _write_file(path: str, tensors):
        header = {}
        off = 0
        for name, (t, bf16) in tensors.items():
            dt = _BF16 if bf16 else _RDTYPES[np.dtype(t.dtype)]
            header[name] = {"dtype": dt, "shape": list(t.shape),
                            "data_offsets": [off, off + t.nbytes]}
            off += t.nbytes
        hjson = json.dumps(header).encode()
        pad = (-(len(hjson)) % 8)
        hjson += b" " * pad
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(hjson)))
            f.write(hjson)
            for name, (t, _) in tensors.items():
                f.write(np.ascontiguousarray(t).tobytes())
