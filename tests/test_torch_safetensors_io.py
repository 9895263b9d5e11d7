"""The port's safetensors IO held against the JAX package's: the writers
give byte-identical files for the same tensors (sharded, BF16 as bits),
and each reader reads the other's files, on the native (C++ mmap) and the
Python paths. The JAX package's readers run on their Python path, so no
library is built under effort_tpu/."""

import filecmp
import os

import numpy as np
import pytest

from effort_tpu.runtime import safetensors_io as jax_io
from effort_tpu_torch.runtime import safetensors_io as port_io
from effort_tpu_torch.runtime._native_build import native_lib_path


def _tensors(seed: int = 0) -> dict:
    """Every dtype the format names, a few shapes, and a BF16 tensor as
    its uint16 bit pattern (name -> (array, bf16_bits))."""
    rng = np.random.default_rng(seed)
    bf = (rng.standard_normal((16, 8)).astype(np.float32).view(np.uint32)
          >> 16).astype(np.uint16)
    return {
        "a.weight": (rng.standard_normal((8, 16)).astype(np.float32), False),
        "b.weight": (rng.standard_normal((128, 4)).astype(np.float16),
                     False),
        "c.ids": (np.arange(100, dtype=np.int32), False),
        "d.big": (rng.standard_normal((64, 64)).astype(np.float32), False),
        "e.bf16": (bf, True),
        "f.u8": (rng.integers(0, 255, (3, 5, 7)).astype(np.uint8), False),
        "g.i8": (rng.integers(-127, 127, (33,)).astype(np.int8), False),
        "h.f64": (rng.standard_normal(5), False),
        "i.i64": (np.arange(-3, 3, dtype=np.int64), False),
        "j.scalar": (np.float32(2.5).reshape(()), False),
    }


def _write(mod, d, tensors, shard_bytes):
    w = mod.SafeTensorWriter(str(d), "testmodel", shard_bytes=shard_bytes)
    for k, (v, bf16) in tensors.items():
        w.add(k, v, bf16_bits=bf16)
    w.save()


@pytest.mark.parametrize("shard_bytes", [4096, 2 << 30])
def test_writers_byte_identical(tmp_path, shard_bytes):
    """The same tensors through both writers: the same file names (shards
    roll over at the same tensors) and the same bytes, index included."""
    tensors = _tensors()
    _write(jax_io, tmp_path / "jax", tensors, shard_bytes)
    _write(port_io, tmp_path / "port", tensors, shard_bytes)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert (len(files) > 2) == (shard_bytes == 4096), files
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _check(reader, tensors):
    assert set(reader.keys()) == set(tensors)
    for k, (v, bf16) in tensors.items():
        got = reader[k]
        np.testing.assert_array_equal(got, v, err_msg=k)
        assert got.dtype == v.dtype, k
        f32 = reader.get_f32(k)
        want = ((v.astype(np.uint32) << 16).view(np.float32) if bf16
                else v.astype(np.float32))
        np.testing.assert_array_equal(f32, want, err_msg=k)


@pytest.mark.parametrize("native", [True, False])
def test_port_reads_jax_files(tmp_path, native):
    """The port's MultiShardReader on JAX's shards (index and all), and its
    single-file reader on each shard, native and Python path."""
    tensors = _tensors(1)
    _write(jax_io, tmp_path, tensors, 4096)
    m = port_io.MultiShardReader(str(tmp_path), "testmodel")
    _check(m, tensors)
    assert all(r.native for r in m._readers.values())
    m.close()
    seen = {}
    for fn in sorted(set(m.weight_map.values())):
        r = port_io.SafeTensorReader(str(tmp_path / fn), use_native=native)
        assert r.native == native
        seen.update({k: (np.array(r[k]), np.array(r.get_f32(k)))
                     for k in r.keys()})
        r.close()
    for k, (v, bf16) in tensors.items():
        np.testing.assert_array_equal(seen[k][0], v, err_msg=k)
        want = ((v.astype(np.uint32) << 16).view(np.float32) if bf16
                else v.astype(np.float32))
        np.testing.assert_array_equal(seen[k][1], want, err_msg=k)


@pytest.mark.parametrize("native", [True, False])
def test_jax_reads_port_files(tmp_path, native):
    """JAX's reader (Python path) on the port's shards, and the port's
    single-file reader on each shard (native and Python path)."""
    tensors = _tensors(2)
    _write(port_io, tmp_path, tensors, 4096)
    assert (jax_io.MultiShardReader(str(tmp_path), "testmodel").weight_map
            == port_io.MultiShardReader(str(tmp_path),
                                        "testmodel").weight_map)
    shards = sorted(f for f in os.listdir(tmp_path)
                    if f.endswith(".safetensors"))
    seen = {}
    for fn in shards:
        jr = jax_io.SafeTensorReader(str(tmp_path / fn), use_native=False)
        pr = port_io.SafeTensorReader(str(tmp_path / fn), use_native=native)
        assert pr.native == native and jr.keys() == pr.keys()
        for k in jr.keys():
            np.testing.assert_array_equal(jr[k], pr[k])
            np.testing.assert_array_equal(jr.get_f32(k), pr.get_f32(k))
            seen[k] = np.array(jr[k])
        jr.close()
        pr.close()
    assert set(seen) == set(tensors)
    for k, (v, _) in tensors.items():
        np.testing.assert_array_equal(seen[k], v, err_msg=k)


def test_native_library_is_the_ports():
    """The mmap core comes from the port's own native/ build."""
    path = native_lib_path()
    assert path is not None
    assert os.sep + "effort_tpu_torch" + os.sep in path, path


def test_single_file_directory_and_missing(tmp_path):
    """A directory of bare .safetensors files (no index) is read through
    their headers; a directory with none raises FileNotFoundError."""
    tensors = _tensors(3)
    port_io.SafeTensorWriter._write_file(str(tmp_path / "model.safetensors"),
                                         tensors)
    _check(port_io.MultiShardReader(str(tmp_path)), tensors)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        port_io.MultiShardReader(str(empty))
