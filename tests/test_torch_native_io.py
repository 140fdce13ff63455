"""The port's native (C++) threaded MRC reader (``cryo_ralib_tpu_torch/
native``) against the JAX package's bindings of the same library and
against the numpy reader, on the same ``.mrcs`` files.

``stack_info`` is equal, and ``read_slices`` and ``read_mrc(native=True)``
are bitwise equal to ``read_mrc(native=False)``.  Skipped (inside a
fixture) where the library cannot be built, as tests/test_native_io.py
is.  The build itself writes a temporary file and renames it into place,
so a concurrent loader never maps a half-written library.
"""

import os

import numpy as np
import pytest

from cryo_ralib_tpu import native as jax_native
from cryo_ralib_tpu_torch import native
from cryo_ralib_tpu_torch.io.mrc import HEADER_SIZE, read_mrc, write_mrc


@pytest.fixture()
def lib():
    if not native.available():
        pytest.skip("native library not built (no make/g++)")
    return native


def test_stack_info_equals_jax(lib, tmp_path, rng):
    path = str(tmp_path / "s.mrcs")
    write_mrc(path, rng.standard_normal((7, 24, 16)).astype(np.float32))
    info = lib.stack_info(path)
    assert info == (16, 24, 7, 2, HEADER_SIZE)
    if jax_native.available():
        assert info == jax_native.stack_info(path)


def test_read_slices_equal_numpy(lib, tmp_path, rng):
    path = str(tmp_path / "s.mrcs")
    data = rng.standard_normal((130, 32, 32)).astype(np.float32)
    write_mrc(path, data)
    got = lib.read_slices(path, np.arange(130))
    np.testing.assert_array_equal(got, read_mrc(path, native=False))
    idx = np.array([5, 99, 0, 77, 3])
    np.testing.assert_array_equal(lib.read_slices(path, idx),
                                  read_mrc(path, idx, native=False))
    if jax_native.available():
        np.testing.assert_array_equal(lib.read_slices(path, idx),
                                      jax_native.read_slices(path, idx))


@pytest.mark.parametrize("mode,dtype", [(1, np.int16), (6, np.uint16),
                                        (0, np.int8), (12, np.float16)])
def test_read_modes_equal_numpy(lib, tmp_path, rng, mode, dtype):
    path = str(tmp_path / f"m{mode}.mrcs")
    if mode == 12:
        raw = rng.standard_normal((5, 8, 8)).astype(np.float16)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max, (5, 8, 8)).astype(dtype)
    header = np.zeros(HEADER_SIZE // 4, "<i4")
    header[0:3] = (8, 8, 5)
    header[3] = mode
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(raw.tobytes())
    np.testing.assert_array_equal(lib.read_slices(path, np.arange(5)),
                                  read_mrc(path, native=False))
    np.testing.assert_array_equal(read_mrc(path, native=True),
                                  raw.astype(np.float32))


def test_read_mrc_dispatches_native(lib, tmp_path, rng, monkeypatch):
    """``native=True`` and, from 64 slices, ``native=None`` read through
    the library; fewer slices read with numpy; all give the same bits."""
    path = str(tmp_path / "s.mrcs")
    data = rng.standard_normal((70, 16, 16)).astype(np.float32)
    write_mrc(path, data)
    calls = []
    real = lib.read_slices
    monkeypatch.setattr(lib, "read_slices",
                        lambda p, i: calls.append(len(i)) or real(p, i))
    np.testing.assert_array_equal(read_mrc(path, native=True), data)
    np.testing.assert_array_equal(read_mrc(path), data)
    np.testing.assert_array_equal(read_mrc(path, np.arange(10)), data[:10])
    np.testing.assert_array_equal(read_mrc(path, native=False), data)
    assert calls == [70, 70]


def test_error_paths(lib, tmp_path):
    with pytest.raises(OSError):
        lib.stack_info(str(tmp_path / "missing.mrcs"))
    path = str(tmp_path / "s.mrcs")
    write_mrc(path, np.zeros((2, 8, 8), np.float32))
    with pytest.raises(OSError):
        lib.read_slices(path, [5])


def test_build_renames_a_finished_library_into_place(tmp_path):
    """The build goes to a temporary name and is renamed: the target is
    a complete library (loadable) and no temporary file is left."""
    import ctypes
    import shutil
    import subprocess

    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no make/g++")
    src = native._native_dir()
    for name in ("Makefile", "stack_io.cpp"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    so = str(tmp_path / "libcryoralib_io.so")
    try:
        native._build(str(tmp_path), so)
    except subprocess.CalledProcessError as err:
        pytest.skip(f"the library does not build here: {err}")
    assert ctypes.CDLL(so).cr_version() > 0
    assert sorted(os.listdir(tmp_path)) == ["Makefile",
                                            "libcryoralib_io.so",
                                            "stack_io.cpp"]
