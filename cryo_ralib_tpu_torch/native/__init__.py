"""ctypes bindings for the native (C++) threaded MRC stack reader.

A copy of ``cryo_ralib_tpu/native/__init__.py``: it loads the same
``native/libcryoralib_io.so``, built from ``native/stack_io.cpp`` by
``native/Makefile``.  The library is built on demand and cached; the
caller falls back to the numpy reader (``io/mrc.py``) when no compiler
is available.  This is host I/O: no device work depends on it.

One change from the original: the build writes a temporary file
(``make OUT=<tmp>``, a command-line variable overriding the Makefile's)
and renames it into place, so that a process loading the library while
another builds it never maps a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_LIB_NAME = "libcryoralib_io.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


def _build(ndir: str, so: str) -> None:
    """``make`` into a temporary name in ``ndir``, then rename it to
    ``so`` (atomic on one file system)."""
    fd, tmp = tempfile.mkstemp(prefix=".build_", suffix=".so", dir=ndir)
    os.close(fd)
    try:
        # the empty file would be "up to date" for make: remove it first
        os.unlink(tmp)
        subprocess.run(["make", "-C", ndir, f"OUT={os.path.basename(tmp)}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        ndir = _native_dir()
        so = os.path.join(ndir, _LIB_NAME)
        if not os.path.exists(so) and os.path.exists(
                os.path.join(ndir, "Makefile")):
            try:
                _build(ndir, so)
            except (OSError, subprocess.SubprocessError):
                return None
        if not os.path.exists(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.cr_stack_info.restype = ctypes.c_long
        lib.cr_stack_info.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_long)]
        lib.cr_read_slices.restype = ctypes.c_long
        lib.cr_read_slices.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        lib.cr_version.restype = ctypes.c_long
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def stack_info(path: str):
    """(nx, ny, nz, mode, data_offset) via the native header parser."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = (ctypes.c_long * 5)()
    rc = lib.cr_stack_info(path.encode(), out)
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc), path)
    return tuple(out)


def read_slices(path: str, indices) -> np.ndarray:
    """Threaded read of arbitrary z-slices of an MRC stack -> (N, H, W)
    float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    nx, ny, _nz, _mode, _off = stack_info(path)
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
    out = np.empty((idx.shape[0], ny, nx), np.float32)
    rc = lib.cr_read_slices(
        path.encode(),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ctypes.c_long(idx.shape[0]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc), path)
    return out
