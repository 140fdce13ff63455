"""Build and load the package's hand-written CUDA kernels.

Each kernel library is compiled by ``nvcc`` for Hopper (``sm_90a``) at
first use, from the ``csrc/`` sources in this checkout, into a shared
library with a plain C interface that ``ctypes`` loads.  Builds land in
``cryo_ralib_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and flags, so a rebuilt source never loads a stale library.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# name -> {"seconds", "cached", "ptxas"}; a cached build's ptxas report
# is the one kept beside its library
build_log: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA "
                           "kernels for sm_90a); set CUDA_HOME")
    return path


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>_<hash>.so`` from the given
    ``csrc/`` file names."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    report = so.with_suffix(".ptxas")
    t0 = time.perf_counter()
    cached = so.exists()
    ptxas = report.read_text() if cached and report.exists() else ""
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, paths)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        ptxas = proc.stderr
        report.write_text(ptxas)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "cached": cached, "ptxas": ptxas}
    return lib
