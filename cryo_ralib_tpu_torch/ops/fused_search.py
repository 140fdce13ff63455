"""The search kernel: wrapper of the hand-written CUDA kernel and its
plain PyTorch version.

``fused_search`` is the counterpart of ``cryo_ralib_tpu/ops/
fused_search.py::fused_search`` (the Pallas TPU kernel).  On a CUDA
tensor it launches ``csrc/search.cu`` (see the note at the top of that
file) or raises; on a CPU tensor it runs ``search_plain``, the plain
PyTorch version (``ops/search.py::rotational_shift_search``).  There is
no fallback between the two: a CUDA tensor never reaches the plain
version through this wrapper.

The kernel's variants and the TPU kernel variants they replace
(``cryo_ralib_tpu/ops/fused_search.py``, one body ``_kernel_banded2``
at :129 with static flags), each with its own launch counter in
``fused_search.launches``:

* ``search``: the default variant, mirrored and unmasked (:129);
* ``search_nomirror``: ``cfg.mirror=False``, the ``do_mirror=False``
  variant (:147-152, :181-183, :289-291, :505-507);
* ``search_masked`` / ``search_nomirror_masked``: ``angle_mask`` given,
  the ``has_mask=True`` variant (:162-167, :389-394, :439-443, :533-535);
  the returned row is unmasked (decode with ``refine=False``).

Any K runs in one launch, counted under its variant: the kernel's
ref-group loop replaces the ``fold=True`` finalize and the ref-axis
chunks (:356-424, :752-781, ``_merge_chunk`` :791).  Rings are
``ring_len=256`` uniform rings.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..config import AlignConfig
from ..kernels import load_library
from ..params import AlignParams
from .search import SearchResult, rotational_shift_search

RING_LEN = 256   # the kernel's angle count (its block has one thread each)
_NEG_INF = -3.0e38


def search_plain(images, ref_fw, params: AlignParams, cfg: AlignConfig,
                 shift_chunk: int = 8, angle_mask=None) -> SearchResult:
    """The kernel's plain PyTorch version (any device)."""
    return rotational_shift_search(images, ref_fw, params, cfg,
                                   shift_chunk=shift_chunk,
                                   angle_mask=angle_mask)


def variant(cfg: AlignConfig, masked: bool) -> str:
    """The launch-counter key of the kernel variant a search runs."""
    return ("search" + ("" if cfg.mirror else "_nomirror")
            + ("_masked" if masked else ""))


@lru_cache(maxsize=None)
def twiddle_table() -> np.ndarray:
    """(256,) f32 ``cos(2 pi j / 256)`` with the quarter turns exact, so
    the sin rows of bins 0 and 128 vanish exactly."""
    tab = np.cos(2.0 * np.pi * np.arange(RING_LEN) / RING_LEN)
    tab[np.abs(tab) < 1e-12] = 0.0
    return tab.astype(np.float32)


@lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (or load the cached build of) the search kernel."""
    lib = load_library("search", ["search.cu"])
    ptr = ctypes.c_void_p
    lib.cryo_search_launch.argtypes = (
        [ptr] * 8 + [ctypes.c_int] * 7 + [ptr] * 6 + [ptr])
    lib.cryo_search_launch.restype = ctypes.c_int
    lib.cryo_search_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.cryo_search_smem_bytes.restype = ctypes.c_longlong
    lib.cryo_search_error_string.argtypes = [ctypes.c_int]
    lib.cryo_search_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_search(images, ref_fw, params: AlignParams, cfg: AlignConfig,
                 angle_mask=None) -> SearchResult:
    """Search every (mirror, shift, ref, angle) candidate per particle.

    Args:
      images: (N, H, W) float32 particle stack.
      ref_fw: (K, R, 129) complex64 weighted ref ring spectra
        (``prepare_ref_spectra``).
      params: AlignParams; the accumulated shifts move the sampling centre.
      cfg:    AlignConfig; ``cfg.mirror=False`` drops the mirror channel.
      angle_mask: optional (256,) float32 additive angle mask
        (``delta_angle_mask``) on the device of ``images``, with at least
        one bin at 0.  The kernel's winning row is unmasked, the plain
        version's masked; decode either with ``refine=False``.
    Returns:
      SearchResult, on the device of ``images``.
    """
    if images.device.type == "cpu":
        return search_plain(images, ref_fw, params, cfg,
                            angle_mask=angle_mask)
    if images.device.type != "cuda":
        raise ValueError(f"no search for device {images.device}")
    if cfg.ring_len != RING_LEN or cfg.ring_scheme != "cuda":
        raise NotImplementedError(
            "the search kernel takes ring_len=256 uniform rings only")
    dev = images.device
    n, h, w = images.shape
    k = ref_fw.shape[0]
    r = cfg.ring_num
    s = cfg.n_shifts
    _check("images", images, torch.float32, (n, h, w), dev)
    _check("ref_fw", ref_fw, torch.complex64, (k, r, RING_LEN // 2 + 1), dev)
    _check("params.shift_x", params.shift_x, torch.float32, (n,), dev)
    _check("params.shift_y", params.shift_y, torch.float32, (n,), dev)
    if angle_mask is not None:
        _check("angle_mask", angle_mask, torch.float32, (RING_LEN,), dev)
        if not bool((angle_mask > _NEG_INF).any()):
            raise ValueError("angle_mask allows no angle bin")
    if 2 * s * k * RING_LEN >= 2 ** 31:
        raise ValueError("shift grid x refs too large for the kernel's "
                         "int32 priority index")

    lib = build()
    smem = lib.cryo_search_smem_bytes(r, int(cfg.mirror), k)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"ring_num={r} needs {smem} B of shared memory per "
                         f"block, the device allows {limit}")

    coords = torch.as_tensor(cfg.polar_coords, device=dev)
    shifts = torch.as_tensor(cfg.shifts, device=dev)
    twiddle = torch.as_tensor(twiddle_table(), device=dev)
    ref_ri = torch.view_as_real(ref_fw)
    out_val = torch.empty(n, dtype=torch.float32, device=dev)
    out_row = torch.empty((n, RING_LEN), dtype=torch.float32, device=dev)
    out_i = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if n == 0:
        return SearchResult(out_val, out_row, *out_i)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cryo_search_launch(
            images.data_ptr(), params.shift_x.data_ptr(),
            params.shift_y.data_ptr(), coords.data_ptr(), shifts.data_ptr(),
            ref_ri.data_ptr(), twiddle.data_ptr(),
            None if angle_mask is None else angle_mask.data_ptr(),
            n, h, w, r, s, k, int(cfg.mirror),
            out_val.data_ptr(), out_row.data_ptr(),
            *[t.data_ptr() for t in out_i], stream)
    if rc != 0:
        raise RuntimeError("search kernel launch failed: "
                           + lib.cryo_search_error_string(rc).decode())
    fused_search.launches[variant(cfg, angle_mask is not None)] += 1
    aidx, sidx, ref, mirror = out_i
    return SearchResult(out_val, out_row, aidx, sidx, ref, mirror)


def reset_launches():
    """Set every launch counter to 0."""
    for key in fused_search.launches:
        fused_search.launches[key] = 0


fused_search.launches = dict.fromkeys(
    ("search", "search_nomirror", "search_masked", "search_nomirror_masked"),
    0)
