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
  the returned row is unmasked (decode with ``refine=False``);
* ``search_shc`` / ``search_shc_nomirror``: ``fused_search_shc``, the SHC
  pick of ``rotational_shift_search_shc`` on the kernel's candidates,
  which no TPU kernel has (the JAX package runs SHC on its plain search);
  on a CPU tensor it runs that plain search.

Any K runs in one launch, counted under its variant, and under its
variant and K in ``fused_search.launches_by_k`` (``(variant, K)`` keys,
for a caller that must know which K a path launched): the kernel's
ref-group loop replaces the ``fold=True`` finalize and the ref-axis
chunks (:356-424, :752-781, ``_merge_chunk`` :791).  Rings are
``ring_len=256`` uniform rings, full (mode "F") or half (mode "H"): the
kernel reads its sample angles from ``polar_tables``, which span pi at
mode H, where the TPU kernel gates itself off for its half-plane window
(:676-679).

``fused_search_stage`` launches the TPU kernel's ablation stages
(``stage`` in {no_ccf, sample_only, no_yred}, :221-233, :329-348) for
``tools/torch_search_ablate.py``, with counters of their own in
``fused_search_stage.launches``; ``fused_search`` never reaches them.
``kernel_plan`` reports a launch's shifts per group, whether the image
is staged in shared memory, and the block's shared memory;
``launch_plan`` the same from its CPU copy, and ``kernel_gate`` the one
rule of what the kernel runs, which ``models/steps.py::resolve_route``
reads once per job and ``_launch`` at every launch.  The ``plan_*``
functions are a CPU model of the kernel's FFT plan for the tests; the
search never calls them.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import AlignConfig
from ..kernels import load_library
from ..params import AlignParams
from .search import (SearchResult, plain_shift_chunk, rotational_shift_search,
                     rotational_shift_search_shc, search_tables)

RING_LEN = 256   # the kernel's angle count (its block has one thread each)
_NEG_INF = -3.0e38


def search_plain(images, ref_fw, params: AlignParams, cfg: AlignConfig,
                 shift_chunk: int | None = None,
                 angle_mask=None) -> SearchResult:
    """The kernel's plain PyTorch version (any device); ``shift_chunk``
    defaults to the most shifts per pass that ``PLAIN_SAMPLE_BUDGET``
    holds (``plain_shift_chunk``)."""
    if shift_chunk is None:
        shift_chunk = plain_shift_chunk(images.shape[0], cfg)
    return rotational_shift_search(images, ref_fw, params, cfg,
                                   shift_chunk=shift_chunk,
                                   angle_mask=angle_mask)


def variant(cfg: AlignConfig, masked: bool, shc: bool = False) -> str:
    """The launch-counter key of the kernel variant a search runs (``shc``:
    the SHC pick, which is never masked)."""
    return ("search" + ("_shc" if shc else "")
            + ("" if cfg.mirror else "_nomirror")
            + ("_masked" if masked else ""))


@lru_cache(maxsize=None)
def twiddle_table() -> np.ndarray:
    """(256,) f32 ``cos(2 pi j / 256)`` with the quarter turns exact."""
    tab = np.cos(2.0 * np.pi * np.arange(RING_LEN) / RING_LEN)
    tab[np.abs(tab) < 1e-12] = 0.0
    return tab.astype(np.float32)


def polar_tables(cfg: AlignConfig) -> tuple[np.ndarray, np.ndarray]:
    """(L, 2) f64 ``(cos, sin)`` of the sample angles and (R,) f64 ring
    radii, from which the kernel computes each polar offset as
    ``f32(cos * radius)``: the expressions of ``cfg.polar_coords`` before
    its cast to f32, so the offsets are bitwise the same."""
    j = np.arange(cfg.ring_len, dtype=np.float64)[None, :]
    span = 2.0 * math.pi if cfg.mode == "F" else math.pi
    ang = j / float(cfg.ring_len) * span
    return (np.ascontiguousarray(np.stack([np.cos(ang), np.sin(ang)],
                                          axis=-1)[0]),
            np.ascontiguousarray(cfg.radii, dtype=np.float64))


@lru_cache(maxsize=None)
def fft_twiddles() -> np.ndarray:
    """(16, 16, 2) f32: entry [k1, j] is ``W256^(j k1)`` =
    ``(cos, -sin)(2 pi j k1 / 256)``, the kernel's 256-point twiddles.
    Laid out k1-major: thread j of an FFT loads column j, and a
    half-warp reads 16 consecutive entries.  Taken from
    ``twiddle_table`` (``-sin(x) = cos(x + pi/2)``), so the quarter turns
    are exact."""
    tab = twiddle_table()
    e = np.outer(np.arange(16), np.arange(16))     # [k1, j] -> j k1
    return np.ascontiguousarray(np.stack(
        [tab[e % RING_LEN], tab[(e + RING_LEN // 4) % RING_LEN]], axis=-1))


# ---- a CPU model of the kernel's FFT plan (csrc/search.cu, steps a-c).
# It follows the kernel's index maps on the same tables: rings packed two
# by two (``ring_pairs``), the 16 x 16 plan (a 16-point DFT over each
# stride-16 column, the twiddles, the transpose, a 16-point DFT over each
# row), the split through the partner thread's registers, the (DC,
# Nyquist) slot, the ccf's row order and the packing of two real rows
# into one complex inverse.  Tests hold it against torch.fft; the search
# never calls it.

_C1, _S1, _H = 0.92387953251128674, 0.38268343236508978, 0.70710678118654757


def _w16(sign: int) -> torch.Tensor:
    """(4, 4) complex64 ``W16^(n2 k1)`` [k1, n2], the kernel's constants,
    with W16^4 an exact quarter turn."""
    cs = {0: (1.0, 0.0), 1: (_C1, _S1), 2: (_H, _H), 3: (_S1, _C1),
          4: (0.0, 1.0), 6: (-_H, _H), 9: (-_C1, -_S1)}
    w = [[complex(cs[n2 * k1][0], sign * cs[n2 * k1][1]) for n2 in range(4)]
         for k1 in range(4)]
    return torch.tensor(np.array(w, np.complex64))


def _dft16(x: torch.Tensor, sign: int) -> torch.Tensor:
    """The kernel's 16-point DFT over the last axis (complex64): n =
    n2 + 4 n1, k = k1 + 4 k2; 4-point DFTs over n1, twiddles
    W16^(n2 k1), 4-point DFTs over n2."""
    w4 = torch.tensor(np.array([[1, sign * 1j, -1, -sign * 1j][(a * b) % 4]
                                for a in range(4) for b in range(4)],
                               np.complex64).reshape(4, 4))
    v = x.reshape(*x.shape[:-1], 4, 4)                       # [n1, n2]
    t = torch.einsum("...ab,ak->...kb", v, w4) * _w16(sign)  # [k1, n2]
    out = torch.einsum("...kb,bc->...ck", t, w4)             # [k2, k1]
    return out.reshape(x.shape)


def _fft256(z: torch.Tensor, sign: int) -> torch.Tensor:
    """(P, 256) complex64 -> (P, 16, 16) [thread k1, register k2] =
    Z[k1 + 16 k2]: thread j's column z[16 n1 + j], its 16-point DFT, the
    twiddles (conjugate for the inverse), the transpose, and row k1's
    16-point DFT."""
    tw = torch.view_as_complex(torch.as_tensor(fft_twiddles()))   # [k1, j]
    if sign > 0:
        tw = tw.conj().resolve_conj()
    cols = z.reshape(-1, 16, 16).transpose(1, 2)            # [j, n1]
    y = _dft16(cols, sign) * tw.T                            # [j, k1]
    return _dft16(y.transpose(1, 2).contiguous(), sign)      # [k1, k2]


def ring_pairs(n_shifts: int, n_rings: int) -> np.ndarray:
    """(P, 2) int: the kernel's ring pairs of a group of ``n_shifts``
    shifts, as slots ``g * n_rings + r`` (-1: paired with zeros), in the
    order its FFTs take them: ring r at shifts 2i and 2i+1, then the
    rings of an odd last shift as neighbours r, r+1."""
    cross = [(2 * i * n_rings + r, (2 * i + 1) * n_rings + r)
             for i in range(n_shifts // 2) for r in range(n_rings)]
    base = (n_shifts - 1) * n_rings
    odd = [(base + r, base + r + 1 if r + 1 < n_rings else -1)
           for r in range(0, n_rings, 2)] if n_shifts % 2 else []
    return np.array(cross + odd, dtype=np.int64).reshape(-1, 2)


def plan_rfft(rings, pairs=None) -> torch.Tensor:
    """(n, 256) f32 rings, in the kernel's (shift, ring) order -> (n, 129)
    complex64 spectra as the kernel computes them: the rings of each of
    ``pairs`` (``ring_pairs``' layout; by default 2p and 2p+1, an odd n
    pairing the last with zeros) as one complex sequence, split with the
    value of the partner thread 16 - j at register 15 - k2 (thread 0: its
    own register 16 - k2)."""
    rings = torch.as_tensor(rings, dtype=torch.float32)
    n = rings.shape[0]
    if pairs is None:
        first = np.arange(0, n, 2)
        pairs = np.stack([first, np.where(first + 1 < n, first + 1, -1)], 1)
    pairs = torch.as_tensor(pairs)
    padded = torch.cat([rings, rings.new_zeros(1, RING_LEN)])  # row -1: 0
    zz = _fft256(torch.complex(padded[pairs[:, 0]], padded[pairs[:, 1]]), -1)
    j = torch.arange(16)[:, None]
    k2 = torch.arange(9)[None, :]
    pj = (16 - j) % 16 + 0 * k2
    pk = torch.where(j == 0, (16 - k2) % 16, 15 - k2)
    z, pz = zz[:, :, :9], zz[:, pj, pk]
    xa = torch.complex(0.5 * (z.real + pz.real), 0.5 * (z.imag - pz.imag))
    xb = torch.complex(0.5 * (z.imag + pz.imag), 0.5 * (pz.real - z.real))
    f = (j + 16 * k2).reshape(-1)
    keep = f <= RING_LEN // 2                 # bins 0..128 (f = 128: j = 0)
    out = torch.zeros((n + 1, RING_LEN // 2 + 1), dtype=torch.complex64)
    out[pairs[:, 0, None], f[keep]] = xa.reshape(xa.shape[0], -1)[:, keep]
    out[pairs[:, 1, None], f[keep]] = xb.reshape(xb.shape[0], -1)[:, keep]
    return out[:n]


def pack_slots(spec) -> torch.Tensor:
    """(..., 129) complex -> (..., 128): bins 1..127, and (DC, Nyquist)
    real parts in slot 0, the kernel's spectrum layout."""
    slots = spec[..., :RING_LEN // 2].clone()
    slots[..., 0] = torch.complex(spec[..., 0].real,
                                  spec[..., RING_LEN // 2].real)
    return slots


def plan_ccf(slots, ref_fw, n_mirr: int) -> torch.Tensor:
    """The kernel's ccf rows of one shift group and ref group.

    Args:
      slots: (G, R, 128) complex64 ring spectra in the slot layout.
      ref_fw: (kn, R, 129) complex64 weighted ref spectra.
      n_mirr: 2 with the mirror channel, else 1.
    Returns:
      (G * kn * n_mirr, 128) complex64 rows in the kernel's order
      (shift, ref, mirror), slot layout, scaled by 1/256.
    """
    rr = pack_slots(torch.as_tensor(ref_fw))
    sv = slots
    a = torch.einsum("grf,krf->gkf", sv.real, rr.real)
    b = torch.einsum("grf,krf->gkf", sv.imag, rr.imag)
    c = torch.einsum("grf,krf->gkf", sv.real, rr.imag)
    d = torch.einsum("grf,krf->gkf", sv.imag, rr.real)
    orig = torch.complex(a + b, c - d)
    mirr = torch.complex(a - b, -(c + d))
    edge = torch.complex(a[..., 0], b[..., 0])     # slot 0: (DC, Nyquist)
    orig[..., 0] = edge
    mirr[..., 0] = edge
    rows = torch.stack([orig, mirr][:n_mirr], dim=2) / RING_LEN
    return rows.reshape(-1, RING_LEN // 2)


def plan_irfft(rows) -> torch.Tensor:
    """(n, 128) complex64 rows in the slot layout -> (n, 256) f32 angle
    rows, as the kernel inverts them: rows 2c and 2c+1 (an odd n pairs
    the last with zeros) packed as C = O + i M from both Hermitian
    halves, inverted by the 16 x 16 plan with conjugate twiddles; the
    real part is row 2c, the imaginary part row 2c+1.  No scaling."""
    rows = torch.as_tensor(rows, dtype=torch.complex64)
    n = rows.shape[0]
    if n % 2:
        rows = torch.cat([rows, rows.new_zeros(1, RING_LEN // 2)])
    A, B = rows[0::2], rows[1::2]
    half = RING_LEN // 2
    lo = torch.complex(A.real - B.imag, A.imag + B.real)          # f < 128
    hi = torch.complex(A.real + B.imag, B.real - A.imag)          # 256 - f
    c = torch.zeros((A.shape[0], RING_LEN), dtype=torch.complex64)
    c[:, 1:half] = lo[:, 1:]
    c[:, half + 1:] = hi[:, 1:].flip(-1)
    c[:, 0] = torch.complex(A[:, 0].real, B[:, 0].real)
    c[:, half] = torch.complex(A[:, 0].imag, B[:, 0].imag)
    out = _fft256(c, 1).transpose(1, 2).reshape(-1, RING_LEN)     # c[a]
    return torch.stack([out.real, out.imag], 1).reshape(-1, RING_LEN)[:n]


def plan_search_rows(polar, ref_fw, n_mirr: int) -> torch.Tensor:
    """(G, R, 256) samples of one shift group and (kn, R, 129) ref
    spectra -> (G, kn, n_mirr, 256) angle rows through the kernel's plan
    (plan_rfft on ring_pairs, pack_slots, plan_ccf, plan_irfft)."""
    g, r, _ = polar.shape
    slots = pack_slots(plan_rfft(polar.reshape(g * r, RING_LEN),
                                 ring_pairs(g, r)))
    rows = plan_irfft(plan_ccf(slots.reshape(g, r, -1), ref_fw, n_mirr))
    return rows.reshape(g, -1, n_mirr, RING_LEN)


@lru_cache(maxsize=32)
def kernel_tables(cfg: AlignConfig, device: torch.device) -> tuple:
    """(polar (L, 2) f64, radii (R,) f64, twiddles (16, 16, 2) f32) on
    ``device``, copied there once per (cfg, device), so a launch copies
    nothing from the host."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in (*polar_tables(cfg), fft_twiddles()))


@lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (or load the cached build of) the search kernel."""
    lib = load_library("search", ["search.cu"])
    ptr = ctypes.c_void_p
    lib.cryo_search_launch.argtypes = (
        [ptr] * 10 + [ctypes.c_int] * 8 + [ptr] * 8 + [ptr])
    lib.cryo_search_launch.restype = ctypes.c_int
    lib.cryo_search_plan.argtypes = [ctypes.c_int] * 6 + [ptr] * 2
    lib.cryo_search_plan.restype = ctypes.c_longlong
    lib.cryo_search_error_string.argtypes = [ctypes.c_int]
    lib.cryo_search_error_string.restype = ctypes.c_char_p
    return lib


def kernel_plan(n_rings: int, mirror: bool, n_refs: int, n_shifts: int,
                h: int, w: int) -> dict:
    """The kernel's launch plan on the current CUDA device: shifts per
    group, whether the image is staged in shared memory, and the block's
    shared memory in bytes."""
    group, staged = ctypes.c_int(), ctypes.c_int()
    smem = build().cryo_search_plan(n_rings, int(mirror), n_refs, n_shifts,
                                    h, w, ctypes.byref(group),
                                    ctypes.byref(staged))
    return {"group": group.value, "image_in_smem": bool(staged.value),
            "smem_bytes": smem}


# csrc/search.cu's block geometry, for the model of its plan below: bins
# stored per spectrum, 256-point FFTs per round and the transpose
# scratch (16 x 17 float2) of each, threads per block
_NB, _NFFT, _TSIZE, _NTHREADS, _GMAX = 128, 16, 16 * 17, 256, 4
# cudaDevAttrMaxSharedMemoryPerBlockOptin of every sm_90 device, the one
# architecture the kernel is built for: the limit where no device is
# there to ask
SM90_SMEM_OPTIN = 232448


def _smem_bytes(n_rings: int, n_mirr: int, kg: int, g: int) -> int:
    """``smem_bytes`` of csrc/search.cu: G shifts' spectra, their ccf
    rows (stride 129 or 130), the FFT scratch, and the row, mask and
    warp partials."""
    x_stride = 129 if n_mirr == 2 else 130
    return (8 * (g * n_rings * _NB + g * kg * n_mirr * x_stride
                 + _NFFT * _TSIZE)
            + 4 * (2 * RING_LEN + 2 * (_NTHREADS // 32)))


def plan_model(n_rings: int, mirror: bool, n_refs: int, n_shifts: int,
               h: int, w: int, smem_limit: int) -> dict:
    """A CPU copy of ``plan()`` in csrc/search.cu under a shared-memory
    limit: ``kernel_plan``'s dict with no device and no build
    (``tests/test_torch_streaming_gpu.py`` holds the two equal)."""
    n_mirr = 2 if mirror else 1
    kg = 1 if n_refs == 1 else 8

    def max_group(extra):
        g = 0
        while (g < _GMAX and g < n_shifts
               and _smem_bytes(n_rings, n_mirr, kg, g + 1) + extra
               <= smem_limit):
            g += 1
        return g

    image = 4 * h * w
    g_staged, g_ldg = max_group(image), max(1, max_group(0))
    if g_staged >= 2 or (g_staged == 1 and (g_ldg == 1 or kg == 1)):
        return {"group": g_staged, "image_in_smem": True,
                "smem_bytes": _smem_bytes(n_rings, n_mirr, kg, g_staged)
                + image}
    return {"group": g_ldg, "image_in_smem": False,
            "smem_bytes": _smem_bytes(n_rings, n_mirr, kg, g_ldg)}


class KernelPlan(NamedTuple):
    """``kernel_plan``'s fields, and the groups of 8 references (one of
    one at K=1) that each block loops over."""

    group: int
    image_in_smem: bool
    smem_bytes: int
    ref_groups: int


def launch_plan(cfg: AlignConfig, n_refs: int, h: int, w: int,
                smem_limit: int | None = None, device="cuda") -> KernelPlan:
    """``plan_model``'s plan of a launch on ``n_refs`` references of
    ``cfg``, under ``smem_limit`` (by default ``device``'s): no build."""
    limit = device_smem_limit(device) if smem_limit is None else smem_limit
    return KernelPlan(**plan_model(cfg.ring_num, cfg.mirror, n_refs,
                                   cfg.n_shifts, h, w, limit),
                      ref_groups=-(-n_refs // 8))


def device_smem_limit(device) -> int:
    """The opt-in shared memory per block of ``device`` (a CUDA device),
    or of any sm_90 device where CUDA is not available."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return SM90_SMEM_OPTIN
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def kernel_gate(cfg: AlignConfig, n_refs: int, h: int, w: int,
                smem_limit: int | None = None, device="cuda") -> str | None:
    """Why the kernel cannot run this geometry, or None where it can: the
    checks on which ``_launch`` raises, decided from the geometry alone.
    ``smem_limit`` defaults to ``device``'s (``device_smem_limit``)."""
    if cfg.ring_len != RING_LEN or cfg.ring_scheme != "cuda":
        return (f"ring_len={cfg.ring_len}, ring_scheme={cfg.ring_scheme!r}"
                " (the kernel takes ring_len=256 uniform rings)")
    if 2 * cfg.n_shifts * n_refs * RING_LEN >= 2 ** 31:
        return (f"{cfg.n_shifts} shifts x {n_refs} refs (over the kernel's "
                "int32 priority index)")
    limit = device_smem_limit(device) if smem_limit is None else smem_limit
    smem = launch_plan(cfg, n_refs, h, w, limit).smem_bytes
    if smem > limit:
        return (f"ring_num={cfg.ring_num} needs {smem} B of shared memory "
                f"per block, the device allows {limit}")
    return None


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
                 angle_mask=None, out_interior=None) -> SearchResult:
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
      out_interior: optional (N,) int32 zeros on the device of ``images``,
        to which the kernel adds each particle's ring samplings (one ring
        at one shift) that took the unclamped path (the kernel only:
        given with a CPU tensor it raises ``ValueError``).
    Returns:
      SearchResult, on the device of ``images``.
    """
    if images.device.type == "cpu":
        _no_counter(out_interior)
        return search_plain(images, ref_fw, params, cfg,
                            angle_mask=angle_mask)
    if angle_mask is not None:
        _check("angle_mask", angle_mask, torch.float32, (RING_LEN,),
               images.device)
        # read back once per mask and version: a streamed iteration
        # searches batch after batch with the same mask, and each read
        # would make the host wait for the card
        version = angle_mask._version
        if getattr(angle_mask, "_checked_version", None) != version:
            if not bool((angle_mask > _NEG_INF).any()):
                raise ValueError("angle_mask allows no angle bin")
            angle_mask._checked_version = version
    return _launch(images, ref_fw, params, cfg, angle_mask, 0,
                   fused_search.launches,
                   variant(cfg, angle_mask is not None),
                   fused_search.launches_by_k, out_interior=out_interior)


def _no_counter(out_interior):
    if out_interior is not None:
        raise ValueError("out_interior counts the kernel's ring samplings; "
                         "a CPU tensor runs the plain search")


def fused_search_shc(images, ref_fw, params: AlignParams, cfg: AlignConfig,
                     previousmax, out_groups=None, out_interior=None):
    """The SHC search (``random_method="SHC"``) on the kernel's candidates.

    The rule of ``ops/search.py::rotational_shift_search_shc``: each
    particle takes, of the candidates (mirror, shift, ref) whose row peak
    is strictly above its ``previousmax``, the one of the lowest priority
    ``(m * S + s) * K + k``, with that row's first argmax angle.  On a
    CUDA tensor one launch of the kernel's SHC pick (``csrc/search.cu``,
    ``PICK_SHC``, built for one reference, as the reference-free driver
    has; more raise ``ValueError``), whose blocks stop after the first
    shift group that ends with an unmirrored winner; on a CPU tensor
    ``rotational_shift_search_shc``.

    Args:
      images, ref_fw, params, cfg: as ``fused_search`` (no angle mask).
      previousmax: (N,) float32 thresholds on the device of ``images``.
      out_groups: optional (N,) int32 tensor there, which receives the
        shift groups each particle's block ran (the kernel only: given
        with a CPU tensor it raises ``ValueError``).
      out_interior: as ``fused_search``'s, over the shift groups run.
    Returns:
      ``(SearchResult, found)``, ``found`` an (N,) bool mask; a particle
      with no passing candidate has value -3e38, a zero row and zero
      indices.  On the card ``found`` is ``value > previousmax``: a
      winner's peak passed that test, and -3e38 lies below any threshold
      that a ccf peak sets.
    """
    if images.device.type == "cpu":
        if out_groups is not None:
            raise ValueError("out_groups counts the kernel's shift groups; "
                             "a CPU tensor runs the plain SHC search")
        _no_counter(out_interior)
        return rotational_shift_search_shc(images, ref_fw, params, cfg,
                                           previousmax)
    result = _launch(images, ref_fw, params, cfg, None, 0,
                     fused_search.launches, variant(cfg, False, shc=True),
                     fused_search.launches_by_k, previousmax=previousmax,
                     out_groups=out_groups, out_interior=out_interior)
    return result, result.best_val > previousmax


# the TPU kernel's ablation stages (fused_search.py:221-233, :329-348)
# and their codes in csrc/search.cu; "full" is the production search
STAGES = {"no_ccf": 1, "sample_only": 2, "no_yred": 3}


def fused_search_stage(images, ref_fw, params: AlignParams,
                       cfg: AlignConfig, stage: str,
                       out_interior=None) -> SearchResult:
    """One ablated search kernel launch, for tools/torch_search_ablate.py.

    ``stage`` is one of ``STAGES``: "no_ccf" skips the forward DFT and
    the ccf (the inverse DFT and argmax run on zero spectra),
    "sample_only" keeps the polar samples only, and "no_yred" samples
    the top row of each bilinear cell only.  The mirrored, unmasked
    variant (the default one, at K=1 the reference-free one), on a CUDA
    tensor; ``out_interior`` as ``fused_search``'s.  The outputs have the
    production shapes; their values mean nothing, but for "sample_only"'s
    rows: entry t of a particle's row is the largest sample that the
    kernel's thread t drew, floored at 0.  Counted in
    ``fused_search_stage.launches``; ``fused_search`` never calls it.
    """
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {sorted(STAGES)}, "
                         f"not {stage!r}")
    if images.device.type != "cuda":
        raise ValueError("the ablation stages run on a CUDA tensor only")
    if not cfg.mirror:
        raise ValueError("the ablation stages take the mirrored variant "
                         "only")
    return _launch(images, ref_fw, params, cfg, None, STAGES[stage],
                   fused_search_stage.launches, stage,
                   out_interior=out_interior)


def _launch(images, ref_fw, params: AlignParams, cfg: AlignConfig,
            angle_mask, stage: int, counts: dict, key: str,
            by_k: dict | None = None, previousmax=None,
            out_groups=None, out_interior=None) -> SearchResult:
    """Check the inputs and launch the kernel on a CUDA tensor, its SHC
    pick where ``previousmax`` is given (the groups run go to
    ``out_groups``, or to a buffer of its own; ``kernel_gate`` raises),
    adding the unclamped ring samplings to ``out_interior`` if given; a
    launch that succeeds adds one to ``counts[key]``, and to
    ``by_k[(key, K)]`` where given (an empty stack counts nothing)."""
    if images.device.type != "cuda":
        raise ValueError(f"no search for device {images.device}")
    dev = images.device
    n, h, w = images.shape
    k = ref_fw.shape[0]
    r = cfg.ring_num
    s = cfg.n_shifts
    _check("images", images, torch.float32, (n, h, w), dev)
    _check("ref_fw", ref_fw, torch.complex64, (k, r, RING_LEN // 2 + 1), dev)
    _check("params.shift_x", params.shift_x, torch.float32, (n,), dev)
    _check("params.shift_y", params.shift_y, torch.float32, (n,), dev)
    if previousmax is not None:
        if k != 1:
            raise ValueError(f"the kernel's SHC pick takes one reference, "
                             f"not {k}")
        _check("previousmax", previousmax, torch.float32, (n,), dev)
        if out_groups is None:
            out_groups = torch.empty(n, dtype=torch.int32, device=dev)
        _check("out_groups", out_groups, torch.int32, (n,), dev)
    if out_interior is not None:
        _check("out_interior", out_interior, torch.int32, (n,), dev)
    gate = kernel_gate(cfg, k, h, w, device=dev)
    if gate is not None:
        raise ValueError("the search kernel does not take " + gate)

    polar, radii, twiddle = kernel_tables(cfg, dev)
    shifts = search_tables(cfg, dev).shifts
    ref_ri = torch.view_as_real(ref_fw)
    out_val = torch.empty(n, dtype=torch.float32, device=dev)
    out_row = torch.empty((n, RING_LEN), dtype=torch.float32, device=dev)
    out_i = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if n == 0:
        return SearchResult(out_val, out_row, *out_i)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cryo_search_launch(
            images.data_ptr(), params.shift_x.data_ptr(),
            params.shift_y.data_ptr(), polar.data_ptr(), radii.data_ptr(),
            shifts.data_ptr(), ref_ri.data_ptr(), twiddle.data_ptr(),
            *[None if t is None else t.data_ptr()
              for t in (angle_mask, previousmax)],
            n, h, w, r, s, k, int(cfg.mirror), stage,
            out_val.data_ptr(), out_row.data_ptr(),
            *[t.data_ptr() for t in out_i],
            *[None if t is None else t.data_ptr()
              for t in (out_groups, out_interior)], stream)
    if rc != 0:
        raise RuntimeError("search kernel launch failed: "
                           + lib.cryo_search_error_string(rc).decode())
    counts[key] += 1
    if by_k is not None:
        by_k[(key, k)] = by_k.get((key, k), 0) + 1
    aidx, sidx, ref, mirror = out_i
    return SearchResult(out_val, out_row, aidx, sidx, ref, mirror)


def reset_launches():
    """Set every launch counter to 0, the ablation stages' included."""
    for counts in (fused_search.launches, fused_search_stage.launches):
        for key in counts:
            counts[key] = 0
    fused_search.launches_by_k.clear()


fused_search.launches = dict.fromkeys(
    ("search", "search_nomirror", "search_masked", "search_nomirror_masked",
     "search_shc", "search_shc_nomirror"), 0)
fused_search.launches_by_k = {}
fused_search_stage.launches = dict.fromkeys(STAGES, 0)
