"""Batch image transforms (PyTorch).

Counterparts of ``cryo_ralib_tpu/ops/transform.py``:

* ``transform_batch`` — the bilinear inverse map of the reference's
  ``cu_transform_batch``, used inside the alignment step;
* ``transform_batch_mm`` — the same warp as an FFT shear (sinc
  interpolation): the JAX package's class-sum transform for its
  ``matmul``, ``fused`` and ``template`` samplers, here for ``matmul``
  and ``template`` (``ops/classavg.py::class_sum_transform_mm``);
* ``rot_shift2d`` — EMAN2 ``rot_scale_trans2D_background`` with quadri
  interpolation (``engine="quadri"``, "auto"), the public batch op of the
  reference's notebook 02 (``rot_shift_2d_cupy``), or through the FFT
  shear (``engine="shear"``).

The FFT shear (``_warp_spectrum``): angle = 90k + phi with phi in
[-45, 45); the 90k part is an exact grid permutation (transpose and edge
flip, ``_flip_edge``), the residual a product of three centred shears
``Sx(-tan(phi/2)) Sy(sin phi) Sx(-tan(phi/2))``, each a sub-pixel
translation of every row or column by a phase ramp on its DFT; the shift
rides the first two passes; the images are zero-padded to ``pad_to``
(the box's diagonal rounded up to a multiple of 128: 128 at 90 px) so
that the periodic translations never wrap content.

Rounding, as the JAX package's ``fast``: ``fast=False`` takes the DFTs
along one axis as ``torch.fft.rfft``/``irfft`` in f32 (JAX: matmul DFTs
at ``Precision.HIGHEST``; the two agree to f32 rounding).  ``fast=True``,
the JAX drivers' setting, keeps the JAX package's rounding points: its
DFTs are products with the DFT matrices, the operands (the rows, the
f32 cos/sin matrices built in numpy) rounded to bf16 and the sums f32,
the phase ramps f32 (``_dft_mm``: ``ops/polar_mm.py::mm_bf16``, the
tensor cores' bf16 product on the card; on the CPU the exact products
summed in f64, so that a particle's result does not depend on its
batch, where the card sums in f32).  An f32 FFT in its
place would not be the function the JAX drivers compute: their bf16 DFT
matrices move every output by ~0.4% (relative), which is what the
class sums and the Fourier variance of the two packages would then
differ by (``tests/test_torch_shear.py`` measures both).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..params import AlignParams
from .interp import bilinear_sample, quadri_sample
from .polar_mm import _bf16_values, mm_bf16, product_route

# Device memory ``transform_batch`` takes per output pixel, its output and
# every temporary of ``bilinear_sample`` included: ~112 B (28 f32 stack
# sizes) measured on an H100 at 90 px, over 16384 particles in one call
# (an align_step peak of 15.41 GB) and over blocks of 2048 (2.41 GB);
# charged with a margin for the allocator's rounding
TRANSFORM_BYTES_PER_PIXEL = 136
# Device memory the transform's temporaries of one block may take
# (``transform_block``): 2048 particles at 90 px, where a block is still
# large enough that the step's time does not move (chip_smoke.py 11a)
TRANSFORM_BLOCK_BYTES = 3 * 2**30


def transform_block(h: int, w: int) -> int:
    """Particles per block where a stack is transformed by blocks: the
    largest power of two whose temporaries fit ``TRANSFORM_BLOCK_BYTES``,
    at least 2 (even, so that a block starting at an even index keeps
    its parity)."""
    per = TRANSFORM_BYTES_PER_PIXEL * h * w
    b = 2
    while 2 * b * per <= TRANSFORM_BLOCK_BYTES:
        b *= 2
    return b


def transform_batch(images, params: AlignParams):
    """Apply (mirror -> rotate -> shift) as an inverse map, bilinear.

    Per target pixel the source coordinate is: mirror ``src_x = w - x``,
    rotate by +angle about (w//2, h//2), add (shift_x, shift_y); then a
    clamp-to-edge bilinear read.

    Args:
      images: (N, H, W); params: AlignParams with (N,) fields.
    Returns:
      (N, H, W) transformed images.
    """
    n, h, w = images.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=images.dtype, device=images.device),
        torch.arange(w, dtype=images.dtype, device=images.device),
        indexing="ij")
    xx = xx.reshape(1, -1)
    yy = yy.reshape(1, -1)
    mirror = params.mirror[:, None] == 1
    src_x = torch.where(mirror, w - xx, xx)
    src_y = yy.expand(n, h * w)

    ang = (params.angle * (math.pi / 180.0))[:, None]
    c, s = torch.cos(ang), torch.sin(ang)
    ctr_x = w // 2
    ctr_y = h // 2
    ux = src_x - ctr_x
    uy = src_y - ctr_y
    rx = ux * c - uy * s + ctr_x + params.shift_x[:, None]
    ry = ux * s + uy * c + ctr_y + params.shift_y[:, None]
    return bilinear_sample(images, ry, rx).reshape(n, h, w)


# Device memory the FFT shear takes per particle and padded pixel
# (``shear_pad(h)**2``), the spectra, the pre-rotations and the DFTs'
# operands and products included, and the block budget of a stack that
# it transforms (``transform_batch_mm``, ``class_sum_transform_mm``)
SHEAR_BYTES_PER_PIXEL = 48
SHEAR_BLOCK_BYTES = 3 * 2**30


def shear_pad(h: int) -> int:
    """The FFT shear's padded box: the content's diagonal ``h * sqrt(2)``
    rounded up to a multiple of 128 (128 at 90 px), as in JAX."""
    return ((int(math.ceil(h * math.sqrt(2.0))) + 127) // 128) * 128


def shear_block(h: int) -> int:
    """Particles per block of the FFT shear: the largest power of two
    whose temporaries fit ``SHEAR_BLOCK_BYTES``, at least 2 (even, so
    that a block starting at an even index keeps its parity)."""
    per = SHEAR_BYTES_PER_PIXEL * shear_pad(h) ** 2
    b = 2
    while 2 * b * per <= SHEAR_BLOCK_BYTES:
        b *= 2
    return b


# 1/90 as the JAX package's compiled warp computes the quadrant: XLA folds
# deg2rad and the division by pi/2 into one f32 multiply of the angle,
# which decides an angle on a +-45 degree edge (135 degrees exactly, as
# a --dst iteration decodes) otherwise than the two steps would
_QUADRANT = float(np.float32(np.float32(math.pi / 180.0)
                             * np.float32(1.0 / np.float32(math.pi / 2))))


@lru_cache(maxsize=None)
def _dft_mats_np(n: int):
    """The JAX package's DFT matrices of length ``n`` (f32, built in
    f64): the forward ``[cos | -sin]`` (n, 2F) and the normalised
    inverse ``[Re; Im]`` synthesis (2F, n), F = n//2 + 1."""
    k = np.arange(n // 2 + 1)
    l = np.arange(n)[:, None]
    ang = -2.0 * np.pi * l * k / n
    fwd = np.concatenate([np.cos(ang).astype(np.float32),
                          np.sin(ang).astype(np.float32)], axis=1)
    f = n // 2 + 1
    k = np.arange(f)[:, None]
    l = np.arange(n)
    ang = 2.0 * np.pi * k * l / n
    mult = np.full((f, 1), 2.0)
    mult[0, 0] = 1.0
    if n % 2 == 0:
        mult[-1, 0] = 1.0
    inv = np.concatenate([(mult * np.cos(ang) / n).astype(np.float32),
                          (-mult * np.sin(ang) / n).astype(np.float32)],
                         axis=0)
    return fwd, inv


@lru_cache(maxsize=16)
def dft_tables(n: int, device: torch.device):
    """``_dft_mats_np(n)`` rounded to bf16 and held in f32 on ``device``,
    copied there once per (n, device) (a device loop reads them with no
    copy)."""
    return tuple(_bf16_values(torch.as_tensor(m, device=device))
                 for m in _dft_mats_np(n))


def _dft_mm(x, mat):
    """(M, K) x (K, N) -> (M, N) f32, ``x`` rounded to bf16, ``mat`` a
    ``dft_tables`` matrix: the JAX package's bf16 x bf16 -> f32 product
    (``ops/polar_mm.py::mm_bf16``)."""
    return mm_bf16(x, mat, product_route(x.device))


def _rfft(x, fast: bool):
    """rfft along the last axis: ``torch.fft.rfft`` (f32), or with
    ``fast`` the JAX package's bf16 matmul DFT (``_dft_mm``)."""
    if not fast:
        return torch.fft.rfft(x, dim=-1)
    n = x.shape[-1]
    f = n // 2 + 1
    fwd, _ = dft_tables(n, x.device)
    y = _dft_mm(x.reshape(-1, n), fwd)
    return torch.complex(y[:, :f], y[:, f:]).reshape(*x.shape[:-1], f)


def _irfft(x, n: int, fast: bool):
    """Normalised inverse rfft of length ``n`` along the last axis, the
    imaginary parts of DC and Nyquist ignored: ``torch.fft.irfft``, or
    with ``fast`` the JAX package's bf16 matmul on ``[Re | Im]``.

    A phase ramp leaves the Nyquist bin complex; the JAX package's matmul
    inverse drops its imaginary part, and so does the CPU's FFT, but
    cuFFT's C2R transform reads it (1.3% of the largest class sum at 90
    px on an H100), so it is zeroed first."""
    if not fast:
        im = x.imag.clone()
        im[..., 0] = 0.0
        if n % 2 == 0:
            im[..., n // 2] = 0.0
        return torch.fft.irfft(torch.complex(x.real, im), n=n, dim=-1)
    _, inv = dft_tables(n, x.device)
    stacked = torch.cat([x.real, x.imag], dim=-1)
    y = _dft_mm(stacked.reshape(-1, stacked.shape[-1]), inv)
    return y.reshape(*x.shape[:-1], n)


def _flip_edge(arr, axis: int):
    """Index map i -> clamp(size - i): [last, size-1, size-2, ..., 1],
    the coordinate flip of the reference's mirror (``src_x = nx - x``
    with a clamped read): position 0 reads the clamped sample (the
    last), the rest reverse."""
    size = arr.shape[axis]
    return torch.cat([arr.narrow(axis, size - 1, 1),
                      arr.narrow(axis, 1, size - 1).flip(axis)], dim=axis)


def _ramped(f, t, p: int):
    """``f * exp(2 pi i k t / p)`` for k = 0..p//2: (N, M, F) spectra
    times the phase ramps of (N, M) shifts.  The complex product is
    written out in real products and sums, each rounded once: a complex
    multiply's kernels fuse them differently in a vector body and its
    tail, which would make a particle's result depend on its batch."""
    k = torch.arange(p // 2 + 1, dtype=torch.float32, device=t.device)
    phase = 2.0 * math.pi * k[None, None, :] * t[:, :, None] / p
    c, s = torch.cos(phase), torch.sin(phase)
    fr, fi = f.real, f.imag
    return torch.complex(fr * c - fi * s, fr * s + fi * c)


def _translate_rows(img, t, fast: bool = False):
    """Per-row sub-pixel x-translation by a DFT phase ramp:
    ``out[y, x] = in[y, x + t[y]]``, periodic (the caller pads so that
    content never wraps).  img (N, P, P), t (N, P)."""
    p = img.shape[-1]
    return _irfft(_ramped(_rfft(img, fast), t, p), p, fast)


def _translate_cols(img, t, fast: bool = False):
    """Per-column sub-pixel y-translation (out[y, x] = in[y + t[x], x])."""
    return _translate_rows(img.transpose(-1, -2), t,
                           fast).transpose(-1, -2)


def _warp_spectrum(images, params: AlignParams, pad_to: int | None = None,
                   fast: bool = False):
    """Shear passes 1-3 of the FFT warp and the forward half of pass 4.

    Returns ``(g, off, pad_to)``: ``_irfft(g, pad_to)`` is the transformed
    stack before the crop ``[off:off + h]`` and the mirror flip, which
    are the same linear map for every particle (so
    ``class_sum_transform_mm`` applies them once to the class sums).
    """
    n, h, w = images.shape
    if h != w:
        raise ValueError(f"the FFT shear needs square images, not {h}x{w}")
    if pad_to is None:
        pad_to = shear_pad(h)
    c = w // 2
    x = images.to(torch.float32)
    dev = x.device

    angle = params.angle.to(torch.float32)
    ang = angle * (math.pi / 180.0)
    # quadrant k = round(angle / 90) mod 4, residual phi in [-45, 45)
    k90 = torch.floor(angle * _QUADRANT + 0.5).to(torch.int32)
    phi = ang - k90.to(torch.float32) * (math.pi / 2)
    k90 = torch.remainder(k90, 4)

    # pre-rotate by 90k: the four variants, selected per particle
    xt = x.transpose(-1, -2)
    sel = k90[:, None, None]
    base = torch.where(sel == 0, x, torch.where(
        sel == 1, _flip_edge(xt, -2), torch.where(
            sel == 2, _flip_edge(_flip_edge(x, -1), -2),
            _flip_edge(xt, -1))))

    # the shift vector rotated by -90k
    sx = params.shift_x.to(torch.float32)
    sy = params.shift_y.to(torch.float32)
    sxr = torch.where(k90 == 0, sx, torch.where(
        k90 == 1, sy, torch.where(k90 == 2, -sx, -sy)))
    syr = torch.where(k90 == 0, sy, torch.where(
        k90 == 1, -sx, torch.where(k90 == 2, -sy, sx)))

    # zero-pad so that the centre lands on pad_to // 2
    off = pad_to // 2 - c
    base = F.pad(base, (off, pad_to - w - off, off, pad_to - h - off))
    centred = (torch.arange(pad_to, dtype=torch.float32, device=dev)[None, :]
               - float(pad_to // 2))                # y - cy, x - cx
    a = -torch.tan(phi / 2.0)
    b = torch.sin(phi)

    # pass 1: y-translate by syr
    out = _translate_cols(base, syr[:, None].expand(n, pad_to), fast)
    # pass 2: x-translate by a * (y - cy) + sxr (first shear + x shift)
    out = _translate_rows(out, a[:, None] * centred + sxr[:, None], fast)
    # pass 3: y-translate by b * (x - cx)
    out = _translate_cols(out, b[:, None] * centred, fast)
    # pass 4, forward: rfft and the phase ramp of the x-translate
    # a * (y - cy)
    g = _ramped(_rfft(out, fast), a[:, None] * centred, pad_to)
    return g, off, pad_to


def transform_batch_mm(images, params: AlignParams, pad_to: int | None = None,
                       fast: bool = False):
    """``transform_batch``'s warp (mirror -> rotate by +angle about the
    integer centre -> shift) as an FFT shear (the module docstring):
    sinc interpolation in place of bilinear.  A stack larger than
    ``shear_block`` particles runs by blocks of that size, with the same
    result as one call.

    Args:
      images: (N, H, H); params: AlignParams with (N,) fields.
      pad_to: the padded box (default ``shear_pad(H)``).
      fast: the JAX package's bf16 DFTs (the module docstring).
    Returns:
      (N, H, H) float32 on the device of ``images``.
    """
    n, h, w = images.shape
    block = shear_block(h)
    if n > block:
        out = torch.empty((n, h, w), dtype=torch.float32,
                          device=images.device)
        for start in range(0, n, block):
            sl = slice(start, start + block)
            out[sl] = transform_batch_mm(
                images[sl], AlignParams(*[f[sl] for f in params]), pad_to,
                fast)
        return out
    g, off, pad_to = _warp_spectrum(images, params, pad_to, fast)
    out = _irfft(g, pad_to, fast)[:, off:off + h, off:off + w]
    # mirror: out_m[y, x] = out[y, clamp(w - x)], applied to the result
    # (the reference's pre-rotation src_x = nx - x)
    return torch.where((params.mirror == 1)[:, None, None],
                       _flip_edge(out, -1), out)


def rot_shift2d(images, angles, sx, sy, mirror=None, scale=None,
                engine: str = "auto"):
    """EMAN2 ``rot_shift2D``, batched: rotate by ``angles`` degrees about
    the centre (w//2, h//2), scale, shift by (sx, sy); ``mirror`` flips
    the columns afterwards, leaving column 0 fixed for an even height
    (``start = 1 - h % 2``, the post-flip of the notebook's wrapper).

    Shifts wrap as EMAN2's ``restrict2`` does; a scale of 0 means 1.
    A stack larger than ``transform_block`` particles runs by blocks of
    that size (nine gathers with int64 indices hold ~30 stack sizes of
    temporaries), with the same result as one call.

    Args:
      images: (N, H, W) tensor.
      angles, sx, sy: (N,) degrees / pixels (tensors, arrays or lists).
      mirror: optional (N,) 0/1.
      scale: optional (N,) scale factors (default 1).
      engine: "quadri" (quadri interpolation), "shear" (the FFT shear of
        ``transform_batch_mm``, sinc interpolation, f32 DFTs; square
        images, ``scale`` None, else ``ValueError``) or "auto", which is
        quadri: the JAX package's "auto" takes the shear on a TPU only.
    Returns:
      (N, H, W) on the device of ``images``.
    """
    if engine not in ("auto", "quadri", "shear"):
        raise ValueError(f"engine must be 'auto', 'quadri' or 'shear', not "
                         f"{engine!r}")
    if engine == "shear" and scale is not None:
        raise ValueError("engine='shear' requires scale=1 (None)")
    n, h, w = images.shape

    def per_particle(v, dtype=images.dtype):
        return torch.as_tensor(v, device=images.device).to(dtype)

    angles, sx, sy = per_particle(angles), per_particle(sx), per_particle(sy)
    if scale is not None:
        scale = per_particle(scale)
    if mirror is not None:
        mirror = per_particle(mirror, torch.int32)
    if engine == "shear":
        return _rot_shift2d_shear(images, angles, sx, sy, mirror)
    block = transform_block(h, w)
    if n <= block:
        return _rot_shift2d(images, angles, sx, sy, mirror, scale)
    out = torch.empty_like(images)
    for start in range(0, n, block):
        sl = slice(start, start + block)
        out[sl] = _rot_shift2d(
            images[sl], angles[sl], sx[sl], sy[sl],
            None if mirror is None else mirror[sl],
            None if scale is None else scale[sl])
    return out


def _rot_shift2d(images, angles, sx, sy, mirror, scale):
    """``rot_shift2d`` in one call, on (N,) tensors of the images'
    dtype (``mirror`` int) on their device."""
    n, h, w = images.shape
    dtype, dev = images.dtype, images.device
    if scale is None:
        scale = torch.ones(n, dtype=dtype, device=dev)
    else:
        scale = torch.where(scale == 0.0, 1.0, scale)
    sx = _restrict2(sx, w)
    sy = _restrict2(sy, h)

    yy, xx = torch.meshgrid(torch.arange(h, dtype=dtype, device=dev),
                            torch.arange(w, dtype=dtype, device=dev),
                            indexing="ij")
    xx = xx.reshape(1, -1)
    yy = yy.reshape(1, -1)
    # cos and sin of the f32 radians in f64, rounded to f32: correctly
    # rounded on every device, so the card and the CPU pick the same
    # cells (f32 cos differs by an ulp between libraries, which moves a
    # coordinate near an integer into the next cell)
    ang = (angles * (math.pi / 180.0))[:, None].double()
    cang, sang = torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)
    xc = w // 2
    yc = h // 2
    shiftxc = xc + sx[:, None]
    shiftyc = yc + sy[:, None]
    inv_scale = 1.0 / scale[:, None]

    y = yy - shiftyc
    ycang = y * cang * inv_scale + yc
    ysang = -y * sang * inv_scale + xc
    x = xx - shiftxc
    xold = x * cang * inv_scale + ysang
    yold = x * sang * inv_scale + ycang
    out = quadri_sample(images, yold, xold,
                        fallback_y=yy.expand(n, h * w),
                        fallback_x=xx.expand(n, h * w)).reshape(n, h, w)
    return _mirror_post_flip(out, mirror)


def _rot_shift2d_shear(images, angles, sx, sy, mirror):
    """``rot_shift2d`` through the FFT shear: the identity
    ``R(a)(p - c - s) + c = R(a)(p - c) + c + (-R(a) s)`` maps it onto the
    inverse map of ``transform_batch_mm`` with the shift rotated into the
    output frame; the notebook's mirror post-flip after.  (N,) tensors as
    in ``_rot_shift2d``."""
    n, h, w = images.shape
    sx = _restrict2(sx.to(torch.float32), w)
    sy = _restrict2(sy.to(torch.float32), h)
    ang = (angles.to(torch.float32) * (math.pi / 180.0)).double()
    c, s = torch.cos(ang).float(), torch.sin(ang).float()
    zeros = torch.zeros(n, dtype=torch.int32, device=images.device)
    p = AlignParams(angles.to(torch.float32), -(sx * c - sy * s),
                    -(sx * s + sy * c), zeros, zeros)
    return _mirror_post_flip(transform_batch_mm(images, p), mirror)


def _mirror_post_flip(out, mirror):
    """The notebook's mirror: columns flipped after the transform,
    column 0 fixed for an even height (``start = 1 - h % 2``)."""
    if mirror is None:
        return out
    start = 1 - out.shape[1] % 2
    flipped = out.clone()
    flipped[:, :, start:] = out[:, :, start:].flip(2)
    return torch.where((mirror == 1)[:, None, None], flipped, out)


def _restrict2(v, size: int):
    """EMAN2 ``restrict2``: ``while (x >= nx) x -= nx; while (x <= -nx)
    x += nx``.  For x >= nx this lands in [0, nx) (x mod nx), for
    x <= -nx in (-nx, 0]; ``torch.remainder`` takes the divisor's sign,
    as the loop does (``fmod`` would not)."""
    size = float(size)
    v = torch.where(v >= size, torch.remainder(v, size), v)
    return torch.where(v <= -size, -torch.remainder(-v, size), v)
