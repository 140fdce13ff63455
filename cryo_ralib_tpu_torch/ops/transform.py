"""Batch image transforms (PyTorch).

Counterparts of ``cryo_ralib_tpu/ops/transform.py``:

* ``transform_batch`` — the bilinear inverse map of the reference's
  ``cu_transform_batch``, used inside the alignment step;
* ``rot_shift2d`` — EMAN2 ``rot_scale_trans2D_background`` with quadri
  interpolation, the public batch op of the reference's notebook 02
  (``rot_shift_2d_cupy``): it applies alignment parameters to export an
  aligned stack.  The JAX package's FFT-shear engine is a TPU
  work-around (gathers are slow there) and is not ported.
"""

from __future__ import annotations

import math

import torch

from ..params import AlignParams
from .interp import bilinear_sample, quadri_sample

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
      engine: "auto" or "quadri" (the same: quadri interpolation).
        "shear", the JAX package's FFT-shear engine, raises
        ``ValueError``: it is a TPU work-around and is not ported.
    Returns:
      (N, H, W) on the device of ``images``.
    """
    if engine == "shear":
        raise ValueError(
            "engine='shear' (the FFT-shear rotation) is a TPU work-around "
            "of the JAX package and is not ported; use engine='quadri'")
    if engine not in ("auto", "quadri"):
        raise ValueError(f"engine must be 'auto' or 'quadri', not {engine!r}")
    n, h, w = images.shape

    def per_particle(v, dtype=images.dtype):
        return torch.as_tensor(v, device=images.device).to(dtype)

    angles, sx, sy = per_particle(angles), per_particle(sx), per_particle(sy)
    if scale is not None:
        scale = per_particle(scale)
    if mirror is not None:
        mirror = per_particle(mirror, torch.int32)
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
    if mirror is not None:
        start = 1 - h % 2
        flipped = out.clone()
        flipped[:, :, start:] = out[:, :, start:].flip(2)
        out = torch.where((mirror == 1)[:, None, None], flipped, out)
    return out


def _restrict2(v, size: int):
    """EMAN2 ``restrict2``: ``while (x >= nx) x -= nx; while (x <= -nx)
    x += nx``.  For x >= nx this lands in [0, nx) (x mod nx), for
    x <= -nx in (-nx, 0]; ``torch.remainder`` takes the divisor's sign,
    as the loop does (``fmod`` would not)."""
    size = float(size)
    v = torch.where(v >= size, torch.remainder(v, size), v)
    return torch.where(v <= -size, -torch.remainder(-v, size), v)
