"""Batch image transform: apply alignment parameters (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/transform.py::transform_batch``, the
bilinear inverse map of the reference's ``cu_transform_batch``.
"""

from __future__ import annotations

import math

import torch

from ..params import AlignParams
from .interp import bilinear_sample

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
