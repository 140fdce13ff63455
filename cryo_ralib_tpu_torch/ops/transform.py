"""Batch image transform: apply alignment parameters (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/transform.py::transform_batch``, the
bilinear inverse map of the reference's ``cu_transform_batch``.
"""

from __future__ import annotations

import math

import torch

from ..params import AlignParams
from .interp import bilinear_sample


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
