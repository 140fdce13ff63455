"""Clamp-to-edge bilinear image sampling (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/interp.py::bilinear_sample``: the
texture-read semantics (``tex2D`` linear filter, clamp addressing) of the
reference, with exact float weights.  Written as an explicit gather and
not ``grid_sample``, whose corner conventions differ.
"""

from __future__ import annotations

import torch


def bilinear_sample(images, y, x):
    """Clamp-to-edge bilinear sampling.

    Args:
      images: (N, H, W) float tensor.
      y, x:   (N, M) float pixel coordinates (row, col).
    Returns:
      (N, M) sampled values.
    """
    n, h, w = images.shape
    flat = images.reshape(n, h * w)
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ix0 = x0.long()
    iy0 = y0.long()
    ix1 = (ix0 + 1).clamp(max=w - 1)
    iy1 = (iy0 + 1).clamp(max=h - 1)
    fx = x - x0
    fy = y - y0

    def g(iy, ix):
        return torch.gather(flat, 1, iy * w + ix)

    v00 = g(iy0, ix0)
    v01 = g(iy0, ix1)
    v10 = g(iy1, ix0)
    v11 = g(iy1, ix1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy
