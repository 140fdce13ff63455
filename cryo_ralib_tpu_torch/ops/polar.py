"""Polar ring resampling of particle images (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/polar.py::polar_resample``: every
image is sampled on ``ring_num`` rings of ``ring_len`` points centred at
``img_dim // 2 + shift``, bilinear with clamp-to-edge.
"""

from __future__ import annotations

import torch

from .interp import bilinear_sample


def polar_resample(images, coords, shift_x=None, shift_y=None):
    """Resample a stack of images into polar rings.

    Args:
      images: (N, H, W) float32.
      coords: (R, L, 2) polar offsets from ``AlignConfig.polar_coords``
        (``[..., 0]`` = x, ``[..., 1]`` = y), as a tensor.
      shift_x, shift_y: per-particle total shifts, ``(N,)`` or ``(N, S)``
        for S candidate shifts per particle (accumulated + grid shift,
        summed by the caller); None means zero.

    Returns:
      (N, R, L) for ``(N,)`` shifts, else (N, S, R, L).

    The coordinate is ``cx + shift + px``, added in that order in f32 —
    the hand-written search kernel forms it the same way.
    """
    n, h, w = images.shape
    r_num, r_len, _ = coords.shape
    cx = w // 2
    cy = h // 2
    if shift_x is None:
        shift_x = torch.zeros(n, dtype=images.dtype, device=images.device)
    if shift_y is None:
        shift_y = torch.zeros(n, dtype=images.dtype, device=images.device)

    multi_shift = shift_x.ndim == 2
    if not multi_shift:
        shift_x = shift_x[:, None]
        shift_y = shift_y[:, None]
    s = shift_x.shape[1]

    px = coords[..., 0].reshape(1, 1, -1)  # (1, 1, R*L)
    py = coords[..., 1].reshape(1, 1, -1)
    x = cx + shift_x[:, :, None] + px      # (N, S, R*L)
    y = cy + shift_y[:, :, None] + py
    out = bilinear_sample(images, y.reshape(n, -1), x.reshape(n, -1))
    out = out.reshape(n, s, r_num, r_len)
    if not multi_shift:
        out = out[:, 0]
    return out
