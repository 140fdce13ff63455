"""Circular masks and mask-based normalisation (PyTorch).

Counterparts of ``cryo_ralib_tpu/ops/masks.py``: EMAN2/SPHIRE
``model_circle``, ``Util.infomask`` and the ``normalize.mask`` processor.
"""

from __future__ import annotations

import numpy as np
import torch


def model_circle(radius: float, nx: int, ny: int | None = None) -> np.ndarray:
    """Binary disk of the given radius centred at (ny//2, nx//2)."""
    ny = nx if ny is None else ny
    cy, cx = ny // 2, nx // 2
    yy, xx = np.mgrid[0:ny, 0:nx]
    r2 = (yy - cy) ** 2 + (xx - cx) ** 2
    return (r2 <= radius * radius).astype(np.float32)


def infomask(img, mask):
    """(mean, sigma) of the pixels under a binary mask, per image of a
    (..., H, W) batch."""
    cnt = mask.sum()
    mean = (img * mask).sum(dim=(-2, -1)) / cnt
    var = ((img - mean[..., None, None]) ** 2 * mask).sum(dim=(-2, -1)) / cnt
    return mean, torch.sqrt(var.clamp(min=0.0))


def normalize_mask(img, mask, no_sigma: bool = False):
    """EMAN2 ``normalize.mask``: subtract the mean under ``mask``; unless
    ``no_sigma``, also divide by the sigma under it (``no_sigma=True``
    for references, ``False`` for particles)."""
    mean, sigma = infomask(img, mask)
    out = img - mean[..., None, None]
    if not no_sigma:
        safe = torch.where(sigma > 0, sigma, torch.ones_like(sigma))
        out = out / safe[..., None, None]
    return out
