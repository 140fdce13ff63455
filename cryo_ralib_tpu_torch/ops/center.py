"""Image centering (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/center.py``: ``--center`` 0 leaves
the average alone, 1 centers it on the center of gravity of its
positive part; every other id raises, as in the JAX package.  The
reference-free driver's ``--center=-1`` (the mean particle shift
subtracted with ``fshift``) lives in the driver.
"""

from __future__ import annotations

import torch

from .filters import fshift


def center_of_gravity(img):
    """(sx, sy) displacement of the center of gravity of the positive
    part of (..., H, W) images from the EMAN2 center (w//2, h//2)."""
    img = torch.as_tensor(img)
    h, w = img.shape[-2:]
    pos = torch.clamp(img, min=0.0)
    total = pos.sum(dim=(-2, -1))
    yy = torch.arange(h, dtype=img.dtype, device=img.device)
    xx = torch.arange(w, dtype=img.dtype, device=img.device)
    cy = (pos * yy[:, None]).sum(dim=(-2, -1)) / total.clamp(min=1e-20)
    cx = (pos * xx[None, :]).sum(dim=(-2, -1)) / total.clamp(min=1e-20)
    return cx - w // 2, cy - h // 2


def center_2D(img, method: int = 1):
    """Center an image; returns ``(centered, sx, sy)`` where the image was
    shifted by (-sx, -sy).  ``method`` 0 (or less) = none, 1 = center of
    gravity; anything else raises ValueError."""
    img = torch.as_tensor(img)
    if method <= 0:
        return img, 0.0, 0.0
    if method != 1:
        raise ValueError(
            f"--center={method} is not supported: the reference documents "
            "only 0 (off) and 1 (center the average); use 0, 1 (or -1 for "
            "the reference-free average centering)")
    sx, sy = center_of_gravity(img)
    return fshift(img, -sx, -sy), sx, sy
