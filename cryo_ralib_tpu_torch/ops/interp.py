"""Image sampling primitives (PyTorch).

Counterparts of ``cryo_ralib_tpu/ops/interp.py``:

* ``bilinear_sample`` — the texture-read semantics (``tex2D`` linear
  filter, clamp addressing) of the reference, with exact float weights;
* ``quadri_sample`` — EMAN2's quadratic ``quadri`` interpolation with
  circulant neighbour wrap, as the reference's notebook 02 CuPy kernel
  does it (``rot_shift2d``'s interpolator).

Both are explicit gathers with int64 indices, not ``grid_sample``, whose
corner conventions differ.
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


def quadri_sample(images, y, x, fallback_y=None, fallback_x=None):
    """EMAN2 ``quadri_background`` quadratic interpolation.

    EMAN2 works in 1-based coordinates; this takes 0-based float pixel
    coordinates and converts.  A point outside the image falls back to
    its *target* pixel (``fallback_y/x``, the kernel's ``ynew/xnew``)
    instead of wrapping; in-range neighbour reads wrap circulantly.  The
    expressions keep the JAX version's order, so that ``floor`` picks the
    same cell.

    Args:
      images: (N, H, W).
      y, x: (N, M) 0-based float sample coordinates.
      fallback_y, fallback_x: (N, M) 0-based integer-valued fallback
        coordinates (default: y/x rounded and clipped in bounds).
    Returns:
      (N, M) sampled values.
    """
    n, h, w = images.shape
    flat = images.reshape(n, h * w)
    x1 = x + 1.0
    y1 = y + 1.0
    if fallback_x is None:
        fallback_x = torch.round(x).clamp(0, w - 1) + 1.0
    else:
        fallback_x = fallback_x + 1.0
    if fallback_y is None:
        fallback_y = torch.round(y).clamp(0, h - 1) + 1.0
    else:
        fallback_y = fallback_y + 1.0
    oob = (x1 < 1.0) | (x1 >= w + 1.0) | (y1 < 1.0) | (y1 >= h + 1.0)
    x1 = torch.where(oob, fallback_x, x1)
    y1 = torch.where(oob, fallback_y, y1)

    fi = torch.floor(x1)
    fj = torch.floor(y1)
    i = fi.long()
    j = fj.long()
    dx0 = x1 - fi
    dy0 = y1 - fj

    def wrap_x(ix):
        return torch.where(ix > w, ix - w, torch.where(ix < 1, ix + w, ix))

    def wrap_y(iy):
        return torch.where(iy > h, iy - h, torch.where(iy < 1, iy + h, iy))

    def g(jj, ii):
        # fdata(i, j) = fdata[i-1 + (j-1)*nx]
        return torch.gather(flat, 1, (ii - 1) + (jj - 1) * w)

    f0 = g(j, i)
    c1 = g(j, wrap_x(i + 1)) - f0
    c2 = (c1 - f0 + g(j, wrap_x(i - 1))) * 0.5
    c3 = g(wrap_y(j + 1), i) - f0
    c4 = (c3 - f0 + g(wrap_y(j - 1), i)) * 0.5
    dxb = dx0 - 1.0
    dyb = dy0 - 1.0
    hxc = torch.where(dx0 >= 0, 1, -1)
    hyc = torch.where(dy0 >= 0, 1, -1)
    hxf = hxc.to(images.dtype)
    hyf = hyc.to(images.dtype)
    c5 = (g(wrap_y(j + hyc), wrap_x(i + hxc)) - f0 - hxf * c1
          - (hxf * (hxf - 1.0)) * c2 - hyf * c3
          - (hyf * (hyf - 1.0)) * c4) * (hxf * hyf)
    return f0 + dx0 * (c1 + dxb * c2 + dy0 * c5) + dy0 * (c3 + dyb * c4)
