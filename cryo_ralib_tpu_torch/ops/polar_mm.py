"""Bilinear tents as matrices: the helpers the template engine needs
(PyTorch).

Counterpart of three functions of ``cryo_ralib_tpu/ops/polar_mm.py``:
``tent_rows`` (numpy constant tent rows, clamp-to-edge), the traced
per-particle tents ``_tent_rows_traced`` and ``translate_window_mm``, the
template engine's accumulated-shift translate fused with the extraction
of its central window.  Bilinear sampling of a separable coordinate
offset is exactly a pair of tent (two nonzeros per row) contractions, so
the window is two small batched products.

The rest of the JAX module (``PolarTables``, ``polar_group_mm``,
``polar_resample_mm``, ``translate_bilinear_mm``) stays unported: it is
the TPU's way round a missing gather unit (the ``matmul`` sampler), and
on the card the port samples with the bilinear gather of ``ops/polar.py``
or inside the search kernel.

Rounding points, the JAX engine's (its ``fast=True``): the image and the tents
are rounded to bf16, the first product keeps its f32 sum rounded to bf16,
and the second product's f32 sum is the window.  The products are taken
in f32 on operands that hold bf16 values: a product of two bf16 values
is exact in f32, so this is the JAX package's bf16 x bf16 -> f32
contraction up to summation order, on either device, whatever the TF32
switches say.  For integer shifts the tents are one-hot and the window is
the bf16 cast of the exact one.
"""

from __future__ import annotations

import numpy as np
import torch


def tent_rows(coords: np.ndarray, size: int) -> np.ndarray:
    """Constant bilinear-weight rows: (Q,) float coords -> (Q, size).

    Row q holds the clamp-to-edge bilinear weights of coordinate
    ``coords[q]`` over the integer grid 0..size-1 (two nonzeros, or one
    at the edges), i.e. ``rows @ v`` == bilinear interpolation of v.
    """
    v = np.clip(coords.astype(np.float64), 0.0, size - 1.0)
    j0 = np.floor(v).astype(np.int64)
    j1 = np.minimum(j0 + 1, size - 1)
    f = v - j0
    rows = np.zeros((coords.shape[0], size), np.float64)
    np.add.at(rows, (np.arange(len(v)), j0), 1.0 - f)
    np.add.at(rows, (np.arange(len(v)), j1), f)
    return rows.astype(np.float32)


def _tent_rows_traced(shift, size: int, dtype, offset: int = 0,
                      out_size: int | None = None):
    """(N,) shifts -> (N, out_size, size) tent matrices by comparisons
    (no gathers): M[n, a, b] = tent weight of (offset + a + shift_n) at
    b, clamp-to-edge.  ``offset``/``out_size`` restrict the rows to the
    window [offset, offset + out_size) of the target grid."""
    if out_size is None:
        out_size = size
    dev = shift.device
    a = (torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
         + float(offset))
    v = (a + shift[:, None].to(torch.float32)).clamp(0.0, size - 1.0)
    j0 = torch.floor(v)
    f = (v - j0)[:, :, None]
    b = torch.arange(size, dtype=torch.float32, device=dev)[None, None, :]
    j0e = j0[:, :, None]
    j1e = (j0e + 1.0).clamp(max=size - 1.0)
    m = (torch.where(b == j0e, 1.0 - f, 0.0)
         + torch.where(b == j1e, f, 0.0))
    return m.to(dtype)


def _bf16_values(x):
    """``x`` rounded to bf16 and held in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def translate_window_mm(images, shift_x, shift_y, lo: int, width: int):
    """Fused accumulated-shift translate + central-window extraction:
    ``out[n, a, b] = bilinear(img_n, lo + a + shift_y_n,
    lo + b + shift_x_n)`` for a, b in [0, width), as two tent products
    that only produce the window's rows and columns.

    It rounds where the JAX engine does (the module docstring); its
    (N, width, width) f32 result holds the f32 sums of the second
    product, which the engine rounds to bf16.
    """
    _n, h, w = images.shape
    ty = _tent_rows_traced(shift_y, h, torch.float32, offset=lo,
                           out_size=width)          # (N, width, H)
    tx = _tent_rows_traced(shift_x, w, torch.float32, offset=lo,
                           out_size=width)          # (N, width, W)
    ty, tx = _bf16_values(ty), _bf16_values(tx)
    out = _bf16_values(torch.bmm(ty, _bf16_values(images.to(torch.float32))))
    return torch.bmm(out, tx.transpose(1, 2))       # (N, width, width)
