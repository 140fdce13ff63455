"""Bilinear sampling as matrix products (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/polar_mm.py``.  Bilinear sampling of
a separable coordinate offset is exactly a pair of tent (two nonzeros per
row) contractions:

    sample(img, y + py, x + px) = sum_{j,i} tent(y + py - j) tent(x + px - i) img[j, i]

so polar resampling on a known shift grid becomes products with constant
tent matrices: for every distinct grid dy a matrix ``Wy[dy] : (Q, H)``
over the Q = ring_num x ring_len sample points, and likewise
``Wx[dx] : (Q, W)`` (``PolarTables``, ``build_polar_tables``).  One dy
group of candidates is one product ``T = Wy[dy] @ img`` followed by a
multiply-reduce against every ``Wx[dx]`` (``polar_group_mm``): the
``matmul`` sampler's search (``ops/search.py::rotational_shift_search_mm``).
The per-particle accumulated shifts go in first, as a bilinear translate
made of two tent products (``translate_bilinear_mm``), exactly the
one-stage bilinear sample for integer shifts.  The template engine's
window (``translate_window_mm``) is the same translate fused with the
extraction of its central window.

Rounding points, the JAX package's ``fast=True``: the operands of every
product are rounded to bf16 and the sums are f32; ``polar_group_mm``
rounds its intermediate ``T`` to bf16 between its two contractions, and
``translate_window_mm`` its first product.  A product of two bf16 values
is exact in f32 (and in TF32), so these are the JAX package's bf16 x bf16
-> f32 contractions up to summation order, on either device:

* on a CUDA device a 2-D product runs ``torch.mm(bf16, bf16,
  out_dtype=torch.float32)`` where the installed PyTorch has it
  (``product_route`` "bf16"), else f32 operands holding bf16 values
  under TF32 ("tf32");
* a batched product takes f32 operands holding bf16 values
  (``_bf16_values``), under TF32 on a CUDA device;
* a 2-D product on the CPU ("f32") sums the exact products of the bf16
  values in f64 and rounds once to f32 (``mm_bf16``): a BLAS's f32 sum
  of a row follows the product's shape, so a particle's result would
  otherwise depend on its batch (a block, a rank).  The card sums in f32
  in cuBLAS's order, so the CPU's results are the exact sums rounded,
  not the card's last bits (PERF.md, open questions).

``fast=False`` is the JAX package's ``Precision.HIGHEST``: f32 operands
with TF32 off (``_product_switches("f32")``).  For integer shifts the
tents are one-hot and a fast translate is the bf16 cast of the exact one.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

_log = logging.getLogger(__name__)


# -- the products ------------------------------------------------------

@lru_cache(maxsize=8)
def product_route(device: torch.device) -> str:
    """How a bf16 product runs on ``device``: "bf16" (CUDA,
    ``torch.mm(bf16, bf16, out_dtype=torch.float32)``), "tf32" (CUDA
    without that overload: f32 operands holding bf16 values under TF32)
    or "f32" (the CPU: f32 operands holding bf16 values).  Decided once
    per device by one small product, and logged."""
    device = torch.device(device)
    if device.type != "cuda":
        return "f32"
    a = torch.zeros((8, 8), dtype=torch.bfloat16, device=device)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
        route = "bf16"
    except (TypeError, NotImplementedError) as exc:
        # a missing overload raises one of these; any other error (a
        # fault, no memory) is not read as one
        _log.warning("bf16 products: torch.mm has no bf16 -> f32 "
                     "overload here (%s); the products run on the "
                     "slower tf32 route", exc)
        route = "tf32"
    _log.info("bf16 products on %s: %s", device, route)
    return route


@contextlib.contextmanager
def _product_switches(route: str):
    """The cuBLAS switches of the port's own products, restored after:
    TF32 on for the "tf32" route (f32 operands holding bf16 values), off
    for "f32" (full f32 products), bf16 reduced-precision reductions off
    for the "bf16" route."""
    mm = torch.backends.cuda.matmul
    old = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    try:
        if route == "tf32":
            mm.allow_tf32 = True
        elif route == "f32":
            mm.allow_tf32 = False
        elif route == "bf16":
            mm.allow_bf16_reduced_precision_reduction = False
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = old


def _bf16_values(x):
    """``x`` rounded to bf16 and held in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def mm_bf16(a, b, route: str):
    """(M, K) x (K, N) -> (M, N) f32: both operands rounded to bf16, the
    sums f32, on ``route`` (``product_route``); on "f32" (the CPU) the
    exact products summed in f64 and rounded once (the module
    docstring)."""
    with _product_switches(route):
        if route == "bf16":
            return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                            out_dtype=torch.float32)
        if route == "f32":
            return torch.mm(_bf16_values(a).double(),
                            _bf16_values(b).double()).float()
        return torch.mm(_bf16_values(a), _bf16_values(b))


def _held_route(device) -> str:
    """The switches of a product on f32 operands that hold bf16 values:
    TF32 on a CUDA device (the same products, exact either way), none
    on the CPU."""
    return "tf32" if torch.device(device).type == "cuda" else "f32"


# -- constant tents ----------------------------------------------------

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


@dataclass(frozen=True)
class PolarTables:
    """Constant sampling matrices of one ``AlignConfig`` (numpy).

    Attributes:
      wy: (n_dy, Q, H) tent weights of ``cy + ring_y[q] + dy``.
      wx: (n_dx, Q, W) tent weights of ``cx + ring_x[q] + dx``.
      ring_num, ring_len: polar grid shape (Q = ring_num * ring_len).
    """

    wy: np.ndarray
    wx: np.ndarray
    ring_num: int
    ring_len: int

    @property
    def n_dy(self) -> int:
        return self.wy.shape[0]

    @property
    def n_dx(self) -> int:
        return self.wx.shape[0]


def build_polar_tables(cfg, x_window: tuple[int, int] | None = None,
                       coords=None) -> PolarTables:
    """``PolarTables`` of an AlignConfig (numpy, host side).

    ``x_window=(x0, width)`` builds the x tents relative to the column
    window [x0, x0 + width) of the image; the caller guarantees that
    every sample stays inside the window, where windowed tents equal the
    full-width ones.  ``coords`` (R, L, 2) replaces ``cfg.polar_coords``
    (the eman2 ring groups, ``ops/eman_search.py::eman_mm_tables``).
    """
    if coords is None:
        coords = cfg.polar_coords  # (R, L, 2), [..., 0] = x offset, [..., 1] = y
    h = w = cfg.img_dim
    cx = w // 2
    cy = h // 2
    px = coords[..., 0].reshape(-1)
    py = coords[..., 1].reshape(-1)
    wy = np.stack([tent_rows(cy + py + dy, h) for dy in cfg.shift_y_vals])
    if x_window is not None:
        x0, width = x_window
        wx = np.stack([tent_rows(cx - x0 + px + dx, width)
                       for dx in cfg.shift_x_vals])
    else:
        wx = np.stack([tent_rows(cx + px + dx, w) for dx in cfg.shift_x_vals])
    return PolarTables(wy=wy, wx=wx, ring_num=coords.shape[0],
                       ring_len=coords.shape[1])


@lru_cache(maxsize=16)
def polar_tables(cfg, device: torch.device):
    """``build_polar_tables(cfg)``'s (wy, wx) on ``device``, copied there
    once per (cfg, device) (a device loop reads them with no copy)."""
    t = build_polar_tables(cfg)
    return (torch.as_tensor(t.wy, device=device),
            torch.as_tensor(t.wx, device=device))


# -- per-particle tents ------------------------------------------------

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


def translate_bilinear_mm(images, shift_x, shift_y, fast: bool = False):
    """``out[y, x] = bilinear(img, y + shift_y, x + shift_x)`` for each
    image, as two tent products: exact (a row and column permutation)
    for integer shifts.  ``fast=False`` (the default, as in JAX) takes
    full f32 products; ``fast=True`` rounds the image, the tents and the
    first product to bf16 (the module docstring)."""
    _n, h, w = images.shape
    ty = _tent_rows_traced(shift_y, h, torch.float32)   # (N, H, H)
    tx = _tent_rows_traced(shift_x, w, torch.float32)   # (N, W, W)
    x = images.to(torch.float32)
    if not fast:
        with _product_switches("f32"):
            return torch.bmm(torch.bmm(ty, x), tx.transpose(1, 2))
    ty, tx = _bf16_values(ty), _bf16_values(tx)
    with _product_switches(_held_route(images.device)):
        out = _bf16_values(torch.bmm(ty, _bf16_values(x)))
        return torch.bmm(out, tx.transpose(1, 2))


def translate_window_mm(images, shift_x, shift_y, lo: int, width: int):
    """Fused accumulated-shift translate + central-window extraction:
    ``out[n, a, b] = bilinear(img_n, lo + a + shift_y_n,
    lo + b + shift_x_n)`` for a, b in [0, width), as two tent products
    that only produce the window's rows and columns.

    It rounds where the JAX engine does (``fast=True``, the module
    docstring); its (N, width, width) f32 result holds the f32 sums of
    the second product, which the engine rounds to bf16.
    """
    _n, h, w = images.shape
    ty = _tent_rows_traced(shift_y, h, torch.float32, offset=lo,
                           out_size=width)          # (N, width, H)
    tx = _tent_rows_traced(shift_x, w, torch.float32, offset=lo,
                           out_size=width)          # (N, width, W)
    ty, tx = _bf16_values(ty), _bf16_values(tx)
    out = _bf16_values(torch.bmm(ty, _bf16_values(images.to(torch.float32))))
    return torch.bmm(out, tx.transpose(1, 2))       # (N, width, width)


# -- polar sampling ----------------------------------------------------

def polar_group_mm(img_t, wy_slice, wx_all, ring_num: int, ring_len: int,
                   fast: bool = False):
    """Sample one dy group of shift candidates for a whole batch.

    Args:
      img_t: (N, H, W) pre-translated images.
      wy_slice: (Q, H) tent matrix of this dy.
      wx_all: (n_dx, Q, W) tent matrices of every dx.
      fast: bf16 operands with f32 sums, the intermediate ``T`` rounded
        to bf16 between the two contractions (the JAX package's
        ``fast=True``); False = full f32.

    Returns:
      (N, n_dx, ring_num, ring_len) float32 polar stacks.

    The y contraction is one 2-D product ``Wy (Q, H) @ img (H, N*W)``,
    whose (Q, N, W) result feeds the x contraction as a product batched
    over the Q sample points, ``T[q] (N, W) @ Wx[:, q]^T (W, n_dx)``.
    """
    n, h, w = img_t.shape
    q = wy_slice.shape[0]
    n_dx = wx_all.shape[0]
    x = img_t.to(torch.float32).permute(1, 0, 2).reshape(h, n * w)
    if fast:
        t = mm_bf16(wy_slice, x, product_route(img_t.device))
        t = _bf16_values(t).view(q, n, w)
        with _product_switches(_held_route(img_t.device)):
            pol = torch.bmm(t, _bf16_values(wx_all).permute(1, 2, 0))
    else:
        with _product_switches("f32"):
            t = torch.mm(wy_slice, x).view(q, n, w)
            pol = torch.bmm(t, wx_all.permute(1, 2, 0))
    # (Q, N, n_dx) -> (N, n_dx, Q)
    return pol.permute(1, 2, 0).reshape(n, n_dx, ring_num, ring_len)


def polar_resample_mm(images, cfg):
    """Zero-shift polar resampling as full f32 tent products: the
    bilinear gather's values (the JAX package samples its references
    so)."""
    coords = cfg.polar_coords
    h = w = cfg.img_dim
    dev = images.device
    wy = torch.as_tensor(tent_rows(h // 2 + coords[..., 1].reshape(-1), h),
                         device=dev)
    wx = torch.as_tensor(tent_rows(w // 2 + coords[..., 0].reshape(-1), w),
                         device=dev)
    with _product_switches("f32"):
        t = torch.einsum("nhw,qh->nqw", images.to(torch.float32), wy)
    pol = (t * wx[None]).sum(-1)
    return pol.reshape(images.shape[0], cfg.ring_num, cfg.ring_len)
