"""2-D Fourier variance of an aligned particle stack, ``--Fourvar``
(PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/fourvar.py`` (SPHIRE ``varf2d``
semantics): per frequency bin of the rfft2 spectrum of each *aligned*
(transformed, masked) particle, accumulate the complex sum and the power
sum, and finalise the unbiased sample variance

    var_k = (sum_i |f_ik|^2 - |sum_i f_ik|^2 / n) / (n - 1).

``ali2d_base`` divides the average's spectrum by it and writes the
variance image as ``varf.hdf``.  The particles are aligned as the JAX
package aligns them: by default (``engine="shear"``, ``fast=True``, what
its ``ali2d_base_tpu`` calls on every backend) by the FFT shear of
``ops/transform.py::transform_batch_mm`` with its bf16 DFTs, or with
``engine="exact"`` by the bilinear ``transform_batch``.  The spectra are
``torch.fft.rfft2`` (JAX: f32 matmul DFTs).  The division of the average
and the radial profile are (H, W)-sized host work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import AlignParams
from ..parallel.mesh import all_reduce_sums, ref_slice
from .fsc import _rfft2_weights, _shell_index
from .transform import transform_batch, transform_batch_mm


def fourier_moments(images, params: AlignParams, mask=None, valid=None,
                    engine: str = "shear", fast: bool = True):
    """Spectral moments of the aligned batch.

    Args:
      images: (N, H, W) raw particles.
      params: AlignParams with (N,) fields.
      mask: optional (H, W) real-space mask, applied after interpolation.
      valid: optional (N,) 0/1 weights.
      engine: "shear" (``transform_batch_mm``, with ``fast``) or "exact"
        (the bilinear ``transform_batch``).
    Returns:
      (sum_re, sum_im, sum_sq, n): (H, F) float64 x 3 (summed over the
      particles in f64, the JAX package's in f32) and the count (a 0-dim
      tensor).
    """
    if engine == "shear":
        t = transform_batch_mm(images, params, fast=fast)
    elif engine == "exact":
        t = transform_batch(images, params)
    else:
        raise ValueError(f"engine must be 'shear' or 'exact', not {engine!r}")
    if mask is not None:
        t = t * torch.as_tensor(mask, dtype=t.dtype, device=t.device)[None]
    f = torch.fft.rfft2(t)                                  # (N, H, F)
    # summed over the particles in f64: the variance is a difference of
    # two large sums, so an f32 sum's order (a chunk, a rank's block)
    # would move its smallest bins
    re, im = f.real.double(), f.imag.double()
    sq = re * re + im * im
    if valid is None:
        n = torch.tensor(float(images.shape[0]), device=images.device)
        sums = re.sum(0), im.sum(0), sq.sum(0)
    else:
        w = torch.as_tensor(valid, dtype=torch.float64,
                            device=images.device)[:, None, None]
        sums = (re * w).sum(0), (im * w).sum(0), (sq * w).sum(0)
        n = w.sum()
    return (*sums, n)


def finalize_variance(sum_re, sum_im, sum_sq, n):
    """Unbiased per-frequency sample variance from accumulated moments
    (numpy float64)."""
    sum_re = np.asarray(sum_re, np.float64)
    sum_im = np.asarray(sum_im, np.float64)
    sum_sq = np.asarray(sum_sq, np.float64)
    n = float(n)
    var = (sum_sq - (sum_re ** 2 + sum_im ** 2) / n) / max(n - 1.0, 1.0)
    return np.maximum(var, 0.0)


def radial_variance(var):
    """Rotational average of the (H, F) variance, varf2d's ``rvar``: the
    Hermitian-weighted mean per integer radius, length ``H//2 + 1``."""
    var = np.asarray(var, np.float64)
    h, _f = var.shape
    nbins = h // 2 + 1
    idx = _shell_index(h, h, nbins).ravel()
    mult = _rfft2_weights(h, h).ravel()
    num = np.bincount(idx, weights=var.ravel() * mult,
                      minlength=nbins + 1)[:nbins]
    cnt = np.bincount(idx, weights=mult, minlength=nbins + 1)[:nbins]
    return num / np.maximum(cnt, 1.0)


def variance_map(var):
    """Full-plane centred real image of the variance for ``varf.hdf``: the
    Hermitian unfold of the rfft2 half-plane, fftshifted so that DC sits
    at the centre."""
    var = np.asarray(var, np.float64)
    h, f = var.shape
    w = h
    full = np.zeros((h, w), np.float64)
    full[:, :f] = var
    # Hermitian half: full[ky, kx] = var[-ky mod h, -kx mod w]
    kx = np.arange(f, w)
    src_kx = (w - kx) % w
    src_ky = (h - np.arange(h)) % h
    full[:, f:] = var[src_ky[:, None], src_kx[None, :]]
    return np.fft.fftshift(full).astype(np.float32)


def fourier_variance(data, params: AlignParams, mask=None,
                     batch: int = 4096, mesh=None, engine: str = "shear",
                     fast: bool = True):
    """Chunked variance of a whole stack (``engine`` and ``fast`` as in
    ``fourier_moments``).

    ``data`` (N, H, W) and ``params`` are numpy arrays or tensors on the
    host or on the device; each chunk of ``batch`` particles goes to the
    device of ``mask`` (else of ``data``, else the CPU), where its
    moments are summed in float64, and the chunks add up in float64 on
    the host.  Under a ``mesh`` ``data`` and ``params`` are the rank's
    block, and the moments and the count are all-reduced (one float64
    buffer) before the variance is finalised; every rank calls it (on a
    2-D mesh each rank of a ref group takes its share of the block,
    ``ref_slice``).  Returns ``(var (H, F), rvar (H//2+1,))`` as float32
    numpy arrays.
    """
    device = (mask.device if torch.is_tensor(mask) else
              data.device if torch.is_tensor(data) else "cpu")
    n, h, _w = data.shape
    acc = [np.zeros((h, h // 2 + 1), np.float64) for _ in range(3)]
    total = 0.0
    first, last = ref_slice(n, mesh)
    for start in range(first, last, batch):
        sl = slice(start, min(start + batch, last))
        imgs = torch.as_tensor(data[sl], dtype=torch.float32, device=device)
        part = AlignParams(*[torch.as_tensor(f[sl], device=device)
                             for f in params])
        *sums, cnt = fourier_moments(imgs, part, mask=mask, engine=engine,
                                     fast=fast)
        for a, s in zip(acc, sums):
            a += s.double().cpu().numpy()
        total += float(cnt)
    if mesh is not None:
        buf = torch.from_numpy(np.concatenate(
            [a.ravel() for a in acc] + [np.array([total])]))
        all_reduce_sums(mesh, buf)
        buf = buf.numpy()
        acc = [buf[i * acc[0].size:(i + 1) * acc[0].size].reshape(
            acc[0].shape) for i in range(3)]
        total = float(buf[-1])
    var = finalize_variance(acc[0], acc[1], acc[2], total)
    return var.astype(np.float32), radial_variance(var).astype(np.float32)


def divide_by_variance(avg: np.ndarray, var: np.ndarray) -> np.ndarray:
    """Divide the average's spectrum by the Fourier variance (host (H, W)
    work, numpy FFT).  A zero-variance bin (degenerate synthetic data
    only) keeps its coefficient."""
    avg = np.asarray(avg, np.float64)
    var = np.asarray(var, np.float64)
    spec = np.fft.rfft2(avg)
    safe = np.where(var > 0.0, var, 1.0)
    return np.fft.irfft2(spec / safe, s=avg.shape).astype(np.float32)
