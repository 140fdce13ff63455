"""Fourier shell (ring) correlation and tangent-filter fitting.

Equivalents of SPHIRE ``sp_statistics.fsc``/``fsc_mask`` (used per class in
the mref driver, test_mref_gpu_align.py:533-537, and per iteration in the
reffree driver, test_reffree_gpu_align.py:384-386) and ``sp_filter.fit_tanh``
(inside the ``ref_ali2d`` user function).
"""

from __future__ import annotations

import numpy as np


def _shell_index(h: int, w: int, nbins: int) -> np.ndarray:
    ky = np.fft.fftfreq(h) * h
    kx = np.fft.rfftfreq(w) * w
    r = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    idx = np.round(r).astype(np.int32)
    return np.where(idx < nbins, idx, nbins)  # overflow bucket at nbins


def _rfft2_weights(h: int, w: int) -> np.ndarray:
    """Multiplicity of each rfft2 bin in the full 2D FFT (hermitian halves).

    Columns kx=0 and kx=w/2 (even w) appear once; all others represent two
    conjugate entries of the full spectrum.
    """
    wgt = np.full(w // 2 + 1, 2.0, np.float32)
    wgt[0] = 1.0
    if w % 2 == 0:
        wgt[-1] = 1.0
    return np.broadcast_to(wgt[None, :], (h, w // 2 + 1)).copy()


def fsc(img1, img2, w: float = 1.0):
    """Fourier ring correlation of two (H, W) images.

    Returns (freq, fsc_values, n_terms) numpy arrays of length
    ``H//2 + 1``; freq[i] = i / (H * w) (absolute units, max 0.5 for w=1),
    matching the SPHIRE return convention ``[freqs, fsc, counts]``.
    """
    a = np.asarray(img1, np.float64)
    b = np.asarray(img2, np.float64)
    h, width = a.shape
    nbins = h // 2 + 1
    fa = np.fft.rfft2(a)
    fb = np.fft.rfft2(b)
    idx = _shell_index(h, width, nbins).ravel()
    mult = _rfft2_weights(h, width).ravel()

    cross = (fa * np.conj(fb)).real.ravel() * mult
    p1 = (np.abs(fa) ** 2).ravel() * mult
    p2 = (np.abs(fb) ** 2).ravel() * mult

    num = np.bincount(idx, weights=cross, minlength=nbins + 1)[:nbins]
    d1 = np.bincount(idx, weights=p1, minlength=nbins + 1)[:nbins]
    d2 = np.bincount(idx, weights=p2, minlength=nbins + 1)[:nbins]
    cnt = np.bincount(idx, weights=mult, minlength=nbins + 1)[:nbins]

    denom = np.sqrt(d1 * d2)
    vals = np.where(denom > 0, num / np.where(denom > 0, denom, 1.0), 0.0)
    freqs = np.arange(nbins, dtype=np.float64) / (h * w)
    return freqs, vals, cnt


def fsc_mask(img1, img2, mask, w: float = 1.0):
    """FSC of two images after masking (SPHIRE ``fsc_mask``: applies the
    binary mask, then computes fsc)."""
    m = np.asarray(mask)
    return fsc(np.asarray(img1) * m, np.asarray(img2) * m, w)


def write_fsc(path, freqs, vals, cnt):
    """Write the three-column text file the reference drops per class/iter
    (``drm%03d%04d.txt``, ``resolution%03d``)."""
    with open(path, "w") as f:
        for fr, v, c in zip(freqs, vals, cnt):
            f.write("%12.6f %12.6f %12.1f\n" % (fr, v, c))


def fit_tanh(fsc_curve, low: float = 0.1):
    """Fit (cutoff, falloff) of a tangent low-pass to an FSC curve.

    Reimplements SPHIRE ``sp_filter.fit_tanh`` semantics: the curve is
    zeroed beyond the first dip under ``low``, FSC values are mapped by
    ``2f/(1+f)`` (two-halves -> full-dataset correction), then (fl, aa) are
    fit by Nelder-Mead on the squared error against the tanh response.

    Args:
      fsc_curve: (freqs, values, ...) tuple as returned by :func:`fsc`.
    Returns:
      (cutoff_frequency, falloff) floats.
    """
    from scipy.optimize import minimize

    freqs = np.asarray(fsc_curve[0], np.float64)
    vals = np.asarray(fsc_curve[1], np.float64).copy()
    if vals[0] < 0.0:
        vals[0] *= -1.0
    # zero the curve after it first drops below `low`
    below = np.where(vals[1:] < low)[0]
    if below.size:
        vals[below[0] + 1:] = 0.0
    fsc_adj = 2.0 * vals / (1.0 + vals)

    def objective(args):
        fl, aa = args
        if fl <= 0.0 or aa <= 0.0:
            return np.sum(fsc_adj ** 2)
        c = np.pi / (2.0 * aa * fl)
        resp = 0.5 * (np.tanh(c * (freqs + fl)) - np.tanh(c * (freqs - fl)))
        return np.sum((fsc_adj - resp) ** 2)

    # initial guess: first 0.5-crossing of the adjusted curve
    under = np.where(fsc_adj < 0.5)[0]
    fl0 = freqs[under[0]] if under.size and under[0] > 0 else 0.25
    res = minimize(objective, x0=[max(fl0, 0.05), 0.1], method="Nelder-Mead",
                   options={"xatol": 1e-4, "fatol": 1e-6, "maxiter": 500})
    fl, aa = float(res.x[0]), float(res.x[1])
    fl = min(max(fl, 0.01), 0.49)
    aa = min(max(aa, 0.01), 0.49)
    return fl, aa
