"""The plain reference of one alignment iteration, in PyTorch and NumPy.

It imports nothing of the system under test (``cryo_ralib_tpu_torch``),
nor ``jax`` nor ``cryo_ralib_tpu``.  It follows the published algorithm
of the rib80s benchmark's drivers (SPHIRE ``mref_ali2d`` /
``ali2d_base`` with the reference GPU search): particles and references
normalised under a disc mask; every particle searched on 256-sample
polar rings, at every shift of the grid around its accumulated shift,
mirrored and not, against every reference, by ring-FFT
cross-correlation weighted by the ring radius; the winner decoded with
a 7-point parabolic angle fit; the particles rotated and shifted
bilinearly and summed per class and parity; the references rebuilt from
the sums by FSC, a tangent low-pass fitted to it, and mask
normalisation.

``rounding`` is the identity for the reference.  The control
(``tf32``) rounds the operands of every product that a matrix unit
would take (the polar samples, the ring spectra, the ccf spectra, the
images summed per class) to TF32, with f32 sums: the reference computed
in the next precision below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

RING_LEN = 256


def identity(x):
    return x


def tf32(x):
    """``x`` (float32, or complex64 as pairs) rounded to TF32's 10-bit
    mantissa, to nearest, ties to even."""
    if x.is_complex():
        return torch.view_as_complex(tf32(torch.view_as_real(x)))
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


class Geometry:
    """The search grid of a configuration: rings 1..ou of ``RING_LEN``
    samples, ring weights equal to the radius, shifts x-major over
    [-xr, xr] x [-yr, yr] in steps of ts, the shift clamp."""

    def __init__(self, nx: int, ou: int, xr: float, yr: float, ts: float,
                 mirror: bool = True, device="cpu"):
        self.nx, self.ou = int(nx), int(ou)
        radii = np.arange(1, self.ou + 1, dtype=np.float64)
        ang = np.arange(RING_LEN, dtype=np.float64) / RING_LEN * 2.0 * np.pi
        coords = np.stack([np.cos(ang)[None] * radii[:, None],
                           np.sin(ang)[None] * radii[:, None]], -1)
        self.coords = torch.as_tensor(coords.astype(np.float32),
                                      device=device)          # (R, L, 2)
        self.weights = torch.as_tensor(radii.astype(np.float32),
                                       device=device)         # (R,)
        xs = _grid(xr, ts)
        ys = _grid(yr, ts)
        self.shifts = torch.as_tensor(
            np.array([(x, y) for x in xs for y in ys], np.float32),
            device=device)                                     # (S, 2)
        self.n_shifts = int(self.shifts.shape[0])
        self.n_mirr = 2 if mirror else 1
        self.limit = float(self.nx - self.ou - 2)
        self.step = 360.0 / RING_LEN


def _grid(rng: float, step: float) -> list:
    n = int(round(2 * rng / step))
    return [-rng + i * step for i in range(n + 1)]


def disc(radius: float, nx: int) -> np.ndarray:
    """Binary disc of ``radius`` about (nx//2, nx//2)."""
    yy, xx = np.mgrid[0:nx, 0:nx]
    c = nx // 2
    return (((yy - c) ** 2 + (xx - c) ** 2) <= radius * radius
            ).astype(np.float32)


def normalize(x, mask, sigma: bool):
    """Subtract the mean under ``mask``; with ``sigma`` divide by the
    standard deviation under it too."""
    cnt = mask.sum()
    mean = (x * mask).sum(dim=(-2, -1)) / cnt
    out = x - mean[..., None, None]
    if sigma:
        var = (out * out * mask).sum(dim=(-2, -1)) / cnt
        sd = torch.sqrt(var.clamp(min=0.0))
        out = out / torch.where(sd > 0, sd, torch.ones_like(sd))[..., None,
                                                                 None]
    return out


def bilinear(images, y, x):
    """Clamp-to-edge bilinear reads of (N, H, W) at (N, M) coordinates."""
    n, h, w = images.shape
    flat = images.reshape(n, h * w)
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    ix0, iy0 = x0.long(), y0.long()
    ix1 = (ix0 + 1).clamp(max=w - 1)
    iy1 = (iy0 + 1).clamp(max=h - 1)

    def at(iy, ix):
        return torch.gather(flat, 1, iy * w + ix)

    top = at(iy0, ix0) * (1.0 - fx) + at(iy0, ix1) * fx
    bot = at(iy1, ix0) * (1.0 - fx) + at(iy1, ix1) * fx
    return top * (1.0 - fy) + bot * fy


def transform(images, angle, sx, sy, mirror):
    """Mirror (x -> w - x), rotate by ``angle`` degrees about the centre,
    shift by (sx, sy), as an inverse map with bilinear reads."""
    n, h, w = images.shape
    dev = images.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xx, yy = xx.reshape(1, -1), yy.reshape(1, -1)
    src_x = torch.where(mirror[:, None] == 1, w - xx, xx)
    a = (angle.float() * (math.pi / 180.0))[:, None]
    c, s = torch.cos(a), torch.sin(a)
    ux, uy = src_x - w // 2, yy - h // 2
    rx = ux * c - uy * s + w // 2 + sx.float()[:, None]
    ry = ux * s + uy * c + h // 2 + sy.float()[:, None]
    return bilinear(images, ry, rx).reshape(n, h, w)


# ---- the search ---------------------------------------------------------

def ref_spectra(refs, geo: Geometry, rounding=identity):
    """Weighted ring spectra (K, R, F) of normalised references."""
    k = refs.shape[0]
    c = refs.shape[-1] // 2
    x = c + geo.coords[..., 0].reshape(1, -1).expand(k, -1)
    y = c + geo.coords[..., 1].reshape(1, -1).expand(k, -1)
    polar = rounding(bilinear(refs, y, x).reshape(k, -1, RING_LEN))
    return torch.fft.rfft(polar, dim=-1) * geo.weights[None, :, None]


def ccf_rows(images, ref_f, prev_sx, prev_sy, geo: Geometry, s0: int,
             s1: int, rounding=identity):
    """(N, M, s1-s0, K, L) rotational ccf rows of the particles at the
    grid shifts ``s0 .. s1-1`` around their accumulated shifts, [not
    mirrored, mirrored] on axis 1."""
    n = images.shape[0]
    c = images.shape[-1] // 2
    grid = geo.shifts[s0:s1]
    sx = prev_sx[:, None] + grid[None, :, 0]
    sy = prev_sy[:, None] + grid[None, :, 1]
    px = geo.coords[..., 0].reshape(1, 1, -1)
    py = geo.coords[..., 1].reshape(1, 1, -1)
    x = c + sx[:, :, None] + px
    y = c + sy[:, :, None] + py
    polar = bilinear(images, y.reshape(n, -1), x.reshape(n, -1))
    polar = rounding(polar.reshape(n, s1 - s0, -1, RING_LEN))
    spec = rounding(torch.fft.rfft(polar, dim=-1))          # (N, C, R, F)
    ref_f = rounding(ref_f)
    orig = torch.einsum("ncrf,krf->nckf", spec.conj(), ref_f)
    parts = [orig]
    if geo.n_mirr == 2:
        parts.append(torch.einsum("ncrf,krf->nckf", spec, ref_f).conj())
    spec_ccf = rounding(torch.stack(parts, 1))
    return torch.fft.irfft(spec_ccf, n=RING_LEN, dim=-1)


def all_rows(images, refs, prev_sx, prev_sy, geo: Geometry,
             rounding=identity, chunk: int = 7):
    """Every candidate's ccf row: (N, M, S, K, L)."""
    ref_f = ref_spectra(refs, geo, rounding)
    return torch.cat([ccf_rows(images, ref_f, prev_sx, prev_sy, geo, s,
                               min(s + chunk, geo.n_shifts), rounding)
                      for s in range(0, geo.n_shifts, chunk)], 2)


def argmax_pick(rows):
    """The exhaustive search's winner of each particle: the largest value,
    the first in (mirror, shift, ref, angle) order on ties; returns
    (mirror, sidx, ref, aidx) int64 tensors."""
    n, m, s, k, L = rows.shape
    idx = rows.reshape(n, -1).argmax(1)
    return (idx // (s * k * L), (idx // (k * L)) % s, (idx // L) % k,
            idx % L)


def shc_pick(rows, previousmax):
    """SHC's pick: the first candidate in (mirror, shift, ref) order whose
    row peak is strictly above ``previousmax``, with its row's argmax;
    returns (found, mirror, sidx, ref, aidx)."""
    n, m, s, k, L = rows.shape
    peaks = rows.amax(-1).reshape(n, -1)
    passing = peaks > previousmax[:, None]
    found = passing.any(1)
    first = torch.where(passing, torch.arange(m * s * k, device=rows.device),
                        m * s * k).amin(1).clamp(max=m * s * k - 1)
    row = rows.reshape(n, -1, L)[torch.arange(n, device=rows.device), first]
    return (found, first // (s * k), (first // k) % s, first % k,
            row.argmax(-1))


def decode(row, aidx, sidx, mirror, prev_sx, prev_sy, geo: Geometry):
    """(angle, sx, sy) of a winner: the 7-point parabolic fit about the
    peak bin (no offset where the fit is flat), 360 minus it, 180 more
    when mirrored (wrapped into [0, 360)); shifts accumulated and
    clamped."""
    step = geo.step
    offs = torch.arange(-3, 4, device=row.device)
    x = torch.gather(row, 1, (aidx.long()[:, None] + offs) % RING_LEN)
    c2 = (49.0 * x[:, 0] + 6.0 * x[:, 1] - 21.0 * x[:, 2] - 32.0 * x[:, 3]
          - 27.0 * x[:, 4] - 6.0 * x[:, 5] + 31.0 * x[:, 6])
    c3 = 5.0 * x[:, 0] - 3.0 * x[:, 2] - 4.0 * x[:, 3] - 3.0 * x[:, 4] \
        + 5.0 * x[:, 6]
    frac = torch.where(c3 != 0.0, step * (c2 / (2.0 * c3) - 4.0),
                       torch.zeros_like(c3))
    angle = 360.0 - (step * aidx.float() + frac)
    flipped = angle + 180.0
    flipped = torch.where(flipped >= 360.0, flipped - 360.0, flipped)
    angle = torch.where(mirror == 1, flipped, angle)
    d = geo.shifts[sidx.long()]
    sx = (prev_sx + d[:, 0]).clamp(-geo.limit, geo.limit)
    sy = (prev_sy + d[:, 1]).clamp(-geo.limit, geo.limit)
    return angle, sx, sy


# ---- the class sums -----------------------------------------------------

def class_sums(images, angle, sx, sy, mirror, ref_id, n_classes: int,
               block: int = 2048, rounding=identity):
    """(K, 2, H, W) float64 even/odd sums of the transformed particles
    (parity of the global index), and the (K,) counts.  ``images`` are
    the whole stack's normalised particles, the params whole-stack
    tensors on the same device."""
    n, h, w = images.shape
    dev = images.device
    sums = torch.zeros((2 * n_classes, h * w), dtype=torch.float64,
                       device=dev)
    for s in range(0, n, block):
        e = min(n, s + block)
        t = rounding(transform(images[s:e], angle[s:e], sx[s:e], sy[s:e],
                               mirror[s:e]))
        slot = ref_id[s:e].long() * 2 + torch.arange(s, e, device=dev) % 2
        sums.index_add_(0, slot, t.reshape(e - s, -1).double())
    counts = torch.bincount(ref_id.long(), minlength=n_classes)
    return sums.reshape(n_classes, 2, h, w), counts


def header_shift_sums(angle, sx, sy, mirror):
    """Sums of the header-convention shifts (shift after rotation), x
    with the mirror's sign, in float64."""
    a = angle.double() * (math.pi / 180.0)
    c, s = torch.cos(a), -torch.sin(a)
    hx = -sx.double() * c + sy.double() * s
    hy = -sx.double() * s - sy.double() * c
    sgn = torch.where(mirror == 1, -1.0, 1.0).double()
    return float((hx * sgn).sum()), float(hy.sum())


# ---- the reference update on the host ----------------------------------

def fsc(a, b):
    """Fourier ring correlation of two images: (freqs, values)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    h, w = a.shape
    nb = h // 2 + 1
    fa, fb = np.fft.rfft2(a), np.fft.rfft2(b)
    ky = np.fft.fftfreq(h) * h
    kx = np.fft.rfftfreq(w) * w
    shell = np.round(np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2))
    shell = np.minimum(shell.astype(np.int64), nb).ravel()
    mult = np.full(w // 2 + 1, 2.0)
    mult[0] = 1.0
    if w % 2 == 0:
        mult[-1] = 1.0
    mult = np.broadcast_to(mult[None], (h, w // 2 + 1)).ravel()

    def ring(v):
        return np.bincount(shell, weights=v.ravel() * mult,
                           minlength=nb + 1)[:nb]

    num = ring((fa * np.conj(fb)).real)
    den = np.sqrt(ring(np.abs(fa) ** 2) * ring(np.abs(fb) ** 2))
    vals = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    return np.arange(nb, dtype=np.float64) / h, vals


def fit_tanh(freqs, vals, low: float = 0.1):
    """SPHIRE ``fit_tanh``: the FSC cut after its first dip under
    ``low``, mapped by 2f/(1+f), fitted by Nelder-Mead with the tangent
    low-pass response; (cutoff, falloff) clamped into [0.01, 0.49]."""
    from scipy.optimize import minimize

    vals = np.array(vals, np.float64)
    if vals[0] < 0.0:
        vals[0] = -vals[0]
    below = np.nonzero(vals[1:] < low)[0]
    if below.size:
        vals[below[0] + 1:] = 0.0
    target = 2.0 * vals / (1.0 + vals)

    def loss(p):
        fl, aa = p
        if fl <= 0.0 or aa <= 0.0:
            return np.sum(target ** 2)
        c = np.pi / (2.0 * aa * fl)
        resp = 0.5 * (np.tanh(c * (freqs + fl)) - np.tanh(c * (freqs - fl)))
        return np.sum((target - resp) ** 2)

    under = np.nonzero(target < 0.5)[0]
    fl0 = freqs[under[0]] if under.size and under[0] > 0 else 0.25
    res = minimize(loss, x0=[max(fl0, 0.05), 0.1], method="Nelder-Mead",
                   options={"xatol": 1e-4, "fatol": 1e-6, "maxiter": 500})
    return (min(max(float(res.x[0]), 0.01), 0.49),
            min(max(float(res.x[1]), 0.01), 0.49))


def _freq(h: int, w: int) -> np.ndarray:
    fy = np.fft.fftfreq(h).astype(np.float32)
    fx = np.fft.rfftfreq(w).astype(np.float32)
    return np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)


def lowpass(img, fl: float, aa: float) -> np.ndarray:
    """The tangent low-pass at cutoff ``fl`` and falloff ``aa``."""
    img = np.asarray(img, np.float32)
    c = np.pi / (2.0 * aa * fl)
    f = _freq(*img.shape)
    resp = (0.5 * (np.tanh(c * (f + fl)) - np.tanh(c * (f - fl)))
            ).astype(np.float32)
    t = torch.fft.rfft2(torch.as_tensor(img))
    return torch.fft.irfft2(t * torch.as_tensor(resp),
                            s=img.shape).numpy().astype(np.float32)


def fourier_shift(img, sx: float, sy: float) -> np.ndarray:
    """The image's content moved by (+sx, +sy) pixels by a phase ramp."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    fy = torch.as_tensor(np.fft.fftfreq(h).astype(np.float32))
    fx = torch.as_tensor(np.fft.rfftfreq(w).astype(np.float32))
    ph = -2.0 * torch.pi * (fy[:, None] * torch.tensor(sy, dtype=torch.float32)
                            + fx[None, :] * torch.tensor(sx,
                                                         dtype=torch.float32))
    t = torch.fft.rfft2(torch.as_tensor(img))
    return torch.fft.irfft2(t * torch.complex(torch.cos(ph), torch.sin(ph)),
                            s=(h, w)).numpy().astype(np.float32)


def mref_update(sums, counts, mask: np.ndarray, n: int, rng: random.Random,
                particle) -> np.ndarray:
    """The K new references from the iteration's (K, 2, H, W) sums and
    counts: a class of fewer than 4 members is reseeded with a particle
    drawn by ``rng`` (``particle(i)`` gives the normalised particle i);
    the others are the sum over the count; every reference is low-passed
    at the fit of the class-averaged FSC and mask-normalised (mean
    only)."""
    k = sums.shape[0]
    out = np.empty(sums.shape[:1] + sums.shape[2:], np.float32)
    curves, last = [], None
    for j in range(k):
        if counts[j] < 4:
            out[j] = particle(rng.randint(0, n - 1))
            continue
        freqs, vals = fsc(sums[j, 0], sums[j, 1])
        out[j] = (sums[j, 0] + sums[j, 1]) / float(counts[j])
        curves.append(vals)
        last = freqs
    fit = None
    if curves:
        ave = (np.sum(curves, 0) / len(curves) if np.sum(curves) != 0
               else curves[-1])
        fit = fit_tanh(last, ave)
    m = torch.as_tensor(mask)
    for j in range(k):
        img = out[j] if fit is None else lowpass(out[j], *fit)
        out[j] = normalize(torch.as_tensor(img), m, sigma=False).numpy()
    return out


def reffree_average(sums, n: int, sx_sum: float, sy_sum: float,
                    mask: np.ndarray) -> np.ndarray:
    """The average the reference-free search aligns to, from the previous
    pass's (1, 2, H, W) sums: (even + odd) / n, low-passed at the fit of
    the masked halves' FSC, then moved back by the mean header shift."""
    a, b = np.asarray(sums[0, 0]), np.asarray(sums[0, 1])
    avg = ((a + b) / n).astype(np.float32)
    freqs, vals = fsc(a * mask, b * mask)
    fl, aa = fit_tanh(freqs, vals)
    return fourier_shift(lowpass(avg, fl, aa), -sx_sum / n, -sy_sum / n)
