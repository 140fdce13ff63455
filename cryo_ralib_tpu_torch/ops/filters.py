"""Fourier-space filters and shifts (PyTorch).

Counterparts of ``cryo_ralib_tpu/ops/filters.py``: ``filt_tanl``, the
FSC-driven filter of the ``ref_ali2d`` user function, ``filt_tanl_dyn``,
the device loops' filter with its cutoff and falloff on the device, and
``fshift``, the sub-pixel Fourier shift of average centering, and
``filt_btwl``, EMAN2's Butterworth low-pass, on ``torch.fft.rfft2`` /
``irfft2``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def _freq_grid(h: int, w: int) -> np.ndarray:
    """|f| grid in rfft2 layout, absolute units (0 .. ~0.707)."""
    fy = np.fft.fftfreq(h).astype(np.float32)
    fx = np.fft.rfftfreq(w).astype(np.float32)
    return np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)


@lru_cache(maxsize=32)
def device_freq_grid(h: int, w: int, device: torch.device) -> torch.Tensor:
    """``_freq_grid`` on ``device``, copied there once per (h, w, device)
    so that a filter on the device copies nothing from the host."""
    return torch.as_tensor(_freq_grid(h, w), device=device)


def tanl_response(freq: np.ndarray, cutoff: float,
                  falloff: float) -> np.ndarray:
    """``0.5*(tanh(c*(f+cutoff)) - tanh(c*(f-cutoff)))``,
    ``c = pi/(2*falloff*cutoff)``; all-pass for a non-positive argument."""
    cutoff = float(cutoff)
    falloff = float(falloff)
    if cutoff <= 0.0 or falloff <= 0.0:
        return np.ones_like(freq)
    c = np.pi / (2.0 * falloff * cutoff)
    return (0.5 * (np.tanh(c * (freq + cutoff))
                   - np.tanh(c * (freq - cutoff)))).astype(np.float32)


def filt_tanl(img, cutoff: float, falloff: float):
    """Apply the tangent low-pass filter to (..., H, W) images."""
    h, w = img.shape[-2:]
    resp = torch.as_tensor(tanl_response(_freq_grid(h, w), cutoff, falloff),
                           device=img.device)
    f = torch.fft.rfft2(img)
    return torch.fft.irfft2(f * resp, s=(h, w)).to(img.dtype)


def filt_tanl_dyn(img, cutoff, falloff):
    """``filt_tanl`` with the cutoff and falloff as 0-d float32 tensors on
    the device of ``img`` (the device loops' per-iteration schedule, the
    CUDA standalone's ``ref_free_alignment_2D_filter_references``): the
    response is computed there, all-pass where either is <= 0, and
    nothing is read back to the host."""
    h, w = img.shape[-2:]
    freq = device_freq_grid(h, w, img.device)
    cutoff = torch.as_tensor(cutoff, dtype=torch.float32, device=img.device)
    falloff = torch.as_tensor(falloff, dtype=torch.float32,
                              device=img.device)
    c = math.pi / (2.0 * falloff * cutoff)
    resp = 0.5 * (torch.tanh(c * (freq + cutoff))
                  - torch.tanh(c * (freq - cutoff)))
    resp = torch.where((cutoff > 0.0) & (falloff > 0.0), resp,
                       torch.ones_like(resp))
    f = torch.fft.rfft2(img)
    return torch.fft.irfft2(f * resp, s=(h, w)).to(img.dtype)


def filt_btwl(img, freq_low: float, freq_high: float):
    """Butterworth low-pass of (..., H, W) images between the pass band
    ``freq_low`` and the stop band ``freq_high`` (EMAN2 ``filt_btwl``:
    -3 dB at the pass band, eps=0.882, the order from the band edges)."""
    img = torch.as_tensor(img)
    h, w = img.shape[-2:]
    eps = 0.882
    aa = 10.624
    order = (2.0 * np.log10(eps / np.sqrt(aa * aa - 1.0))
             / np.log10(freq_low / freq_high))
    rad = freq_low / (eps ** (2.0 / order))
    resp = (1.0 / np.sqrt(1.0 + (_freq_grid(h, w) / rad) ** order)
            ).astype(np.float32)
    f = torch.fft.rfft2(img)
    return torch.fft.irfft2(f * torch.as_tensor(resp, device=img.device),
                            s=(h, w)).to(img.dtype)


def fshift(img, sx, sy):
    """Sub-pixel translation by a Fourier phase ramp (EMAN2 ``fshift``):
    shifts the content of (..., H, W) images by (+sx, +sy) pixels; scalar
    or broadcastable per-image shifts."""
    img = torch.as_tensor(img)
    h, w = img.shape[-2:]
    dev = img.device
    fy = torch.as_tensor(np.fft.fftfreq(h).astype(np.float32), device=dev)
    fx = torch.as_tensor(np.fft.rfftfreq(w).astype(np.float32), device=dev)
    sx = torch.as_tensor(sx, dtype=torch.float32, device=dev)
    sy = torch.as_tensor(sy, dtype=torch.float32, device=dev)
    phase = -2.0 * torch.pi * (fy[:, None] * sy[..., None, None]
                               + fx[None, :] * sx[..., None, None])
    ramp = torch.complex(torch.cos(phase), torch.sin(phase))
    f = torch.fft.rfft2(img)
    return torch.fft.irfft2(f * ramp, s=(h, w)).to(img.dtype)
