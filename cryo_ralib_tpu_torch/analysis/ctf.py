"""Contrast transfer function computation (a copy of
``cryo_ralib_tpu/analysis/ctf.py``; ``ops/ctf_ops.py`` holds the tensor
version the alignment uses).

Port of ``compute_ctf_np`` / ``print_ctf_params`` (reference
src/utils_ralib.py:354-386,178-188): full 2D CTF with defocus
astigmatism, spherical aberration, amplitude contrast, phase shift and
optional B-factor envelope, on numpy arrays.
"""

from __future__ import annotations

import numpy as np

CTF_HEADERS = ["D", "apix", "DefocusU", "DefocusV", "DefocusAngle",
               "Voltage", "SphericalAberration", "AmplitudeContrast",
               "PhaseShift"]


def ctf_freqs(d: int, apix: float = 1.0):
    """(D*D, 2) grid of 2D spatial frequencies in 1/Angstrom, matching the
    reference's meshgrid convention (src/utils_ralib.py:393-395)."""
    ax = np.linspace(-0.5, 0.5, d, endpoint=False)
    freqs = np.stack(np.meshgrid(ax, ax), -1) / apix
    return freqs.reshape(-1, 2)


def compute_ctf(freqs, dfu, dfv, dfang, volt, cs, w, phase_shift=0.0,
                bfactor=None, xp=np):
    """2D CTF at the given spatial frequencies.

    Args mirror ``compute_ctf_np`` (src/utils_ralib.py:354-386):
      freqs: (M, 2) spatial frequencies (1/A).
      dfu, dfv: defocus U/V (A);  dfang: astigmatism angle (deg).
        Scalars give the reference behavior; (N,) arrays broadcast a
        particle axis and return (N, M).
      volt: kV;  cs: mm;  w: amplitude contrast ratio;
      phase_shift: deg — scalar, or (N,) for per-particle phase plates
        (Volta stacks carry varying phase shifts per particle);
      bfactor: envelope B-factor (A^2) or None.
      xp: numpy, or another module with numpy's functions.
    Returns (M,) CTF values, or (N, M) for per-particle defocus arrays.
    """
    volt = volt * 1000.0
    cs = cs * 1e7
    dfu = xp.asarray(dfu)
    dfv = xp.asarray(dfv)
    dfang = xp.asarray(dfang) * (np.pi / 180.0)
    phase_shift = xp.asarray(phase_shift) * (np.pi / 180.0)
    lam = 12.2639 / np.sqrt(volt + 0.97845e-6 * volt ** 2)
    x = freqs[:, 0]
    y = freqs[:, 1]
    ang = xp.arctan2(y, x)
    s2 = x ** 2 + y ** 2
    if max(getattr(a, "ndim", 0)
           for a in (dfu, dfv, dfang, phase_shift)):
        dfu = xp.reshape(dfu, (-1, 1))
        dfv = xp.reshape(dfv, (-1, 1))
        dfang = xp.reshape(dfang, (-1, 1))
        if getattr(phase_shift, "ndim", 0):
            phase_shift = xp.reshape(phase_shift, (-1, 1))
        ang = ang[None, :]
        s2 = s2[None, :]
    df = 0.5 * (dfu + dfv + (dfu - dfv) * xp.cos(2.0 * (ang - dfang)))
    gamma = (2.0 * np.pi * (-0.5 * df * lam * s2
                            + 0.25 * cs * lam ** 3 * s2 ** 2) - phase_shift)
    ctf = np.sqrt(1.0 - w ** 2) * xp.sin(gamma) - w * xp.cos(gamma)
    if bfactor is not None:
        ctf = ctf * xp.exp(-bfactor / 4.0 * s2)
    return ctf


# alias matching the reference name
compute_ctf_np = compute_ctf


def print_ctf_params(params):
    """src/utils_ralib.py:178-188."""
    assert len(params) == 9
    for header, val in zip(CTF_HEADERS, params):
        print(f"{header}: {val}")
