"""EMAN2/SPHIRE variable-length ring plans (``Numrinit`` / ``ringwe``).

The reference's CPU twin aligns over rings whose per-ring sample count
is an FFT-friendly power of two near the circumference and weights ring
spectra with ``ringwe`` (``sp_alignment.Numrinit``/``ringwe``,
test_mref_gpu_align.py:741-750); its GPU path replaces that with
uniform ring_len=256 and linear (i+1) weights (SURVEY.md §3.3).  This
module is the production copy of the plan math for the opt-in
``ring_scheme="eman2"`` config (VERDICT r3 missing #1); the NumPy
golden model keeps its own independent copy in ``utils/oracle.py``
(tests assert the two agree).

NumPy-only on purpose — the plan is host-side geometry baked into the
jitted step as constants.
"""

from __future__ import annotations

import numpy as np


def numrinit(first_ring: int, last_ring: int, skip: int = 1,
             mode: str = "F") -> list[tuple[int, int]]:
    """``sp_alignment.Numrinit`` ring plan: [(radius, ring_len), ...].

    Per ring at radius k the length is the largest power of two <= the
    circumference sample count ``round(dpi*k)``, doubled when the true
    count overshoots by >50% (inner rings) or >20% (outermost ring),
    capped at 32768."""
    dpi = 2.0 * np.pi if mode in ("f", "F") else np.pi
    maxfft = 32768
    rings = []
    for k in range(first_ring, last_ring + 1, skip):
        jp = int(dpi * k + 0.5)
        ip = 1
        while ip * 2 <= jp:
            ip *= 2
        if k + skip <= last_ring and jp > ip + ip // 2:
            ip = min(maxfft, 2 * ip)
        if k + skip > last_ring and jp > ip + ip // 5:
            ip = min(maxfft, 2 * ip)
        rings.append((k, ip))
    return rings


def ringwe(rings: list[tuple[int, int]], mode: str = "F") -> np.ndarray:
    """``sp_alignment.ringwe`` weights: w_i = r_i * dpi / L_i * maxrin / L_i."""
    dpi = 2.0 * np.pi if mode in ("f", "F") else np.pi
    maxrin = rings[-1][1]
    return np.asarray([r * dpi / ln * maxrin / ln for r, ln in rings],
                      np.float64)
