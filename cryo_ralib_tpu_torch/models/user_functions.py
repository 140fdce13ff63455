"""Reference-preparation "user functions" (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/user_functions.py``; ``ref_data``
is ``[mask, center, raw average, fsc curve]`` and each function returns
``(prepared_average, [cs_x, cs_y])``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.center import center_2D
from ..ops.filters import filt_tanl
from ..ops.fsc import fit_tanh


@lru_cache(maxsize=4)
def _fit(freqs: bytes, values: bytes) -> tuple:
    return fit_tanh((np.frombuffer(freqs), np.frombuffer(values)))


def ref_ali2d(ref_data):
    """Tangent low-pass the raw average at the FSC-fitted cutoff; center
    it (``ops/center.py::center_2D``) when the center flag is positive.
    The fit depends on the curve alone, which ``mref_ali2d`` passes alike
    for every class of an iteration, so it is made once per curve (at
    K=64 the 64 identical Nelder-Mead fits were nine tenths of the
    host's reference update)."""
    _mask, center, tavg, frsc = ref_data
    fl, aa = _fit(np.asarray(frsc[0], np.float64).tobytes(),
                  np.asarray(frsc[1], np.float64).tobytes())
    out = filt_tanl(torch.as_tensor(np.asarray(tavg, np.float32)), fl, aa)
    cs = [0.0, 0.0]
    if center is not None and center > 0:
        out, sx, sy = center_2D(out, int(center))
        cs = [float(sx), float(sy)]
    return out.numpy(), cs


def ref_ali2d_no_filter(ref_data):
    """Pass-through variant (deterministic tests)."""
    return np.asarray(ref_data[2], np.float32), [0.0, 0.0]


factory = {
    "ref_ali2d": ref_ali2d,
    "ref_ali2d_no_filter": ref_ali2d_no_filter,
}
