"""Reference-preparation "user functions" (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/user_functions.py``; ``ref_data``
is ``[mask, center, raw average, fsc curve]`` and each function returns
``(prepared_average, [cs_x, cs_y])``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filters import filt_tanl
from ..ops.fsc import fit_tanh


def ref_ali2d(ref_data):
    """Tangent low-pass the raw average at the FSC-fitted cutoff.

    Centering (``center > 0``) is not ported yet (``ops/center.py``)."""
    _mask, center, tavg, frsc = ref_data
    if center is not None and center > 0:
        raise NotImplementedError(
            "ref_ali2d centering (center > 0) needs ops/center.py, which "
            "is not ported yet")
    fl, aa = fit_tanh(frsc)
    tavg = torch.as_tensor(np.asarray(tavg, np.float32))
    return filt_tanl(tavg, fl, aa).numpy(), [0.0, 0.0]


def ref_ali2d_no_filter(ref_data):
    """Pass-through variant (deterministic tests)."""
    return np.asarray(ref_data[2], np.float32), [0.0, 0.0]


factory = {
    "ref_ali2d": ref_ali2d,
    "ref_ali2d_no_filter": ref_ali2d_no_filter,
}
