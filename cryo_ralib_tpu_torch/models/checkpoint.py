"""Iteration checkpoint / resume for the alignment drivers (a copy of
``cryo_ralib_tpu/models/checkpoint.py``, with the same file layout, so
either package resumes from the other's ``checkpoint.npz``).

After every iteration the drivers write a compact state file and can
continue from it: per-particle AlignParams, current references/average,
the driver's scalar state (``x_``-prefixed extras), and the reseeding
RNG state (kept so vanished-class reseeds replay identically).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..params import AlignParams

CKPT_NAME = "checkpoint.npz"
RNG_NAME = "checkpoint_rng.pkl"


def save_checkpoint(outdir: str, iteration: int, params: AlignParams,
                    refs: np.ndarray, extra: dict | None = None,
                    rng=None) -> None:
    payload = {
        "iteration": np.int64(iteration),
        "angle": np.asarray(params.angle, np.float32),
        "shift_x": np.asarray(params.shift_x, np.float32),
        "shift_y": np.asarray(params.shift_y, np.float32),
        "mirror": np.asarray(params.mirror, np.int32),
        "ref_id": np.asarray(params.ref_id, np.int32),
        "refs": np.asarray(refs, np.float32),
    }
    for k, v in (extra or {}).items():
        payload["x_" + k] = np.asarray(v)
    tmp = os.path.join(outdir, CKPT_NAME + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, os.path.join(outdir, CKPT_NAME))
    if rng is not None:
        with open(os.path.join(outdir, RNG_NAME), "wb") as f:
            pickle.dump(rng.getstate(), f)


def load_checkpoint(outdir: str, rng=None):
    """Returns (iteration, AlignParams, refs, extra) or None."""
    path = os.path.join(outdir, CKPT_NAME)
    if not os.path.exists(path):
        return None
    z = np.load(path)
    params = AlignParams(z["angle"], z["shift_x"], z["shift_y"],
                         z["mirror"], z["ref_id"])
    extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    rng_path = os.path.join(outdir, RNG_NAME)
    if rng is not None and os.path.exists(rng_path):
        with open(rng_path, "rb") as f:
            rng.setstate(pickle.load(f))
    return int(z["iteration"]), params, np.asarray(z["refs"]), extra
