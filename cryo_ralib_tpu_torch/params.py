"""Per-particle 2D alignment parameters (PyTorch).

Counterpart of ``cryo_ralib_tpu/params.py``: the struct-of-arrays
``AlignParams`` state, the search-to-header shift decode, the
``params_table`` rows of ``final2Dparams.txt``, the ``pixel_error_2D``
QC metric and the SPHIRE transform algebra (``combine_params2``,
``inverse_transform2``).  ``params_from_numpy`` /
``AlignParams.to_numpy`` carry state across packages: they take and give
exactly the dict of the JAX ``AlignParams.to_numpy()``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class AlignParams(NamedTuple):
    """Alignment state for a stack of N particles, one tensor per field:
    angle, shift_x, shift_y (N,) float32; mirror, ref_id (N,) int32."""

    angle: torch.Tensor
    shift_x: torch.Tensor
    shift_y: torch.Tensor
    mirror: torch.Tensor
    ref_id: torch.Tensor

    @staticmethod
    def zeros(n: int, device="cpu", ref_id: int = 0) -> "AlignParams":
        """Fresh params with every particle assigned to ``ref_id``."""
        return AlignParams(
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.int32, device=device),
            torch.full((n,), ref_id, dtype=torch.int32, device=device),
        )

    def to_numpy(self) -> dict:
        return {name: getattr(self, name).cpu().numpy()
                for name in self._fields}


_DTYPES = {"angle": torch.float32, "shift_x": torch.float32,
           "shift_y": torch.float32, "mirror": torch.int32,
           "ref_id": torch.int32}


def params_from_numpy(d: dict, device="cpu") -> AlignParams:
    """``AlignParams`` from the dict that either package's ``to_numpy``
    returns."""
    return AlignParams(*[torch.as_tensor(np.array(d[name]), dtype=dt,
                                         device=device)
                         for name, dt in _DTYPES.items()])


def gpu_params_to_align2d(angle, shift_x, shift_y):
    """Search params (shift before rotation) -> header-convention shifts
    (shift after rotation): ``(sx', sy') = R(-angle) @ (-sx, -sy)``."""
    ang = angle * (math.pi / 180.0)
    c = torch.cos(ang)
    s = -torch.sin(ang)
    sx_neg = -shift_x
    sy_neg = -shift_y
    out_sx = sx_neg * c - sy_neg * s
    out_sy = sx_neg * s + sy_neg * c
    return out_sx, out_sy


def _algebra(*args):
    """The array module of the transform algebra and its converters
    ``(xp, asarray, asfloat)``: torch on the device of the first tensor
    argument, floats in float32, if any argument is a tensor; numpy,
    floats in float64, otherwise (as the JAX package's numpy path)."""
    t = next((a for a in args if torch.is_tensor(a)), None)
    if t is None:
        return np, np.asarray, lambda v: np.asarray(v, np.float64)

    def as_t(v):
        return torch.as_tensor(v, device=t.device)

    return torch, as_t, lambda v: as_t(v).float()


def combine_params2(alpha1, sx1, sy1, mirror1, alpha2, sx2, sy2, mirror2):
    """Compose two 2D align transforms: the result applies T1, then T2
    (SPHIRE ``sp_utilities.combine_params2``, in plain trigonometry).

    With each transform in mirror-last form ``T(p) = F^m (R(a) p + t)``
    (F = x-flip)::

        mirror = m1 ^ m2
        alpha  = a1 + (-1)^m1 * a2   (mod 360)
        t      = R((-1)^m1 * a2) @ t1 + F^m1 @ t2

    Arguments are scalars or arrays, mirrors 0/1.  Numpy (or Python
    numbers) in gives numpy out, in float64; any tensor in gives tensors
    out on its device, in float32.
    """
    xp, asarray, asfloat = _algebra(alpha1, sx1, sy1, mirror1, alpha2, sx2,
                                    sy2, mirror2)
    m1, m2 = asarray(mirror1), asarray(mirror2)
    a1, a2 = asfloat(alpha1), asfloat(alpha2)
    x1, y1, x2, y2 = (asfloat(v) for v in (sx1, sy1, sx2, sy2))
    sign1 = xp.where(m1 == 1, -1.0, 1.0)
    ang2 = xp.deg2rad(sign1 * a2)
    c2, s2 = xp.cos(ang2), xp.sin(ang2)
    return ((a1 + sign1 * a2) % 360.0, x1 * c2 - y1 * s2 + sign1 * x2,
            x1 * s2 + y1 * c2 + y2, (m1 + m2) % 2)


def inverse_transform2(alpha, sx, sy, mirror=0):
    """Invert a 2D align transform (SPHIRE ``inverse_transform2``): with
    ``T(p) = F^m (R(a) p + t)`` the inverse in the same form is
    ``mirror' = m``, ``alpha' = (-1)^(m+1) a``, ``t' = -F^m R(-a) t``.
    Numpy in gives numpy out; a tensor in gives tensors out."""
    xp, asarray, _ = _algebra(alpha, sx, sy)
    m, a, sxn, syn = (asarray(v) for v in (mirror, alpha, sx, sy))
    ang = xp.deg2rad(a)
    c, s = xp.cos(ang), xp.sin(ang)
    rx = c * sxn + s * syn       # R(-a) @ t
    ry = -s * sxn + c * syn
    return (xp.where(m == 1, a % 360.0, (-a) % 360.0),
            xp.where(m == 1, rx, -rx), -ry, m)


def params_table(params: AlignParams) -> np.ndarray:
    """(N, 4) float64 rows [alpha, sx, sy, mirror] in header convention,
    alpha wrapped into [0, 360); the fields are tensors or numpy arrays."""
    params = AlignParams(*[torch.as_tensor(f) for f in params])
    sx, sy = gpu_params_to_align2d(params.angle, params.shift_x,
                                   params.shift_y)
    return np.stack(
        [
            params.angle.cpu().numpy().astype(np.float64) % 360.0,
            sx.cpu().numpy().astype(np.float64),
            sy.cpu().numpy().astype(np.float64),
            params.mirror.cpu().numpy().astype(np.float64),
        ],
        axis=1,
    )


def pixel_error_2D(params1, params2, r: float):
    """Mean pixel displacement between two 2D transforms over a disk of
    radius ``r`` (SPHIRE ``pixel_error_2D``): ``sqrt(|r^2 (1 - cos d_alpha)
    + d_sx^2 + d_sy^2|)``.  ``params1``/``params2`` are (alpha, sx, sy)
    triples of arrays, tensors or scalars; returns a tensor (float64 for
    float64 or Python-float inputs)."""
    a1, sx1, sy1, a2, sx2, sy2 = [torch.as_tensor(v)
                                  for v in (*params1, *params2)]
    rot_term = (r * r) * (1.0 - torch.cos(torch.deg2rad(a1 - a2)))
    return torch.sqrt(torch.abs(rot_term + (sx1 - sx2) ** 2
                                + (sy1 - sy2) ** 2))
