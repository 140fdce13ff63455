"""Pose (Euler angle / translation) parsing and rotation conventions (a
copy of ``cryo_ralib_tpu/analysis/poses.py``).

Port of the reference's pose helpers (src/utils_ralib.py:210-291):
EMAN and RELION ZXZ'/ZYZ' Euler-to-matrix conversions including the
image-origin sign flips, and the table parsers feeding the EDA
notebooks.  Vectorized over N (the reference loops in Python).
"""

from __future__ import annotations

import numpy as np


def _flip_origin(R):
    """EMAN image-origin convention fix (bottom-left vs top-left): negate
    the xy/yx/yz/zy entries (src/utils_ralib.py:247-251)."""
    R = R.copy()
    R[..., 0, 1] *= -1
    R[..., 1, 0] *= -1
    R[..., 1, 2] *= -1
    R[..., 2, 1] *= -1
    return R


def R_from_eman(a, b, y):
    """EMAN az/alt/phi (ZXZ') Euler triplet(s) -> rotation matrix/matrices.

    Accepts scalars or (N,) arrays; returns (3,3) or (N,3,3).
    Matches src/utils_ralib.py:235-251 (Ry @ Rb @ Ra with the x-axis tilt).
    """
    a, b, y = (np.deg2rad(np.asarray(v, np.float64)) for v in (a, b, y))
    scalar = a.ndim == 0
    a, b, y = np.atleast_1d(a, b, y)
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cy, sy = np.cos(y), np.sin(y)
    z = np.zeros_like(a)
    o = np.ones_like(a)
    Ra = np.stack([ca, -sa, z, sa, ca, z, z, z, o], -1).reshape(-1, 3, 3)
    Rb = np.stack([o, z, z, z, cb, -sb, z, sb, cb], -1).reshape(-1, 3, 3)
    Ry = np.stack([cy, -sy, z, sy, cy, z, z, z, o], -1).reshape(-1, 3, 3)
    R = _flip_origin(Ry @ Rb @ Ra)
    return R[0] if scalar else R


def R_from_relion(a, b, y):
    """RELION rot/tilt/psi (ZYZ') Euler triplet(s) -> rotation matrices
    (src/utils_ralib.py:275-291; the tilt is about the y axis)."""
    a, b, y = (np.deg2rad(np.asarray(v, np.float64)) for v in (a, b, y))
    scalar = a.ndim == 0
    a, b, y = np.atleast_1d(a, b, y)
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cy, sy = np.cos(y), np.sin(y)
    z = np.zeros_like(a)
    o = np.ones_like(a)
    Ra = np.stack([ca, -sa, z, sa, ca, z, z, z, o], -1).reshape(-1, 3, 3)
    Rb = np.stack([cb, z, -sb, z, o, z, sb, z, cb], -1).reshape(-1, 3, 3)
    Ry = np.stack([cy, -sy, z, sy, cy, z, z, z, o], -1).reshape(-1, 3, 3)
    R = _flip_origin(Ry @ Rb @ Ra)
    return R[0] if scalar else R


def parse_pose_hdf(df):
    """2D params table -> (euler, trans, rot, classes)
    (src/utils_ralib.py:210-233): only psi is set, rot/tilt are zero."""
    n = len(df)
    euler = np.zeros((n, 3))
    euler[:, 2] = np.asarray(df["angle_psi"], np.float64)
    rot = R_from_eman(euler[:, 0], euler[:, 1], euler[:, 2])
    trans = np.stack([np.asarray(df["shift_x"], np.float64),
                      np.asarray(df["shift_y"], np.float64)], 1)
    classes = df["class"]
    return euler, trans, rot, classes


def parse_pose_star(df):
    """STAR table -> (euler, trans, rot) (src/utils_ralib.py:253-273)."""
    euler = np.stack([np.asarray(df["_rlnAngleRot"], np.float64),
                      np.asarray(df["_rlnAngleTilt"], np.float64),
                      np.asarray(df["_rlnAnglePsi"], np.float64)], 1)
    rot = R_from_relion(euler[:, 0], euler[:, 1], euler[:, 2])
    trans = np.stack([np.asarray(df["_rlnOriginX"], np.float64),
                      np.asarray(df["_rlnOriginY"], np.float64)], 1)
    return euler, trans, rot
