"""Synthetic particle stacks for tests, smoke runs and demos.

``random_stack``, ``class_templates``, ``asymmetric_templates`` and
``blob_stack`` are copies of ``cryo_ralib_tpu/utils/synthetic.py``'s
(numpy);
``unit_sigma_blobs`` normalises ``blob_stack`` templates.  ``scattered_stack`` is
this package's own generator: numpy-seeded classes, angles, shifts,
mirrors and noise, applied to the templates with the port's
``transform_batch`` on any device (the JAX package's version goes
through its quadri ``rot_shift2d`` instead).
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import AlignParams
from ..ops.transform import transform_batch


def random_stack(n: int, nx: int, seed: int = 0) -> np.ndarray:
    """Uniform-noise stack (the C harnesses' ImageStack)."""
    rng = np.random.default_rng(seed)
    return rng.random((n, nx, nx), np.float32)


def class_templates(n_classes: int, nx: int) -> np.ndarray:
    """Well-separated rotationally-informative class templates: class k
    carries 2+k gaussian bumps on a ring of distinct radius, unit-sigma
    normalized."""
    yy, xx = np.mgrid[0:nx, 0:nx]
    cy = cx = nx // 2
    out = np.zeros((n_classes, nx, nx), np.float32)
    for k in range(n_classes):
        # cap the ring radius so features stay inside typical alignment
        # masks (ou ~ 0.4 nx) even for many classes
        r0 = nx * min(0.12 + k * 0.07, 0.30)
        img = np.zeros((nx, nx), np.float64)
        n_bumps = 2 + k
        for b in range(n_bumps):
            ang = 2 * np.pi * b / n_bumps + 0.5 * k
            by = cy + r0 * np.sin(ang)
            bx = cx + r0 * np.cos(ang)
            img += np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * 2.5 ** 2))
        img -= img.mean()
        img /= img.std()
        out[k] = img.astype(np.float32)
    return out


def asymmetric_templates(n_classes: int, nx: int) -> np.ndarray:
    """`class_templates` plus two distinct off-ring bumps per class, so
    that no pose is a symmetric tie (class_templates are dihedral)."""
    base = class_templates(n_classes, nx).astype(np.float64)
    yy, xx = np.mgrid[0:nx, 0:nx]
    cy = cx = nx // 2
    for i in range(n_classes):
        for amp, r, ang in ((2.0, 0.18 * nx, 0.7 + i),
                            (1.2, 0.08 * nx, 2.9 + 2 * i)):
            by, bx = cy + r * np.sin(ang), cx + r * np.cos(ang)
            base[i] += amp * np.exp(-((yy - by) ** 2 + (xx - bx) ** 2)
                                    / (2 * 2.0 ** 2))
        base[i] -= base[i].mean()
        base[i] /= base[i].std()
    return base.astype(np.float32)


def blob_stack(n: int, nx: int, blobs: int = 3, noise: float = 0.05,
               seed: int = 0) -> np.ndarray:
    """Particle-like images: gaussian blobs in a disc plus noise.  With
    a few blobs and no noise, many distinct templates (asymmetric_templates
    repeat themselves, rotated, beyond ~40 classes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:nx, 0:nx]
    imgs = np.zeros((n, nx, nx), np.float32)
    for i in range(n):
        img = np.zeros((nx, nx), np.float64)
        for _ in range(blobs):
            cy = rng.uniform(nx * 0.3, nx * 0.7)
            cx = rng.uniform(nx * 0.3, nx * 0.7)
            s = rng.uniform(1.5, 4.0)
            img += rng.uniform(0.5, 2.0) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        img += rng.normal(0, noise, (nx, nx))
        imgs[i] = img.astype(np.float32)
    return imgs


def unit_sigma_blobs(k: int, nx: int, seed: int = 64) -> np.ndarray:
    """k distinct templates for large-K runs: ``blob_stack`` with six
    blobs and no noise, each normalised to zero mean and unit sigma."""
    tmpl = blob_stack(k, nx, blobs=6, noise=0.0, seed=seed)
    return ((tmpl - tmpl.mean((1, 2), keepdims=True))
            / tmpl.std((1, 2), keepdims=True))


def scattered_stack(templates: np.ndarray, n: int, max_shift: int = 2,
                    noise: float = 0.02, seed: int = 0, device="cpu",
                    mirror: bool = True):
    """Transformed, noisy copies of randomly chosen templates.

    Returns ``(images, class_ids, angles, shifts, mirrors)``: images an
    (n, H, W) float32 tensor on ``device``; the rest numpy ground truth
    (class ids, angles in degrees, (n, 2) integer shifts, 0/1 mirrors).
    ``mirror=False`` makes a stack with no mirrored copies (all mirrors
    0; the other draws are those of ``mirror=True``), for ``--nomirror``.
    """
    rng = np.random.default_rng(seed)
    k = templates.shape[0]
    cls = rng.integers(0, k, n)
    angs = rng.uniform(0, 360, n).astype(np.float32)
    sxs = rng.integers(-max_shift, max_shift + 1, n).astype(np.float32)
    sys_ = rng.integers(-max_shift, max_shift + 1, n).astype(np.float32)
    mirrors = rng.integers(0, 2, n).astype(np.int32) * int(mirror)
    noise_img = rng.standard_normal((n,) + templates.shape[1:],
                                    dtype=np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    params = AlignParams(dev(angs), dev(sxs), dev(sys_), dev(mirrors),
                         dev(cls.astype(np.int32)))
    imgs = transform_batch(dev(templates.astype(np.float32))[dev(cls)],
                           params)
    imgs += noise * dev(noise_img)
    return imgs, cls, angs, np.stack([sxs, sys_], 1), mirrors
