"""The seeded particle stack of a cell, made on the device.

A frozen copy of the synthetic generator the repository's smoke runs
use (class templates with off-ring bumps; each particle a randomly
chosen template, turned, shifted by whole pixels up to 2 px, mirrored
at random, plus unit-sigma noise), in plain PyTorch: the warp is
``reference.transform``.  Particle ``i`` depends on the seed and on
``i`` alone: the draws are made by blocks of ``BLOCK`` global
particles, each from a generator seeded by (seed, block), so any range
of the stack (a rank's block) is made the same.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import transform

BLOCK = 4096
_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)


def templates(k: int, nx: int) -> np.ndarray:
    """(k, nx, nx) float32 class templates: 2+j gaussian bumps on a ring
    of the class's radius and two off-ring bumps, so that no pose is a
    symmetric tie; zero mean, unit sigma."""
    yy, xx = np.mgrid[0:nx, 0:nx]
    c = nx // 2
    out = np.zeros((k, nx, nx), np.float64)
    for j in range(k):
        r0 = nx * min(0.12 + j * 0.07, 0.30)
        img = np.zeros((nx, nx), np.float64)
        for b in range(2 + j):
            a = 2 * np.pi * b / (2 + j) + 0.5 * j
            img += np.exp(-((yy - c - r0 * np.sin(a)) ** 2
                            + (xx - c - r0 * np.cos(a)) ** 2) / (2 * 2.5 ** 2))
        img = (img - img.mean()) / img.std()
        for amp, r, a in ((2.0, 0.18 * nx, 0.7 + j),
                          (1.2, 0.08 * nx, 2.9 + 2 * j)):
            img += amp * np.exp(-((yy - c - r * np.sin(a)) ** 2
                                  + (xx - c - r * np.cos(a)) ** 2)
                                / (2 * 2.0 ** 2))
        out[j] = (img - img.mean()) / img.std()
    return out.astype(np.float32)


def block_seed(seed: int, block: int) -> int:
    """A 63-bit generator seed of (seed, block)."""
    x = (int(seed) * _MIX[0] + (int(block) + 1) * _MIX[1]) % 2 ** 64
    x ^= x >> 31
    return (x * _MIX[1]) % 2 ** 63


def stack(tmpl, seed: int, start: int, stop: int, device, max_shift: int = 2,
          noise: float = 1.0):
    """Particles ``start .. stop-1`` as an (stop-start, H, W) float32
    tensor on ``device``; ``tmpl`` the (K, H, W) templates there."""
    k, h, w = tmpl.shape
    out = torch.empty((stop - start, h, w), dtype=torch.float32,
                      device=device)
    for b in range(start // BLOCK, (stop - 1) // BLOCK + 1):
        g = torch.Generator(device=device)
        g.manual_seed(block_seed(seed, b))

        def draw(lo, hi):
            return torch.randint(lo, hi, (BLOCK,), generator=g,
                                 device=device)

        cls = draw(0, k)
        ang = torch.rand(BLOCK, generator=g, device=device) * 360.0
        sx = draw(-max_shift, max_shift + 1).float()
        sy = draw(-max_shift, max_shift + 1).float()
        mir = draw(0, 2)
        lo, hi = max(start, b * BLOCK), min(stop, (b + 1) * BLOCK)
        sl = slice(lo - b * BLOCK, hi - b * BLOCK)
        imgs = transform(tmpl[cls[sl]], ang[sl], sx[sl], sy[sl], mir[sl])
        eps = torch.randn((BLOCK, h, w), generator=g, device=device)[sl]
        out[lo - start:hi - start] = imgs + noise * eps
    return out


def sample(seed: int, n: int, count: int) -> np.ndarray:
    """``count`` distinct particle indices of ``n``, sorted, drawn from the
    seed: the particles whose answers the check compares."""
    rng = np.random.default_rng(block_seed(seed, -7))
    return np.sort(rng.choice(n, size=min(count, n), replace=False))
