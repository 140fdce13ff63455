"""The search kernel's cheaper sample positions (csrc/search.cu,
``floor_index`` and ``ring_inside``), modelled in numpy float32.

The kernel places a sample at ``x = f32(bx + f32(cos * radius))`` with
``bx = f32(cx + f32(acc_x + grid_x))``.  It skips the clamp of a ring
pair where ``ring_inside`` holds for both rings: ``f32(bx - r) >= 0``
and ``f32(bx + r) <= w - 2`` (and the same in y), ``r = f32(radius)``.
These tests show, on the benchmark's geometry, 160 and 256 px boxes,
modes F and H, and accumulated shifts up to the edge and past it, that
every sample of a ring the rule calls inside lands in [0, w-2] x
[0, h-2], where clamp-to-edge changes no bit; and that the floor as a
round-down add of 2^23 equals ``floorf`` on every float32 in [0, 255].
"""

import numpy as np
import pytest

from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops import fused_search as fs

F32 = np.float32
BIAS = 8388608.0          # 2^23
BIAS_BITS = 0x4B000000    # its float32 bits

# (img_dim, ring_num, xr, mode): the rib80s cells, 160 px, 256 px
GEOMETRIES = [(90, 36, 3.0, "F"), (90, 36, 3.0, "H"), (160, 48, 2.0, "F"),
              (160, 48, 2.0, "H"), (256, 100, 1.0, "F"), (256, 100, 1.0, "H")]


def ring_inside(bx, by, radii, h, w):
    """csrc/search.cu::ring_inside in float32: (..., R) bool."""
    return _axis_inside(bx, radii, w) & _axis_inside(by, radii, h)


def _axis_inside(b, radii, size):
    """One axis of ring_inside: f32(b - r) >= 0 and f32(b + r) <= size-2."""
    r = radii.astype(F32)
    return (b - r >= F32(0)) & (b + r <= F32(size - 2))


def _accumulated(radius, grid, size, rng):
    """Accumulated shifts that put a ring's extreme sample at, next to
    and across the edges: where centre + acc + s +- r meets 0 or
    size - 2 for each grid shift s, a few float32 steps either way; and
    random shifts across the whole box."""
    c = F32(size // 2)
    edge = []
    for s in grid:
        for target in (radius, F32(size - 2) - radius):
            a = F32(target - c - s)
            for _ in range(3):
                a = np.nextafter(a, F32(-np.inf))
            for _ in range(7):
                edge.append(a)
                a = np.nextafter(a, F32(np.inf))
    span = F32(size / 2)
    return np.concatenate([np.array(edge, F32),
                           rng.uniform(-span, span, 64).astype(F32)])


@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
def test_rings_called_inside_need_no_clamp(geom):
    """The rule is a test per axis, so each axis is held on its own: for
    every ring, at every grid shift and at accumulated shifts across the
    edges, a base position the rule passes keeps all 256 samples in
    [0, size - 2], where the clamp is the identity (the same x, the same
    indices)."""
    nx, rings, xr, mode = geom
    cfg = AlignConfig(img_dim=nx, ring_num=rings, shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr, mode=mode)
    cs, radii = fs.polar_tables(cfg)
    c = F32(nx // 2)
    rng = np.random.default_rng(nx + rings)
    passed = tested = 0
    for axis in (0, 1):
        # the kernel's offsets, bitwise polar_coords (test_torch_fft_plan)
        off = (cs[None, :, axis] * radii[:, None]).astype(F32)   # (R, L)
        assert not np.signbit(off[off == 0]).any()    # no -0 offset
        grid = np.unique(cfg.shifts[:, axis].astype(F32))
        for ri, radius in enumerate(radii.astype(F32)):
            acc = _accumulated(radius, grid, nx, rng)
            b = (c + (acc[:, None] + grid[None, :])).reshape(-1)  # f32
            inside = _axis_inside(b, radii[ri], nx)
            x = b[:, None] + off[ri][None, :]
            assert x.dtype == F32
            ok = ((x >= 0) & (x <= nx - 2)).all(axis=1)
            assert not (inside & ~ok).any(), (axis, ri)
            xi = x[inside]
            assert np.array_equal(np.clip(xi, F32(0), F32(nx - 1)), xi)
            assert (np.floor(xi) + 1 <= nx - 1).all()
            passed += int(inside.sum())
            tested += inside.size
    # both paths occur
    assert 0 < passed < tested


@pytest.mark.parametrize("geom", GEOMETRIES[:2], ids=str)
def test_benchmark_rings_are_all_inside(geom):
    """The rib80s jobs (90 px, rings up to 36, grid +-3) with accumulated
    shifts up to 2 px: every ring pair takes the unclamped path."""
    nx, rings, xr, mode = geom
    cfg = AlignConfig(img_dim=nx, ring_num=rings, shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr, mode=mode)
    acc = np.linspace(-2, 2, 41).astype(F32)
    grid = cfg.shifts.astype(F32)
    c = F32(nx // 2)
    bx = (c + (acc[:, None] + grid[None, :, 0]))[..., None]
    by = (c + (acc[::-1, None] + grid[None, :, 1]))[..., None]
    assert ring_inside(bx, by, cfg.radii[None, None, :], nx, nx).all()


def _round_down_floor(x):
    """floor_index in numpy: t = x + 2^23 rounded down, as float32; then
    the integer from its bits and the float floor.  The float64 sum is
    exact or within 2^-30 of it, never across an integer for a float32
    x in [0, 2^22), so its floor is the round-down float32 sum (the
    float32 values in [2^23, 2^24) are the integers)."""
    t = np.floor(x.astype(np.float64) + BIAS).astype(F32)
    return t.view(np.int32) - BIAS_BITS, t - F32(BIAS)


def test_round_down_floor_equals_floorf():
    """Every float32 in [1, 256), and [0, 1) at its ends (the round-down
    sum is monotonic in x, so it is 2^23 across [0, 1) if at both ends)
    and on a stride of its values: the integer, the float floor and the
    fraction x - floor equal floorf's, bit for bit."""
    lo, hi = F32(1).view(np.int32), F32(256).view(np.int32)
    below_one = np.concatenate([
        np.arange(0, F32(1).view(np.int32), 4099, dtype=np.int32),
        np.array([0, 1, F32(1).view(np.int32) - 1], np.int32)])
    chunks = [below_one] + [np.arange(a, min(a + (1 << 22), hi),
                                      dtype=np.int32)
                            for a in range(lo, hi, 1 << 22)]
    for bits in chunks:
        x = bits.view(F32)
        i, x0 = _round_down_floor(x)
        want = np.floor(x)
        assert np.array_equal(i, want.astype(np.int32))
        assert np.array_equal(x0.view(np.int32), want.view(np.int32))
        assert np.array_equal((x - x0).view(np.int32),
                              (x - want).view(np.int32))
