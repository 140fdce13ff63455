"""The port's batch op ``rot_shift2d`` and its interpolator
``quadri_sample`` against the JAX package's ``engine="quadri"`` path and
the numpy oracle, on the CPU.

Tolerance against JAX: 1e-4 absolute on unit-sigma noise images.  Both
keep the same expression order; the port takes cos and sin of the f32
radians in f64 (correctly rounded, so the card and the CPU agree) where
XLA rounds its own f32 cos, and an ulp there can move a coordinate that
lies within ~1e-6 of an integer into the next cell.  Measured on these
cases: at most 5.6e-5 at 90 px, 3.7e-5 at 48 px, 1.7e-5 at 32/33 px,
with 98-100% of pixels bitwise equal.  Against the f64 oracle 2e-4, as
tests/test_ops.py holds the JAX op.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu.ops.interp import quadri_sample as jax_quadri
from cryo_ralib_tpu.ops.transform import rot_shift2d as jax_rot_shift2d
from cryo_ralib_tpu_torch.ops import transform
from cryo_ralib_tpu_torch.ops.interp import quadri_sample
from cryo_ralib_tpu_torch.ops.transform import rot_shift2d
from cryo_ralib_tpu_torch.utils import oracle

ATOL = 1e-4


def _case(nx, n=48, seed=0):
    """Unit-sigma noise images; the boundary angles (0, 90, 180, 270,
    720, -90) and the restrict2 shifts (+-h, h+0.5, 2h) first, then
    random ones; mirror flags and scales (0 among them) drawn."""
    rng = np.random.default_rng(seed + nx)
    imgs = rng.standard_normal((n, nx, nx)).astype(np.float32)
    edge_ang = np.array([0, 90, 180, 270, 720, -90, 45.5, 359.9])
    ang = np.concatenate([edge_ang, rng.uniform(-400, 400, n - 8)])
    edge_sh = np.array([nx, -nx, nx + 0.5, -nx - 0.5, 2 * nx, -2 * nx, 0,
                        1.25])
    sx = np.concatenate([edge_sh, rng.uniform(-5, 5, n - 8)])
    sy = np.roll(sx, 3)
    mirror = rng.integers(0, 2, n).astype(np.int32)
    scale = rng.uniform(0.8, 1.2, n).astype(np.float32)
    scale[:4] = 0.0
    return (imgs, ang.astype(np.float32), sx.astype(np.float32),
            sy.astype(np.float32), mirror, scale)


@pytest.mark.parametrize("nx", [32, 33, 48, 90])
@pytest.mark.parametrize("extra", ["plain", "mirror", "mirror_scale"])
def test_rot_shift2d_matches_jax_quadri(nx, extra):
    imgs, ang, sx, sy, mirror, scale = _case(nx)
    kw = {"plain": {}, "mirror": {"mirror": mirror},
          "mirror_scale": {"mirror": mirror, "scale": scale}}[extra]
    want = np.asarray(jax_rot_shift2d(
        jnp.asarray(imgs), jnp.asarray(ang), jnp.asarray(sx),
        jnp.asarray(sy), engine="quadri",
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = rot_shift2d(torch.as_tensor(imgs), ang, sx, sy, **kw).numpy()
    assert got.dtype == np.float32 and got.shape == imgs.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fallback", [False, True])
def test_quadri_sample_matches_jax(fallback):
    """Points in and out of range (out of range falls back to the target
    pixel, or to the rounded point), neighbours wrapping at the edges."""
    rng = np.random.default_rng(3)
    n, nx, m = 6, 20, 200
    imgs = rng.standard_normal((n, nx, nx)).astype(np.float32)
    y = rng.uniform(-3, nx + 3, (n, m)).astype(np.float32)
    x = rng.uniform(-3, nx + 3, (n, m)).astype(np.float32)
    y[:, :4] = [0.0, nx - 1.0, nx - 0.5, -0.5]   # edges and just outside
    x[:, :4] = [nx - 1.0, 0.0, -0.5, nx - 0.5]
    kw = {}
    if fallback:
        kw = {"fallback_y": rng.integers(0, nx, (n, m)).astype(np.float32),
              "fallback_x": rng.integers(0, nx, (n, m)).astype(np.float32)}
    want = np.asarray(jax_quadri(jnp.asarray(imgs), jnp.asarray(y),
                                 jnp.asarray(x),
                                 **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = quadri_sample(torch.as_tensor(imgs), torch.as_tensor(y),
                        torch.as_tensor(x),
                        **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_rot_shift2d_matches_oracle():
    """The port's op against the port's copy of the numpy oracle (f64
    loops), as tests/test_ops.py holds the JAX op: 2e-4."""
    rng = np.random.default_rng(7)
    imgs = rng.standard_normal((4, 40, 40)).astype(np.float32)
    angs = [17.0, 290.0, 45.5, 123.0]
    dxs = [1.25, -3.0, 0.0, 40.5]
    dys = [-0.5, 2.0, 4.75, -41.0]
    mirrors = [0, 1, 1, 0]
    got = rot_shift2d(torch.as_tensor(imgs), angs, dxs, dys,
                      mirror=mirrors).numpy()
    for i in range(4):
        want = oracle.rot_shift2d_np(imgs[i].astype(np.float64), angs[i],
                                     dxs[i], dys[i])
        if mirrors[i]:
            want = oracle.mirror_flip_np(want)
        np.testing.assert_allclose(got[i], want, atol=2e-4)


def test_rot_shift2d_by_blocks_equals_one_call(monkeypatch):
    """A stack larger than a block runs by blocks, with the one call's
    result bitwise."""
    imgs, ang, sx, sy, mirror, scale = _case(33, n=23, seed=5)
    args = [torch.as_tensor(v) for v in (imgs, ang, sx, sy)]
    whole = transform._rot_shift2d(*args, torch.as_tensor(mirror),
                                   torch.as_tensor(scale))
    monkeypatch.setattr(transform, "transform_block", lambda h, w: 4)
    blocked = rot_shift2d(*args, mirror=mirror, scale=scale)
    assert torch.equal(blocked, whole)


def test_rot_shift2d_identity_and_engines():
    """Zero angle and shift return the image: exactly under "quadri",
    within 1e-5 under "shear" (an f32 FFT round trip; the engine is held
    to JAX's in tests/test_torch_shear.py); "shear" with a scale and an
    unknown engine raise naming it."""
    img = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 16, 16)).astype(np.float32))
    zero = torch.zeros(2)
    assert torch.equal(rot_shift2d(img, zero, zero, zero, engine="quadri"),
                       img)
    torch.testing.assert_close(
        rot_shift2d(img, zero, zero, zero, engine="shear"), img, rtol=0,
        atol=1e-5)
    with pytest.raises(ValueError, match="scale"):
        rot_shift2d(img, zero, zero, zero, scale=torch.ones(2),
                    engine="shear")
    with pytest.raises(ValueError, match="engine"):
        rot_shift2d(img, zero, zero, zero, engine="fft")


def _restrict2_loop(x, n):
    """EMAN2's ``restrict2`` as the notebook kernel writes it."""
    while x >= n:
        x -= n
    while x <= -n:
        x += n
    return x


def test_restrict2_wraps_like_eman2():
    """``torch.remainder`` (not ``fmod``): x >= n lands in [0, n), x <= -n
    in (-n, 0], the rest untouched, equal to EMAN2's loop in f32 on these
    values; the JAX package's ``jnp.mod`` is within 2e-6 of it (XLA's
    float remainder rounds: 271.25 mod 90 = 1.2499985)."""
    from cryo_ralib_tpu.ops.transform import _restrict2 as jax_restrict2

    v = np.array([0.0, 89.9, 90.0, 90.5, 180.0, 271.25, -90.0, -90.5,
                  -180.0, -271.25, -89.0, 3.5], np.float32)
    got = transform._restrict2(torch.as_tensor(v), 90).numpy()
    want = [_restrict2_loop(np.float32(x), np.float32(90)) for x in v]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(got[:6], np.float32([0, 89.9, 0, 0.5, 0, 1.25]))
    np.testing.assert_array_equal(got[6:10], [0.0, -0.5, 0.0, -1.25])
    np.testing.assert_allclose(got, np.asarray(jax_restrict2(
        jnp.asarray(v), 90)), rtol=0, atol=2e-6)
