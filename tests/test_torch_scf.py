"""SCF (self-correlation) alignment in the port (``ops/scf.py``,
``align_step_scf``, ``ali2d_base(random_method="SCF")``) against the JAX
package on the CPU, and against its numpy oracle as tests/test_scf.py
holds the JAX one.

Tolerances: the scf images within 1e-5 of their largest value
(torch.fft against matmul DFTs, both f32); mirrors and integer shifts
exactly equal, peaks within 1e-5 relative to the largest, angles within
2e-2 degree (measured: up to 1.05e-2 on these blob images, 1e-3 on the
asymmetric templates; the scf of a blob image has a broad angular peak,
whose 7-point parabolic fit amplifies the f32 rounding of the two
packages' transforms; the winning 0.7-degree bin is the same, or the
angle would be off by a bin); against the f64 oracle angles within 0.1
degree and peaks within 1e-3 relative, the JAX test's own bars.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import steps as jsteps
from cryo_ralib_tpu.ops import scf as jscf
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils import oracle
from cryo_ralib_tpu.utils.synthetic import blob_stack
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import steps
from cryo_ralib_tpu_torch.ops import scf
from cryo_ralib_tpu_torch.ops.transform import transform_batch
from cryo_ralib_tpu_torch.params import AlignParams

NX, N = 48, 8
GEOM = dict(img_dim=NX, ring_num=16, ring_len=256, shift_step=1.0,
            shift_rng_x=2.0, shift_rng_y=2.0, mode="H")


@pytest.fixture(scope="module")
def stack():
    return blob_stack(N, NX, blobs=3, seed=63).astype(np.float32)


def _assert_params_match(got, want):
    for f in ("mirror", "ref_id", "shift_x", "shift_y"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    d = np.abs(got.angle.numpy() - np.asarray(want.angle))
    assert np.minimum(d, 360.0 - d).max() < 2e-2


def test_scf_batch_matches_jax_and_oracle(stack):
    got = scf.scf_batch(torch.as_tensor(stack)).numpy()
    want = np.asarray(jscf.scf_batch(jnp.asarray(stack)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for i in range(N):
        ref = oracle.scf_np(stack[i].astype(np.float64))
        np.testing.assert_allclose(got[i], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        assert np.unravel_index(got[i].argmax(), got[i].shape) == (NX // 2,
                                                                   NX // 2)


@pytest.mark.parametrize("xr,yr", [(2.0, 2.0), (1.0, 3.0), (0.0, 0.0)])
def test_scf_align_matches_jax(stack, xr, yr):
    geom = dict(GEOM, shift_rng_x=xr, shift_rng_y=yr)
    ref = stack.mean(0)
    want, want_peak = jscf.scf_align(jnp.asarray(stack), jnp.asarray(ref),
                                     JaxConfig(**geom))
    got, peak = scf.scf_align(torch.as_tensor(stack), torch.as_tensor(ref),
                              AlignConfig(**geom))
    _assert_params_match(got, want)
    np.testing.assert_allclose(peak.numpy(), np.asarray(want_peak), rtol=0,
                               atol=1e-5 * np.abs(want_peak).max())


def test_scf_align_matches_oracle(stack):
    cfg = AlignConfig(**GEOM)
    ref = stack.mean(0)
    got, peak = scf.scf_align(torch.as_tensor(stack), torch.as_tensor(ref),
                              cfg)
    for i in range(N):
        want = oracle.align_particle_scf_np(
            stack[i].astype(np.float64), ref.astype(np.float64),
            cfg.polar_coords, cfg.ring_weights, int(cfg.shift_rng_x),
            int(cfg.shift_rng_y), cfg.shift_limit)
        assert int(got.mirror[i]) == want["mirror"], i
        assert float(got.shift_x[i]) == want["shift_x"], i
        assert float(got.shift_y[i]) == want["shift_y"], i
        da = abs(float(got.angle[i]) - want["angle"]) % 360.0
        assert min(da, 360.0 - da) < 0.1, i
        assert abs(float(peak[i]) - want["peak"]) < 1e-3 * abs(want["peak"])


@pytest.mark.parametrize("m", [0, 1])
def test_scf_recovers_known_transform(m):
    """A rotated, shifted (and mirrored) copy of the reference aligns
    back with the right mirror flag (tests/test_scf.py's gate)."""
    base = blob_stack(1, NX, blobs=3, seed=7)[0].astype(np.float32)
    img = oracle.transform_np(base.astype(np.float64), 57.0, 1.0, -2.0,
                              m).astype(np.float32)
    params, _ = scf.scf_align(torch.as_tensor(img[None]),
                              torch.as_tensor(base), AlignConfig(**GEOM))
    assert int(params.mirror[0]) == m
    aligned = transform_batch(torch.as_tensor(img[None]), params)[0].numpy()
    c = slice(6, -6)
    r = np.corrcoef(aligned[c, c].ravel(), base[c, c].ravel())[0, 1]
    assert r > 0.9, (r, params)


def test_scf_requires_half_rings(stack):
    with pytest.raises(ValueError, match="mode='H'"):
        scf.scf_align(torch.as_tensor(stack), torch.as_tensor(stack[0]),
                      AlignConfig(**dict(GEOM, mode="F")))


@pytest.mark.parametrize("with_valid", [False, True])
def test_align_step_scf_matches_jax(stack, with_valid):
    """SCF aligns absolutely: the previous params (non-zero here) are not
    composed in."""
    jcfg, cfg = JaxConfig(**GEOM), AlignConfig(**GEOM)
    ref = stack.mean(0)[None]
    gidx = np.arange(N, dtype=np.int32)
    valid = ((np.arange(N) < N - 2).astype(np.float32) if with_valid
             else None)
    one = np.ones(N, np.float32)
    jp = JaxParams(jnp.asarray(30 * one), jnp.asarray(one), jnp.asarray(-one),
                   jnp.ones(N, jnp.int32), jnp.zeros(N, jnp.int32))
    tp = AlignParams(*[torch.as_tensor(np.array(f)) for f in jp])
    want = jsteps.align_step_scf(
        jnp.asarray(stack), jnp.asarray(ref), jp, jnp.asarray(gidx),
        None if valid is None else jnp.asarray(valid), jcfg, n_classes=1,
        sampler="gather")
    got = steps.align_step_scf(
        torch.as_tensor(stack), torch.as_tensor(ref), tp,
        torch.as_tensor(gidx),
        None if valid is None else torch.as_tensor(valid), cfg, n_classes=1)
    _assert_params_match(got.params, want.params)
    sums = np.asarray(want.class_sums)
    # an angle off by up to 1e-2 degree moves a pixel at radius 24 by
    # 4e-3 px: the class sums agree to 1e-3 of their largest value
    # (measured 2.1e-4)
    np.testing.assert_allclose(got.class_sums.numpy(), sums, rtol=0,
                               atol=1e-3 * np.abs(sums).max())
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.peak.numpy(), np.asarray(want.peak),
                               rtol=0, atol=1e-5 * np.abs(want.peak).max())
    np.testing.assert_allclose(float(got.sx_sum), float(want.sx_sum),
                               atol=1e-2)


def test_scf_search_result_shape(stack):
    params, peak = scf.scf_align(torch.as_tensor(stack),
                                 torch.as_tensor(stack[0]),
                                 AlignConfig(**GEOM))
    res = scf.scf_search_result(params, peak, 256)
    assert res.best_row.shape == (N, 256) and res.best_val is peak
    assert torch.equal(res.best_mirror, params.mirror)
