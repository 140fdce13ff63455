"""The PyTorch port's ops against their JAX counterparts on the CPU.

Tolerance: atol/rtol 1e-5 (scaled by the data's magnitude where it is
large).  The port's DFTs are f32 FFTs, the JAX package's are f32 matmul
DFTs at HIGHEST precision; the two agree to ~7e-7 relative on a
36 x 256 ring block."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu.ops import ccf as jccf
from cryo_ralib_tpu.ops import classavg as jclassavg
from cryo_ralib_tpu.ops import filters as jfilters
from cryo_ralib_tpu.ops import interp as jinterp
from cryo_ralib_tpu.ops import masks as jmasks
from cryo_ralib_tpu.ops import polar as jpolar
from cryo_ralib_tpu.ops import transform as jtransform
from cryo_ralib_tpu import params as jparams
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops import ccf, classavg, filters, interp, masks
from cryo_ralib_tpu_torch.ops import polar, transform
from cryo_ralib_tpu_torch import params as tparams

def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, scale=1.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.fixture()
def stack():
    rng = np.random.default_rng(11)
    return rng.standard_normal((4, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("span", ["inside", "out_of_range"])
def test_bilinear_sample(stack, span):
    rng = np.random.default_rng(1)
    lo, hi = (0.0, 31.0) if span == "inside" else (-3.0, 34.5)
    y = rng.uniform(lo, hi, (4, 200)).astype(np.float32)
    x = rng.uniform(lo, hi, (4, 200)).astype(np.float32)
    x[:, :4] = [0.0, 31.0, 30.5, 7.0]   # edges and an integer
    _close(interp.bilinear_sample(_t(stack), _t(y), _t(x)),
           jinterp.bilinear_sample(jnp.asarray(stack), jnp.asarray(y),
                                   jnp.asarray(x)))


@pytest.mark.parametrize("shift_shape", ["none", "per_particle", "multi"])
def test_polar_resample(stack, shift_shape):
    cfg = AlignConfig(img_dim=32, ring_num=12, shift_rng_x=2.0,
                      shift_rng_y=2.0)
    rng = np.random.default_rng(2)
    shape = {"none": None, "per_particle": (4,), "multi": (4, 3)}[shift_shape]
    if shape is None:
        sx = sy = None
    else:
        # fractional shifts, some beyond the image edge
        sx = rng.uniform(-20, 20, shape).astype(np.float32)
        sy = rng.uniform(-2.5, 2.5, shape).astype(np.float32)
    coords = cfg.polar_coords
    got = polar.polar_resample(_t(stack), _t(coords),
                               None if sx is None else _t(sx),
                               None if sy is None else _t(sy))
    want = jpolar.polar_resample(jnp.asarray(stack), jnp.asarray(coords),
                                 None if sx is None else jnp.asarray(sx),
                                 None if sy is None else jnp.asarray(sy))
    _close(got, want)


def test_ring_spectra_and_ccf_rows():
    rng = np.random.default_rng(3)
    polar_blk = rng.standard_normal((2, 3, 36, 256)).astype(np.float32)
    ref_f = jccf.ring_spectra(jnp.asarray(
        rng.standard_normal((4, 36, 256)).astype(np.float32)))
    weights = np.arange(1, 37, dtype=np.float32)
    ref_fw_j = jccf.weight_ring_spectra(ref_f, jnp.asarray(weights))
    ref_fw_t = ccf.weight_ring_spectra(_t(ref_f), _t(weights))
    scale = float(np.abs(np.asarray(ref_fw_j)).max())
    _close(torch.view_as_real(ref_fw_t),
           np.stack([np.real(ref_fw_j), np.imag(ref_fw_j)], -1), scale)

    sbj_j = jccf.ring_spectra(jnp.asarray(polar_blk))
    sbj_t = ccf.ring_spectra(_t(polar_blk))
    scale = float(np.abs(np.asarray(sbj_j)).max())
    _close(torch.view_as_real(sbj_t),
           np.stack([np.real(sbj_j), np.imag(sbj_j)], -1), scale)

    orig_j, mirr_j = jccf.ccf_spectra(sbj_j, ref_fw_j)
    orig_t, mirr_t = ccf.ccf_spectra(sbj_t, ref_fw_t)
    rows_j = np.asarray(jccf.ccf_rows(orig_j, mirr_j, 256))
    rows_t = ccf.ccf_rows(orig_t, mirr_t, 256)
    assert rows_t.shape == rows_j.shape == (2, 2, 3, 4, 256)
    _close(rows_t, rows_j, float(np.abs(rows_j).max()))
    rows1 = ccf.ccf_rows(orig_t, None, 256)
    assert rows1.shape == (2, 1, 3, 4, 256)
    _close(rows1[:, 0], rows_j[:, 0], float(np.abs(rows_j).max()))


@pytest.mark.parametrize("mirror", [0, 1])
def test_transform_batch(stack, mirror):
    rng = np.random.default_rng(4)
    n = stack.shape[0]
    angle = rng.uniform(0, 360, n).astype(np.float32)
    sx = rng.uniform(-3, 3, n).astype(np.float32)
    sy = np.array([0.0, 1.0, -2.5, 0.25], np.float32)
    mir = np.full(n, mirror, np.int32)
    zeros = np.zeros(n, np.int32)
    got = transform.transform_batch(
        _t(stack), tparams.AlignParams(_t(angle), _t(sx), _t(sy), _t(mir),
                                       _t(zeros)))
    want = jtransform.transform_batch(
        jnp.asarray(stack), jparams.AlignParams(
            jnp.asarray(angle), jnp.asarray(sx), jnp.asarray(sy),
            jnp.asarray(mir), jnp.asarray(zeros)))
    _close(got, want, float(np.abs(stack).max()))


@pytest.mark.parametrize("with_valid", [False, True])
def test_class_sum_oe(with_valid):
    rng = np.random.default_rng(6)
    n, k = 9, 3
    imgs = rng.standard_normal((n, 16, 16)).astype(np.float32)
    ref_id = rng.integers(0, k, n).astype(np.int32)
    gidx = (2 * np.arange(n) + 7).astype(np.int32)   # odd global indices
    gidx[::3] += 1
    valid = (np.arange(n) < 7).astype(np.float32) if with_valid else None
    got_s, got_c = classavg.class_sum_oe(
        _t(imgs), _t(ref_id), k, global_index=_t(gidx),
        valid=None if valid is None else _t(valid))
    want_s, want_c = jclassavg.class_sum_oe(
        jnp.asarray(imgs), jnp.asarray(ref_id), k,
        global_index=jnp.asarray(gidx),
        valid=None if valid is None else jnp.asarray(valid))
    _close(got_s, want_s, float(np.abs(imgs).sum(0).max()))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c.dtype == torch.int32


@pytest.mark.parametrize("no_sigma", [False, True])
def test_normalize_mask(stack, no_sigma):
    mask = masks.model_circle(12, 32)
    np.testing.assert_array_equal(mask, jmasks.model_circle(12, 32))
    got = masks.normalize_mask(_t(stack * 3.0 + 1.5), _t(mask),
                               no_sigma=no_sigma)
    want = jmasks.normalize_mask(jnp.asarray(stack * 3.0 + 1.5),
                                 jnp.asarray(mask), no_sigma=no_sigma)
    _close(got, want, 10.0)


@pytest.mark.parametrize("cutoff,falloff", [(0.2, 0.1), (0.35, 0.05),
                                            (0.0, 0.1)])
def test_filt_tanl(stack, cutoff, falloff):
    np.testing.assert_array_equal(filters._freq_grid(32, 32),
                                  jfilters._freq_grid(32, 32))
    got = filters.filt_tanl(_t(stack), cutoff, falloff)
    want = jfilters.filt_tanl(jnp.asarray(stack), cutoff, falloff)
    _close(got, want, float(np.abs(stack).max()))


def test_params_table_and_round_trip():
    rng = np.random.default_rng(8)
    n = 6
    jp = jparams.AlignParams(
        jnp.asarray(rng.uniform(-30, 400, n).astype(np.float32)),
        jnp.asarray(rng.uniform(-3, 3, n).astype(np.float32)),
        jnp.asarray(rng.uniform(-3, 3, n).astype(np.float32)),
        jnp.asarray(rng.integers(0, 2, n).astype(np.int32)),
        jnp.asarray(rng.integers(0, 4, n).astype(np.int32)))
    tp = tparams.params_from_numpy(jp.to_numpy())
    for name, arr in tp.to_numpy().items():
        np.testing.assert_array_equal(arr, jp.to_numpy()[name])
        assert arr.dtype == jp.to_numpy()[name].dtype
    np.testing.assert_allclose(tparams.params_table(tp),
                               jparams.params_table(jp), atol=1e-4)
    zeros = tparams.AlignParams.zeros(n, ref_id=2).to_numpy()
    want_zeros = jparams.AlignParams.zeros(n, ref_id=2).to_numpy()
    for name in zeros:
        np.testing.assert_array_equal(zeros[name], want_zeros[name])
