"""The PyTorch port's ops against their JAX counterparts on the CPU.

Tolerance: atol/rtol 1e-5 (scaled by the data's magnitude where it is
large).  The port's DFTs are f32 FFTs, the JAX package's are f32 matmul
DFTs at HIGHEST precision; the two agree to ~7e-7 relative on a
36 x 256 ring block."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu.models import checkpoint as jcheckpoint
from cryo_ralib_tpu.models import user_functions as juser_functions
from cryo_ralib_tpu.ops import ccf as jccf
from cryo_ralib_tpu.ops import center as jcenter
from cryo_ralib_tpu.ops import classavg as jclassavg
from cryo_ralib_tpu.ops import filters as jfilters
from cryo_ralib_tpu.ops import interp as jinterp
from cryo_ralib_tpu.ops import masks as jmasks
from cryo_ralib_tpu.ops import polar as jpolar
from cryo_ralib_tpu.ops import transform as jtransform
from cryo_ralib_tpu import params as jparams
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import checkpoint, user_functions
from cryo_ralib_tpu_torch.ops import ccf, center, classavg, filters, interp
from cryo_ralib_tpu_torch.ops import masks, polar, transform
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


@pytest.mark.parametrize("shift", ["scalar", "per_image"])
def test_fshift(stack, shift):
    if shift == "scalar":
        sx, sy = 1.25, -0.5
    else:
        sx = np.array([0.5, -1.0, 2.25, 0.0], np.float32)
        sy = np.array([-0.75, 0.0, 1.5, 3.0], np.float32)
    got = filters.fshift(_t(stack), sx, sy)
    want = jfilters.fshift(jnp.asarray(stack), sx, sy)
    _close(got, want, float(np.abs(stack).max()))
    # an integer shift moves the content by whole pixels (circularly)
    whole = filters.fshift(_t(stack), 2.0, -1.0).numpy()
    np.testing.assert_allclose(whole, np.roll(stack, (-1, 2), (-2, -1)),
                               atol=1e-5)


@pytest.mark.parametrize("method", [0, 1])
def test_center_2D(method):
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:32, 0:32]
    img = (np.exp(-((yy - 19.3) ** 2 + (xx - 12.6) ** 2) / 8.0)
           + 0.01 * rng.standard_normal((32, 32))).astype(np.float32)
    got, gsx, gsy = center.center_2D(_t(img), method)
    want, wsx, wsy = jcenter.center_2D(jnp.asarray(img), method)
    _close(got, want)
    np.testing.assert_allclose([float(gsx), float(gsy)],
                               [float(wsx), float(wsy)], rtol=1e-5, atol=1e-5)
    if method == 1:
        # the blob sits 3.4 px left of and 3.3 px below the center
        assert float(gsx) < -2.0 and float(gsy) > 2.0
    with pytest.raises(ValueError, match="center=2"):
        center.center_2D(_t(img), 2)


@pytest.mark.parametrize("center_flag", [0, 1])
def test_ref_ali2d_user_function(center_flag):
    rng = np.random.default_rng(10)
    yy, xx = np.mgrid[0:32, 0:32]
    avg = (np.exp(-((yy - 18.0) ** 2 + (xx - 13.0) ** 2) / 10.0)
           + 0.05 * rng.standard_normal((32, 32))).astype(np.float32)
    freqs = np.arange(17) / 32.0
    frsc = (freqs, np.clip(1.2 - 4.0 * freqs, 0.0, 1.0), np.ones(17))
    mask = masks.model_circle(14, 32)
    got, gcs = user_functions.ref_ali2d([mask, center_flag, avg, frsc])
    want, wcs = juser_functions.ref_ali2d([mask, center_flag, avg, frsc])
    _close(torch.as_tensor(got), want)
    np.testing.assert_allclose(gcs, wcs, atol=1e-5)
    assert (gcs != [0.0, 0.0]) == bool(center_flag)


def test_ref_ali2d_fits_each_curve_once(monkeypatch):
    """``mref_ali2d`` passes one FSC curve for every class of an
    iteration: the tanh fit runs once per curve, and each class's filter
    is the one an unshared fit gives, bit for bit."""
    from cryo_ralib_tpu_torch.ops.filters import filt_tanl
    from cryo_ralib_tpu_torch.ops.fsc import fit_tanh

    calls = []

    def counted(curve, *a, **k):
        calls.append(curve)
        return fit_tanh(curve, *a, **k)

    monkeypatch.setattr(user_functions, "fit_tanh", counted)
    user_functions._fit.cache_clear()
    rng = np.random.default_rng(11)
    freqs = np.arange(17, dtype=np.float32) / 32.0
    curves = [(freqs, np.clip(c - 4.0 * freqs, 0.0, 1.0), np.ones(17))
              for c in (1.2, 1.6)]
    mask = masks.model_circle(14, 32)
    for n, frsc in enumerate(curves, 1):
        for _ in range(3):
            avg = rng.standard_normal((32, 32)).astype(np.float32)
            got, _cs = user_functions.ref_ali2d([mask, -1, avg, frsc])
            want = filt_tanl(torch.as_tensor(avg), *fit_tanh(frsc)).numpy()
            assert np.array_equal(got, want)
        assert len(calls) == n
    user_functions._fit.cache_clear()


def test_pixel_error_2D():
    rng = np.random.default_rng(12)
    p1 = tuple(rng.uniform(-5, 365, 20) if i == 0 else rng.uniform(-3, 3, 20)
               for i in range(3))
    p2 = tuple(rng.uniform(-5, 365, 20) if i == 0 else rng.uniform(-3, 3, 20)
               for i in range(3))
    got = tparams.pixel_error_2D(p1, p2, 36.0)
    want = jparams.pixel_error_2D(p1, p2, 36.0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    same = tparams.pixel_error_2D((10.0, 1.0, -1.0), (370.0, 1.0, -1.0), 36.0)
    assert float(same) < 1e-5


def test_checkpoint_round_trip_with_jax_files(tmp_path):
    """Either package reads the other's checkpoint.npz (and RNG state)."""
    import random

    rng = np.random.default_rng(13)
    n = 7
    state = {"angle": rng.uniform(0, 360, n).astype(np.float32),
             "shift_x": rng.uniform(-2, 2, n).astype(np.float32),
             "shift_y": rng.uniform(-2, 2, n).astype(np.float32),
             "mirror": rng.integers(0, 2, n).astype(np.int32),
             "ref_id": rng.integers(0, 3, n).astype(np.int32)}
    refs = rng.standard_normal((3, 8, 8)).astype(np.float32)
    extra = {"sums": rng.standard_normal((1, 2, 8, 8)).astype(np.float32),
             "a0": 12.5, "sx_sum": -0.25, "sy_sum": 3.0}
    for writer, reader in ((jcheckpoint, checkpoint),
                           (checkpoint, jcheckpoint)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir()
        wrng = random.Random(5)
        wrng.random()
        params = (jparams.AlignParams if writer is jcheckpoint
                  else tparams.AlignParams)(*[state[f] for f in
                                              tparams.AlignParams._fields])
        writer.save_checkpoint(str(d), 4, params, refs, extra=extra,
                               rng=wrng)
        rrng = random.Random(0)
        it, got, got_refs, got_extra = reader.load_checkpoint(str(d), rrng)
        assert it == 4 and rrng.random() == wrng.random()
        for f in tparams.AlignParams._fields:
            np.testing.assert_array_equal(getattr(got, f), state[f])
            assert getattr(got, f).dtype == state[f].dtype
        np.testing.assert_array_equal(got_refs, refs)
        assert set(got_extra) == set(extra)
        for key, val in extra.items():
            np.testing.assert_array_equal(got_extra[key], val)
    assert checkpoint.load_checkpoint(str(tmp_path)) is None
