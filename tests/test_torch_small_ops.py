"""The port's small functions against the JAX package's, on the CPU:
``params.combine_params2`` / ``inverse_transform2``, ``ops/filters.py::
filt_btwl``, the per-particle-reference search (``ops/ccf.py::
ccf_spectra_per_particle_ref`` through ``rotational_shift_search`` and
``rotational_shift_search_shc``), ``models/steps.py::raw_sum_step`` and
``utils/synthetic.py::random_stack``.

Tolerances: the transform algebra on numpy is the same numpy code as the
JAX package's (bitwise); on tensors (float32) 1e-4 degree / pixel
against JAX's float32 path.  ``filt_btwl`` 1e-5 (an f32 FFT against an
f32 matmul DFT).  The per-particle search: winners equal, peaks within
1e-5 of the largest, decoded params within 1e-3 (as
tests/test_torch_search.py).  Sums of the raw stack within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu import params as jparams
from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import steps as jsteps
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu.ops.filters import filt_btwl as jax_filt_btwl
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils import synthetic as jax_synthetic
from cryo_ralib_tpu_torch import params as pparams
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import steps
from cryo_ralib_tpu_torch.ops import search
from cryo_ralib_tpu_torch.ops.filters import filt_btwl
from cryo_ralib_tpu_torch.params import params_from_numpy
from cryo_ralib_tpu_torch.utils import synthetic as port_synthetic

WINNERS = ("best_sidx", "best_mirror", "best_aidx")


def _transforms(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-30, 400, n), rng.uniform(-4, 4, n),
            rng.uniform(-4, 4, n), rng.integers(0, 2, n))


@pytest.mark.parametrize("m1,m2", [(0, 0), (0, 1), (1, 0), (1, 1),
                                   ("mixed", "mixed")])
def test_combine_params2_numpy_equals_jax(m1, m2):
    a1, x1, y1, mm1 = _transforms(seed=1)
    a2, x2, y2, mm2 = _transforms(seed=2)
    m1 = mm1 if m1 == "mixed" else np.full(12, m1)
    m2 = mm2 if m2 == "mixed" else np.full(12, m2)
    got = pparams.combine_params2(a1, x1, y1, m1, a2, x2, y2, m2)
    want = jparams.combine_params2(a1, x1, y1, m1, a2, x2, y2, m2)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.float64
    # scalars as SPHIRE calls it
    g = pparams.combine_params2(10.0, 1.0, 2.0, 1, 20.0, -1.0, 0.5, 0)
    w = jparams.combine_params2(10.0, 1.0, 2.0, 1, 20.0, -1.0, 0.5, 0)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mirror", [0, 1, "mixed"])
def test_inverse_transform2_numpy_equals_jax_and_round_trips(mirror):
    a, x, y, mm = _transforms(seed=3)
    m = mm if mirror == "mixed" else np.full(12, mirror)
    got = pparams.inverse_transform2(a, x, y, m)
    want = jparams.inverse_transform2(a, x, y, m)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # T then T^-1 is the identity
    ca, cx, cy, cm = pparams.combine_params2(a, x, y, m, *got)
    d = np.abs(ca % 360.0)
    np.testing.assert_allclose(np.minimum(d, 360.0 - d), 0.0, atol=1e-9)
    np.testing.assert_allclose(cx, 0.0, atol=1e-9)
    np.testing.assert_allclose(cy, 0.0, atol=1e-9)
    np.testing.assert_array_equal(cm, 0)


def test_transform_algebra_tensors_match_jax_float32():
    """Tensors in give tensors out (float32 angles and shifts, as JAX's
    jnp path), within 1e-4 of the JAX package on jax arrays."""
    a1, x1, y1, m1 = _transforms(seed=4)
    a2, x2, y2, m2 = _transforms(seed=5)
    t = [torch.as_tensor(v) for v in (a1, x1, y1, m1, a2, x2, y2, m2)]
    j = [jnp.asarray(np.asarray(v, np.int32 if i in (3, 7) else np.float32))
         for i, v in enumerate((a1, x1, y1, m1, a2, x2, y2, m2))]
    got = pparams.combine_params2(*t)
    want = jparams.combine_params2(*j)
    assert all(torch.is_tensor(g) for g in got)
    assert got[0].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    got = pparams.inverse_transform2(*t[:4])
    want = jparams.inverse_transform2(*j[:4])
    assert all(torch.is_tensor(g) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    # round trip on tensors
    ca, cx, cy, cm = pparams.combine_params2(*t[:4], *got)
    d = (ca % 360.0).numpy()
    np.testing.assert_allclose(np.minimum(d, 360.0 - d), 0.0, atol=1e-3)
    np.testing.assert_allclose(cx.numpy(), 0.0, atol=1e-4)
    assert (cm == 0).all()


@pytest.mark.parametrize("shape,bands", [((48, 48), (0.1, 0.2)),
                                         ((3, 33, 40), (0.2, 0.35))])
def test_filt_btwl_matches_jax(shape, bands):
    img = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    got = filt_btwl(torch.as_tensor(img), *bands)
    want = np.asarray(jax_filt_btwl(jnp.asarray(img), *bands))
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _ppr_case(n=12, k=3, nx=48, seed=8):
    """A stack of k asymmetric templates, each particle assigned a ref id
    (its true class for most, another for some)."""
    kw = dict(img_dim=nx, ring_num=16, ring_len=256, shift_step=1.0,
              shift_rng_x=1.0, shift_rng_y=1.0)
    refs = jax_synthetic.asymmetric_templates(k, nx)
    imgs, cls = port_synthetic.scattered_stack(refs, n, max_shift=1,
                                               noise=0.1, seed=seed)[:2]
    rid = cls.astype(np.int32)
    rid[::4] = (rid[::4] + 1) % k
    z = np.zeros(n, np.float32)
    jp = JaxParams(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
                   jnp.zeros(n, jnp.int32), jnp.asarray(rid))
    tp = params_from_numpy({"angle": z, "shift_x": z, "shift_y": z,
                            "mirror": np.zeros(n, np.int32), "ref_id": rid})
    return (JaxConfig(**kw), AlignConfig(**kw), refs, imgs.numpy(), jp, tp)


def _assert_winners(got, want, rows=slice(None)):
    for f in WINNERS:
        np.testing.assert_array_equal(getattr(got, f).numpy()[rows],
                                      np.asarray(getattr(want, f))[rows], f)
    np.testing.assert_array_equal(got.best_ref.numpy(), 0)
    peak = np.abs(np.asarray(want.best_val)[rows]).max()
    np.testing.assert_allclose(got.best_val.numpy()[rows],
                               np.asarray(want.best_val)[rows],
                               atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("shift_chunk", [1, 4, 9])
def test_per_particle_ref_search_matches_jax(shift_chunk):
    jcfg, cfg, refs, imgs, jp, tp = _ppr_case()
    want = jsearch.rotational_shift_search(
        jnp.asarray(imgs), jsearch.prepare_ref_spectra(jnp.asarray(refs),
                                                       jcfg),
        jp, jcfg, shift_chunk=shift_chunk, per_particle_ref=True)
    got = search.rotational_shift_search(
        torch.as_tensor(imgs), search.prepare_ref_spectra(
            torch.as_tensor(refs), cfg),
        tp, cfg, shift_chunk=shift_chunk, per_particle_ref=True)
    _assert_winners(got, want)
    p_got = search.decode_params(got, tp, cfg, update_ref=False)
    p_want = jsearch.decode_params(want, jp, jcfg, update_ref=False)
    np.testing.assert_array_equal(p_got.ref_id.numpy(), tp.ref_id.numpy())
    for f in ("angle", "shift_x", "shift_y"):
        np.testing.assert_allclose(getattr(p_got, f).numpy(),
                                   np.asarray(getattr(p_want, f)), atol=1e-3)


def test_per_particle_ref_equals_a_search_against_the_assigned_ref():
    """Each particle's winner is that of a full search against its
    assigned reference alone (the JAX package's test_ops check)."""
    _, cfg, refs, imgs, _, tp = _ppr_case(n=6, seed=9)
    rfw = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    res = search.rotational_shift_search(torch.as_tensor(imgs), rfw, tp,
                                         cfg, per_particle_ref=True)
    for i in range(6):
        one = search.rotational_shift_search(
            torch.as_tensor(imgs[i:i + 1]), rfw[tp.ref_id[i]][None],
            params_from_numpy({k: v[i:i + 1] for k, v in
                               tp._replace(ref_id=tp.ref_id * 0)
                               .to_numpy().items()}), cfg)
        for f in WINNERS + ("best_val",):
            assert getattr(res, f)[i] == getattr(one, f)[0], (i, f)


@pytest.mark.parametrize("thresholds", ["init", "mixed"])
def test_per_particle_ref_shc_matches_jax(thresholds):
    jcfg, cfg, refs, imgs, jp, tp = _ppr_case(seed=10)
    rfw_j = jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg)
    rfw = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    full = jsearch.rotational_shift_search(jnp.asarray(imgs), rfw_j, jp, jcfg,
                                           per_particle_ref=True)
    n = imgs.shape[0]
    if thresholds == "init":
        pm = np.full(n, search.PREVIOUSMAX_INIT, np.float32)
    else:
        pm = (np.asarray(full.best_val) * np.random.default_rng(1).choice(
            [0.5, 0.9, 1.1], n)).astype(np.float32)
    want, found_j = jsearch.rotational_shift_search_shc(
        jnp.asarray(imgs), rfw_j, jp, jcfg, jnp.asarray(pm),
        per_particle_ref=True)
    got, found = search.rotational_shift_search_shc(
        torch.as_tensor(imgs), rfw, tp, cfg, torch.as_tensor(pm),
        per_particle_ref=True)
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_j))
    hit = found.numpy()
    assert hit.any()
    _assert_winners(got, want, rows=hit)


def test_per_particle_ref_has_no_kernel():
    """The kernel searches every reference: "auto" on a CUDA device runs
    the plain search (logged), "kernel" raises, on the CPU plain."""
    cfg = AlignConfig(img_dim=48, ring_num=16, shift_rng_x=1.0,
                      shift_rng_y=1.0)
    for dev in ("cpu", "cuda"):
        assert steps.resolve_route("auto", dev, cfg,
                                   per_particle_ref=True).search == "plain"
    with pytest.raises(ValueError, match="per_particle_ref"):
        steps.resolve_route("kernel", "cuda", cfg, per_particle_ref=True)


@pytest.mark.parametrize("n_classes,with_valid", [(1, False), (3, True)])
def test_raw_sum_step_matches_jax(n_classes, with_valid):
    rng = np.random.default_rng(11)
    imgs = rng.standard_normal((9, 20, 20)).astype(np.float32)
    gidx = np.arange(5, 14)
    valid = (rng.random(9) > 0.3).astype(np.float32) if with_valid else None
    want = jsteps.raw_sum_step(
        jnp.asarray(imgs), jnp.asarray(gidx),
        None if valid is None else jnp.asarray(valid), n_classes=n_classes)
    got = steps.raw_sum_step(
        torch.as_tensor(imgs), torch.as_tensor(gidx),
        None if valid is None else torch.as_tensor(valid),
        n_classes=n_classes)
    assert got.shape == (n_classes, 2, 20, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_random_stack_equals_jax():
    got = port_synthetic.random_stack(5, 12, seed=3)
    np.testing.assert_array_equal(got, jax_synthetic.random_stack(5, 12,
                                                                  seed=3))
    assert got.dtype == np.float32 and got.shape == (5, 12, 12)
