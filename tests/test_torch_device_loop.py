"""The port's device-resident loops (``models/device_loop.py``) and
``filt_tanl_dyn`` against the JAX package's, on the CPU, with the plain
search (the JAX loops' ``sampler="gather"`` branch: the f32 search and
the bilinear transform + even/odd class sums).

Tolerances: ref_id, mirror and the accumulated shifts exactly equal;
angles within 1e-3 degree (BASELINE.json's parity bar); the average and
the references within 1e-4 of their largest value (torch.fft against
JAX's matmul DFTs, both f32, over up to three iterations);
``filt_tanl_dyn`` within 1e-5 of the image's largest value.  The loops
call ``align_step``, so they take half rings and the eman2 rings through
``cfg`` as the JAX loops do; one case each.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import device_loop as jax_loop
from cryo_ralib_tpu.ops.filters import filt_tanl_dyn as jax_filt_tanl_dyn
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils.synthetic import (asymmetric_templates,
                                            scattered_stack)
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import (make_device_loop,
                                         make_mref_device_loop,
                                         ref_free_alignment_2d)
from cryo_ralib_tpu_torch.models.steps import align_step
from cryo_ralib_tpu_torch.ops.filters import filt_tanl, filt_tanl_dyn
from cryo_ralib_tpu_torch.params import AlignParams

NX, N = 48, 12
GEOM = dict(img_dim=NX, ring_num=16, ring_len=256, shift_step=1.0,
            shift_rng_x=1.0, shift_rng_y=1.0)


def _stack(k, seed):
    base = asymmetric_templates(k, NX)
    imgs = scattered_stack(base, N, max_shift=1, noise=0.05, seed=seed)[0]
    return base, np.asarray(imgs, np.float32)


def _assert_params_match(got, want):
    for f in ("ref_id", "mirror", "shift_x", "shift_y"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    d = np.abs(got.angle.numpy() - np.asarray(want.angle))
    assert np.minimum(d, 360.0 - d).max() < 1e-3


def _assert_images_match(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("cutoff", [0.2, 0.0, -0.1])
def test_filt_tanl_dyn_matches_jax(cutoff):
    """Cutoff > 0 filters; 0 and < 0 leave the image as it is."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, NX, NX)).astype(np.float32)
    want = np.asarray(jax_filt_tanl_dyn(jnp.asarray(img), jnp.float32(cutoff),
                                        jnp.float32(0.1)))
    got = filt_tanl_dyn(torch.as_tensor(img), torch.tensor(cutoff),
                        torch.tensor(0.1))
    tol = 1e-5 * np.abs(img).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if cutoff > 0:
        np.testing.assert_allclose(
            got.numpy(), filt_tanl(torch.as_tensor(img), cutoff, 0.1).numpy(),
            rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(got.numpy(), img, rtol=0, atol=tol)


@pytest.mark.parametrize("n_iter", [1, 3])
def test_device_loop_matches_jax(n_iter):
    base, imgs = _stack(1, seed=21)
    cut = np.full(n_iter, 0.25, np.float32)
    avg0 = imgs.mean(0)
    want_p, want_avg = jax_loop.make_device_loop(
        JaxConfig(**GEOM), n_iter, cut, sampler="gather")(
        jnp.asarray(imgs), avg0, JaxParams.zeros(N),
        jnp.arange(N, dtype=jnp.int32), jnp.ones(N, jnp.float32))
    got_p, got_avg = make_device_loop(
        AlignConfig(**GEOM), n_iter, cut, device="cpu", sampler="plain")(
        torch.as_tensor(imgs), torch.as_tensor(avg0), AlignParams.zeros(N),
        torch.arange(N), torch.ones(N))
    _assert_params_match(got_p, want_p)
    _assert_images_match(got_avg, want_avg)


@pytest.mark.parametrize("n_iter", [1, 3])
def test_mref_device_loop_matches_jax(n_iter):
    k = 3
    base, imgs = _stack(k, seed=31)
    cut = np.full(n_iter, 0.25, np.float32)
    gidx = (np.arange(N) + 1).astype(np.int32)
    valid = (np.arange(N) < N - 1).astype(np.float32)
    want_p, want_refs = jax_loop.make_mref_device_loop(
        JaxConfig(**GEOM), n_iter, k, cut, sampler="gather")(
        jnp.asarray(imgs), base, JaxParams.zeros(N), jnp.asarray(gidx),
        jnp.asarray(valid))
    got_p, got_refs = make_mref_device_loop(
        AlignConfig(**GEOM), n_iter, k, cut, device="cpu", sampler="plain")(
        torch.as_tensor(imgs), torch.as_tensor(base), AlignParams.zeros(N),
        torch.as_tensor(gidx), torch.as_tensor(valid))
    _assert_params_match(got_p, want_p)
    _assert_images_match(got_refs, want_refs)


@pytest.mark.parametrize("mref", [False, True], ids=["reffree", "mref"])
def test_one_loop_iteration_is_one_align_step(mref):
    """One loop iteration == the port's ``align_step`` plus the rebuild
    of the average (or of the references, a class with < 4 members
    keeping its old one), as tests/test_device_loop.py holds the JAX
    loops."""
    k = 3 if mref else 1
    base, imgs = _stack(k, seed=41)
    cfg = AlignConfig(**GEOM)
    x = torch.as_tensor(imgs)
    gidx, valid = torch.arange(N), torch.ones(N)
    refs0 = torch.as_tensor(base) if mref else x.mean(0)[None]
    out = align_step(x, refs0, AlignParams.zeros(N), gidx, valid, cfg,
                     n_classes=k, update_ref=mref, sampler="plain")
    sums = out.class_sums
    if mref:
        p, refs = make_mref_device_loop(cfg, 1, k, np.zeros(1), device="cpu",
                                        sampler="plain")(
            x, refs0, AlignParams.zeros(N), gidx, valid)
        # the class sums are f64 (ops/classavg.py), the references f32
        want = ((sums[:, 0] + sums[:, 1])
                / out.counts.clamp(min=1)[:, None, None]).float()
        keep = out.counts < 4
        want[keep] = refs0[keep]
    else:
        p, refs = make_device_loop(cfg, 1, np.zeros(1), device="cpu",
                                   sampler="plain")(
            x, refs0[0], AlignParams.zeros(N), gidx, valid)
        want = ((sums[0, 0] + sums[0, 1]) / N).float()
    # the loop's all-pass filter is an rfft2/irfft2 round trip of the
    # references: rounding-level changes, hence the tolerances
    for f in ("ref_id", "mirror", "shift_x", "shift_y"):
        assert torch.equal(getattr(p, f), getattr(out.params, f)), f
    torch.testing.assert_close(p.angle, out.params.angle, rtol=0, atol=1e-3)
    torch.testing.assert_close(refs, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_ref_free_alignment_2d_matches_jax():
    _base, imgs = _stack(1, seed=51)
    kw = dict(n_iter=3, ou=16, xr=1, ts=1, cutoff=0.25)
    want_p, want_avg = jax_loop.ref_free_alignment_2d(imgs, sampler="gather",
                                                      **kw)
    got_p, got_avg = ref_free_alignment_2d(imgs, device="cpu", **kw)
    _assert_params_match(AlignParams(*map(torch.as_tensor, got_p)), want_p)
    _assert_images_match(torch.as_tensor(got_avg), want_avg)
    assert got_avg.shape == (NX, NX) and got_p.angle.shape == (N,)


@pytest.mark.parametrize("geom", [dict(mode="H"),
                                  dict(ring_scheme="eman2")],
                         ids=["mode_h", "eman2"])
def test_device_loop_modes_match_jax(geom):
    """Half rings and the eman2 ring scheme through the loop's ``cfg``."""
    n_iter = 2
    _base, imgs = _stack(1, seed=61)
    cut = np.full(n_iter, 0.25, np.float32)
    avg0 = imgs.mean(0)
    kw = dict(GEOM, **geom)
    want_p, want_avg = jax_loop.make_device_loop(
        JaxConfig(**kw), n_iter, cut, sampler="gather")(
        jnp.asarray(imgs), avg0, JaxParams.zeros(N),
        jnp.arange(N, dtype=jnp.int32), jnp.ones(N, jnp.float32))
    got_p, got_avg = make_device_loop(
        AlignConfig(**kw), n_iter, cut, device="cpu")(
        torch.as_tensor(imgs), torch.as_tensor(avg0), AlignParams.zeros(N),
        torch.arange(N), torch.ones(N))
    _assert_params_match(got_p, want_p)
    _assert_images_match(got_avg, want_avg)


def test_ref_free_loop_mirror_flags_match_jax_at_128_particles():
    """A mirrored stack of 128 noisy particles, 8 iterations: the port's
    loop and the JAX loop (``sampler="gather"``) give the same mirror
    flag for every particle and params within 1e-3.  At 12 particles a
    fault in the loop's mirror handling could hide; at this size it
    cannot.  How many flags match the truth is the loop's own business
    (a fixed cutoff, no centering) and the same in both packages."""
    from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack as mk

    tmpl = asymmetric_templates(1, 32)
    imgs, _, _, _, truth = mk(tmpl, 128, max_shift=2, noise=1.0, seed=12,
                              mirror=True)
    imgs = np.asarray(imgs, np.float32)
    assert 32 < truth.sum() < 96
    kw = dict(n_iter=8, ou=12, xr=2, ts=1, cutoff=0.25)
    want_p, want_avg = jax_loop.ref_free_alignment_2d(imgs, sampler="gather",
                                                      **kw)
    got_p, got_avg = ref_free_alignment_2d(imgs, device="cpu", **kw)
    np.testing.assert_array_equal(got_p.mirror, np.asarray(want_p.mirror))
    assert 0 < got_p.mirror.sum() < 128
    _assert_params_match(AlignParams(*map(torch.as_tensor, got_p)), want_p)
    _assert_images_match(torch.as_tensor(got_avg), want_avg)


def test_loops_default_to_cuda(monkeypatch):
    """Without ``device``, the loops run on the GPU; with no CUDA they
    raise an error naming CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AlignConfig(**GEOM)
    for call in (lambda: make_device_loop(cfg, 1, np.zeros(1)),
                 lambda: make_mref_device_loop(cfg, 1, 2, np.zeros(1)),
                 lambda: ref_free_alignment_2d(np.zeros((2, NX, NX),
                                                        np.float32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
