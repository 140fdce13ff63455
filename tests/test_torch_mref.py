"""The port's multireference alignment (the slice end to end) against
``mref_ali2d_tpu(sampler="gather")`` on the CPU, at the sizes of
tests/test_parity_e2e.py.

Tolerances: assignments, mirrors and class counts exactly equal;
header params within 1e-3 (the parity bar of BASELINE.json); class
averages within 1e-4 and the FSC / params text files within 1e-3 (f32
FFTs against f32 matmul DFTs, summed over iterations and through the
Nelder-Mead tanh fit).
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import mref_ali2d_tpu
from cryo_ralib_tpu.models.steps import align_step as jax_align_step
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu.utils.synthetic import (asymmetric_templates,
                                            class_templates, scattered_stack)
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.models.steps import align_step
from cryo_ralib_tpu_torch.ops import ctf_ops
from cryo_ralib_tpu_torch.params import params_from_numpy
from cryo_ralib_tpu_torch.utils.log import RunLogger

K, NX, N, ITERS, OU, XR = 2, 48, 8, 2, 16, 1


def _stack(seed=43):
    base = class_templates(K, NX)
    # seed 43 gives mixed class labels, so no class vanishes
    imgs, cls, _, _ = scattered_stack(base, N, max_shift=1, noise=0.01,
                                      seed=seed)
    return base, imgs, cls


def _run_both(imgs, refs, user_func, outdirs=(None, None),
              log_to_outdir=False, center=-1):
    kw = dict(ou=OU, xr=XR, yr=XR, ts=1, maxit=ITERS,
              user_func_name=user_func, rand_seed=1000, center=center)
    want = mref_ali2d_tpu(
        imgs, refs.copy(), outdir=outdirs[0], sampler="gather",
        log=None if log_to_outdir else JaxLogger(None, quiet=True), **kw)
    got = mref_ali2d(
        imgs, refs.copy(), outdir=outdirs[1], device="cpu",
        log=None if log_to_outdir else RunLogger(None, quiet=True), **kw)
    return got, want


def _assert_results_match(got, want):
    np.testing.assert_array_equal(got.assignments, want.assignments)
    np.testing.assert_array_equal(got.class_counts, want.class_counts)
    np.testing.assert_array_equal(got.params[:, 3], want.params[:, 3])
    d_ang = np.abs(got.params[:, 0] - want.params[:, 0])
    assert np.minimum(d_ang, 360.0 - d_ang).max() < 1e-3
    np.testing.assert_allclose(got.params[:, 1:3], want.params[:, 1:3],
                               atol=1e-3)
    assert [list(m) for m in got.members] == [list(m) for m in want.members]
    assert got.iterations == want.iterations == ITERS


def _assert_outputs_match(d_port, d_jax, atol=1e-4):
    """The same output files, the resume checkpoint included; images
    within ``atol``."""
    want_files = set(os.listdir(d_jax))
    assert set(os.listdir(d_port)) == want_files
    assert {"aqm000.hdf", "aqm001.hdf", "final2Dparams.txt",
            "checkpoint.npz", "checkpoint_rng.pkl"} <= want_files
    assert any(name.startswith("drm") for name in want_files)
    for name in sorted(want_files):
        a, b = os.path.join(d_port, name), os.path.join(d_jax, name)
        if name == "checkpoint.npz":
            za, zb = np.load(a), np.load(b)
            assert set(za.files) == set(zb.files)
            for key in ("iteration", "mirror", "ref_id"):
                np.testing.assert_array_equal(za[key], zb[key])
            np.testing.assert_allclose(za["refs"], zb["refs"], atol=atol)
        elif name == "checkpoint_rng.pkl":
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
        elif name.endswith(".hdf"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                ga, gb = fa["MDF/images"], fb["MDF/images"]
                assert ga.attrs["imageid_max"] == gb.attrs["imageid_max"]
                for key in gb:
                    np.testing.assert_allclose(ga[key]["image"][()],
                                               gb[key]["image"][()],
                                               atol=atol)
                    assert dict(ga[key].attrs).keys() == \
                        dict(gb[key].attrs).keys()
                    np.testing.assert_array_equal(
                        ga[key].attrs["EMAN.members"],
                        gb[key].attrs["EMAN.members"])
                    assert ga[key].attrs["EMAN.ave_n"] == \
                        gb[key].attrs["EMAN.ave_n"]
        elif name != "logfile.txt":
            np.testing.assert_allclose(np.loadtxt(a), np.loadtxt(b),
                                       atol=1e-3, err_msg=name)


@pytest.mark.parametrize("update_ref", [True, False])
def test_align_step_matches_jax_gather(update_ref):
    """One step: search, decode, transform and even/odd sums against JAX
    ``align_step(sampler="gather")``, with accumulated shifts, a padding
    mask and odd global indices."""
    n, nx, k = 16, 64, 3
    kw = dict(img_dim=nx, ring_num=20, ring_len=256, shift_step=1.0,
              shift_rng_x=2.0, shift_rng_y=2.0)
    base = asymmetric_templates(k, nx)
    imgs, _, _, _ = scattered_stack(base, n, max_shift=2, noise=0.05, seed=5)
    rng = np.random.default_rng(12)
    state = {"angle": np.zeros(n, np.float32),
             "shift_x": rng.choice([0.0, 1.0, -0.5], n).astype(np.float32),
             "shift_y": rng.choice([0.0, -1.0, 0.25], n).astype(np.float32),
             "mirror": np.zeros(n, np.int32),
             "ref_id": rng.integers(0, k, n).astype(np.int32)}
    gidx = (np.arange(n) + 3).astype(np.int32)
    valid = (np.arange(n) < 13).astype(np.float32)
    step = jax.jit(functools.partial(
        jax_align_step, cfg=JaxConfig(**kw), n_classes=k,
        update_ref=update_ref, sampler="gather"))
    want = step(jnp.asarray(imgs), jnp.asarray(base),
                JaxParams(*[jnp.asarray(state[f]) for f in JaxParams._fields]),
                jnp.asarray(gidx), jnp.asarray(valid))
    got = align_step(torch.as_tensor(imgs), torch.as_tensor(base),
                     params_from_numpy(state), torch.as_tensor(gidx),
                     torch.as_tensor(valid), AlignConfig(**kw), n_classes=k,
                     update_ref=update_ref)
    for f in ("shift_x", "shift_y", "mirror", "ref_id"):
        np.testing.assert_array_equal(getattr(got.params, f).numpy(),
                                      np.asarray(getattr(want.params, f)))
    d = np.abs(got.params.angle.numpy() - np.asarray(want.params.angle))
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    sums = np.asarray(want.class_sums)
    np.testing.assert_allclose(got.class_sums.numpy(), sums, rtol=0,
                               atol=1e-4 * np.abs(sums).max())
    peak = np.asarray(want.peak)
    np.testing.assert_allclose(got.peak.numpy(), peak, rtol=0,
                               atol=1e-5 * np.abs(peak).max())
    for f in ("sx_sum", "sy_sum"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), atol=1e-3)


@pytest.mark.parametrize("mirror", [True, False])
def test_align_step_masked_matches_jax_gather(mirror):
    """One --dst step: the angle-masked search decoded without
    refinement, on the reference-free shape (K=1, refs kept), against
    JAX ``align_step(sampler="gather", angle_mask=...)``."""
    from cryo_ralib_tpu.ops.search import delta_angle_mask

    n, nx = 12, 64
    kw = dict(img_dim=nx, ring_num=20, ring_len=256, shift_step=1.0,
              shift_rng_x=1.0, shift_rng_y=1.0, mirror=mirror)
    ref = asymmetric_templates(1, nx)
    imgs, _, _, _ = scattered_stack(ref, n, max_shift=1, noise=0.05, seed=8)
    mask = delta_angle_mask(256, 15.0)
    state = {f: np.zeros(n, np.int32 if f in ("mirror", "ref_id")
                         else np.float32) for f in JaxParams._fields}
    gidx = np.arange(n, dtype=np.int32)
    want = jax_align_step(jnp.asarray(imgs), jnp.asarray(ref),
                          JaxParams(*[jnp.asarray(state[f])
                                      for f in JaxParams._fields]),
                          jnp.asarray(gidx), None, JaxConfig(**kw),
                          n_classes=1, update_ref=False, sampler="gather",
                          angle_mask=jnp.asarray(mask))
    got = align_step(torch.as_tensor(imgs), torch.as_tensor(ref),
                     params_from_numpy(state), torch.as_tensor(gidx), None,
                     AlignConfig(**kw), n_classes=1, update_ref=False,
                     angle_mask=torch.as_tensor(mask))
    for f in JaxParams._fields:
        np.testing.assert_array_equal(getattr(got.params, f).numpy(),
                                      np.asarray(getattr(want.params, f)),
                                      err_msg=f)
    # exact bin angles: 360 - step * bin, +180 on the mirrored branch
    ang = got.params.angle.numpy() - 180.0 * got.params.mirror.numpy()
    bins = np.round((360.0 - ang) / (360.0 / 256)).astype(int) % 256
    assert (mask[bins] == 0).all()
    sums = np.asarray(want.class_sums)
    np.testing.assert_allclose(got.class_sums.numpy(), sums, rtol=0,
                               atol=1e-4 * np.abs(sums).max())


def test_mref_matches_jax_no_filter():
    base, imgs, cls = _stack()
    got, want = _run_both(imgs, base, "ref_ali2d_no_filter")
    assert (want.class_counts >= 4).all()
    _assert_results_match(got, want)
    np.testing.assert_allclose(got.references, want.references, atol=1e-4)
    assert (got.assignments == cls).all()


def test_mref_matches_jax_ref_ali2d_with_outputs(tmp_path):
    base, imgs, _ = _stack()
    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "port")
    got, want = _run_both(imgs, base, "ref_ali2d", (d_jax, d_port))
    _assert_results_match(got, want)
    np.testing.assert_allclose(got.references, want.references, atol=1e-4)

    _assert_outputs_match(d_port, d_jax)
    assert "drm0000000.txt" in os.listdir(d_port)


def _ctf_params(seed=0):
    """Per-particle defocus, astigmatism and the microscope's scalars."""
    rng = np.random.default_rng(seed)
    dfu = rng.uniform(8000.0, 25000.0, N)
    return dict(dfu=dfu, dfv=dfu + rng.uniform(-400.0, 400.0, N),
                dfang=rng.uniform(0.0, 180.0, N), apix=1.7, voltage=200.0,
                cs=2.0, w=0.07)


@pytest.mark.parametrize("case", ["eman2", "ctf", "eman2_ctf"])
def test_mref_modes_match_jax_with_outputs(tmp_path, case):
    """``ring_scheme="eman2"`` and ``CTF=True`` (Wiener-restored
    references) end to end, every output file compared.  Asymmetric
    templates: the dihedral ``class_templates`` make every mirror flag a
    near-tie, which the eman2 weights decide by rounding."""
    base = asymmetric_templates(K, NX)
    imgs = scattered_stack(base, N, max_shift=1, noise=0.05, seed=43)[0]
    kw = dict(ou=OU, xr=XR, yr=XR, ts=1, maxit=ITERS, rand_seed=1000)
    if "eman2" in case:
        kw["ring_scheme"] = "eman2"
    atol = 1e-4
    if "ctf" in case:
        # particles seen through their CTFs; the two packages' f32 CTFs
        # agree to 6e-5 (tests/test_torch_ctf.py) and the Wiener division
        # carries that into the references: 5e-4 (measured 1.2e-4)
        p = _ctf_params()
        ctf = ctf_ops.ctf_rfft2(NX, p["apix"], p["dfu"], p["dfv"],
                                p["dfang"], p["voltage"], p["cs"], p["w"])
        imgs = ctf_ops.filt_ctf(torch.as_tensor(imgs), ctf).numpy()
        kw.update(CTF=True, snr=2.0, ctf_params=p)
        atol = 5e-4
    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "port")
    want = mref_ali2d_tpu(imgs, base.copy(), outdir=d_jax, sampler="gather",
                          log=JaxLogger(None, quiet=True), **kw)
    got = mref_ali2d(imgs, base.copy(), outdir=d_port, device="cpu",
                     log=RunLogger(None, quiet=True), **kw)
    _assert_results_match(got, want)
    np.testing.assert_allclose(got.references, want.references, atol=atol)
    _assert_outputs_match(d_port, d_jax, atol=atol)
    plain, _ = _run_both(imgs, base, "ref_ali2d")
    assert not np.allclose(plain.references, got.references, atol=1e-4)
    assert (want.class_counts >= 4).all()


def test_mref_refuses_the_kernel_for_eman2():
    base, imgs, _ = _stack()
    with pytest.raises(ValueError, match="sampler='kernel'"):
        mref_ali2d(imgs, base, ou=OU, xr=XR, maxit=1, ring_scheme="eman2",
                   sampler="kernel", device="cpu",
                   log=RunLogger(None, quiet=True))
    with pytest.raises(ValueError, match="ctf_params"):
        mref_ali2d(imgs, base, ou=OU, xr=XR, maxit=1, CTF=True,
                   device="cpu", log=RunLogger(None, quiet=True))


def test_mref_vanished_class_reseeds_like_jax(tmp_path):
    """A blank reference matches no particle and vanishes (< 4 members);
    both packages reseed it from the same particle of
    random.Random(rand_seed) and carry on alike."""
    base, imgs, _ = _stack()
    refs = np.concatenate([base, np.zeros((1, NX, NX), np.float32)])
    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "port")
    got, want = _run_both(imgs, refs, "ref_ali2d_no_filter", (d_jax, d_port),
                          log_to_outdir=True)
    _assert_results_match(got, want)
    np.testing.assert_allclose(got.references, want.references, atol=1e-4)

    def reseeds(d):
        with open(os.path.join(d, "logfile.txt")) as f:
            return [line.split(" :: ")[1].strip() for line in f
                    if "reseeded" in line]

    assert reseeds(d_port) == reseeds(d_jax)
    assert reseeds(d_jax)[0].endswith("[2]")


def test_mref_center1_matches_jax(tmp_path):
    """--center=1: each filtered reference is centered on its positive
    center of gravity (ops/center.py), as in the JAX package."""
    base, imgs, _ = _stack()
    got, want = _run_both(imgs, base, "ref_ali2d", center=1)
    _assert_results_match(got, want)
    np.testing.assert_allclose(got.references, want.references, atol=1e-4)
    with pytest.raises(ValueError, match="center=2"):
        mref_ali2d(imgs, base, ou=OU, xr=XR, maxit=1, center=2,
                   device="cpu", log=RunLogger(None, quiet=True))


def test_mref_resumes_like_a_straight_run(tmp_path):
    """Two iterations (by either package), then the port resumes to four:
    the same as a straight run of four (the vanished-class RNG state
    comes back from checkpoint_rng.pkl)."""
    base, imgs, _ = _stack()
    kw = dict(ou=OU, xr=XR, yr=XR, ts=1, user_func_name="ref_ali2d")
    straight = mref_ali2d(imgs, base.copy(), maxit=4, device="cpu",
                          outdir=str(tmp_path / "straight"),
                          log=RunLogger(None, quiet=True), **kw)
    for pkg in ("port", "jax"):
        d = str(tmp_path / pkg)
        if pkg == "port":
            mref_ali2d(imgs, base.copy(), outdir=d, maxit=2, device="cpu",
                       log=RunLogger(None, quiet=True), **kw)
        else:
            mref_ali2d_tpu(imgs, base.copy(), outdir=d, maxit=2,
                           sampler="gather", log=JaxLogger(None, quiet=True),
                           **kw)
        resumed = mref_ali2d(imgs, base.copy(), outdir=d, maxit=4,
                             resume=True, device="cpu",
                             log=RunLogger(None, quiet=True), **kw)
        np.testing.assert_array_equal(resumed.assignments,
                                      straight.assignments)
        np.testing.assert_array_equal(resumed.params[:, 3],
                                      straight.params[:, 3])
        np.testing.assert_allclose(resumed.params[:, 1:3],
                                   straight.params[:, 1:3], atol=1e-3)
        np.testing.assert_allclose(resumed.references, straight.references,
                                   atol=1e-4)


def test_entry_points_default_to_cuda(monkeypatch):
    """Called without ``device``, the entry points run on the GPU; with
    no CUDA they raise an error that names CUDA instead of falling back
    to the CPU."""
    from cryo_ralib_tpu_torch.config import AlignConfig
    from cryo_ralib_tpu_torch.models import ali2d_base
    from cryo_ralib_tpu_torch.models.engine import AlignmentEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, imgs, _ = _stack()
    quiet = RunLogger(None, quiet=True)
    for call in (
            lambda: mref_ali2d(imgs, base, ou=OU, xr=XR, maxit=1, log=quiet),
            lambda: ali2d_base(imgs, ou=OU, xr=XR, maxit=1, log=quiet),
            lambda: AlignmentEngine(torch.as_tensor(imgs),
                                    AlignConfig(img_dim=NX, ring_num=OU),
                                    n_classes=K)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
