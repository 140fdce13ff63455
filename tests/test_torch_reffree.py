"""The port's reference-free alignment (``ali2d_base``) against
``ali2d_base_tpu(sampler="gather")`` on the CPU, at the sizes of
tests/test_drivers.py and tests/test_delta.py.

Tolerances: mirrors exactly equal; header params within 1e-3 (the
parity bar of BASELINE.json); criteria and mirror consistency within
1e-5 relative; pixel errors, which are computed from those params,
within 1e-3 px; averages and HDF images within 1e-4 of
their largest value and the text files within 1e-3 (f32 FFTs against
f32 matmul DFTs, through the Nelder-Mead tanh fit and the iterations).
The FSC value of the zero-frequency shell is left out: the stack's
masked mean is subtracted, so it is the sign of two rounding residues.
The same bars hold every alignment mode (half rings, SHC, SCF, the eman2
rings, CTF); ``Fourvar``, where ``ali2d_base_tpu``'s default variance engine
is another interpolation, is in tests/test_torch_fourvar.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from cryo_ralib_tpu.models import ali2d_base_tpu
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu.utils.synthetic import asymmetric_templates
from cryo_ralib_tpu_torch.models import ali2d_base
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

NX, N, OU, XR = 48, 12, 16, 1.0

CASES = {
    "default": dict(maxit=3),
    "nomirror": dict(maxit=3, nomirror=True),
    "dst": dict(maxit=11, dst=90.0, user_func_name="ref_ali2d_no_filter"),
    "center1": dict(maxit=3, center=1),
    "maxit0": dict(maxit=0),
    "mode_h": dict(maxit=3, mode="H"),
    "mode_h_dst": dict(maxit=11, dst=45.0, mode="H",
                       user_func_name="ref_ali2d_no_filter"),
    "shc": dict(maxit=4, random_method="SHC"),
    "scf": dict(maxit=3, random_method="SCF"),
    "eman2": dict(maxit=3, ring_scheme="eman2"),
    "ctf": dict(maxit=3, CTF=True, snr=2.0),
}


def _ctf_params(seed=0):
    """Per-particle defocus, astigmatism and the microscope's scalars."""
    rng = np.random.default_rng(seed)
    dfu = rng.uniform(8000.0, 25000.0, N)
    return dict(dfu=dfu, dfv=dfu + rng.uniform(-400.0, 400.0, N),
                dfang=rng.uniform(0.0, 180.0, N), apix=1.7, voltage=200.0,
                cs=2.0, w=0.07)


def _stack(mirror=True, seed=3):
    tmpl = asymmetric_templates(1, NX)
    return scattered_stack(tmpl, N, max_shift=1, noise=0.05, seed=seed,
                           mirror=mirror)[0].numpy()


def _run_both(imgs, tmp_path, **kw):
    kw = dict(ou=OU, xr=XR, ts=1.0, **kw)
    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "port")
    want = ali2d_base_tpu(imgs, outdir=d_jax, sampler="gather", **kw)
    got = ali2d_base(imgs, outdir=d_port, device="cpu", **kw)
    return got, want, d_port, d_jax


def _assert_params_match(got, want):
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    d = np.abs(got[:, 0] - want[:, 0])
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], atol=1e-3)


def _assert_results_match(got, want):
    _assert_params_match(got.params, want.params)
    assert got.iterations == want.iterations
    for f in ("criteria", "mirror_consistency"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(got.pixel_errors, want.pixel_errors,
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.average, want.average, rtol=0,
                               atol=1e-4 * np.abs(want.average).max())


def _assert_outputs_match(d_port, d_jax):
    files = set(os.listdir(d_jax))
    assert set(os.listdir(d_port)) == files
    assert {"aqc.hdf", "aqf.hdf", "aqfinal.hdf", "resolution001",
            "initial2Dparams.txt", "logfile.txt", "checkpoint.npz"} <= files
    for name in sorted(files):
        a, b = os.path.join(d_port, name), os.path.join(d_jax, name)
        if name.endswith(".hdf"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                ga, gb = fa["MDF/images"], fb["MDF/images"]
                assert ga.attrs["imageid_max"] == gb.attrs["imageid_max"]
                assert set(ga) == set(gb)
                for key in gb:
                    want = gb[key]["image"][()]
                    np.testing.assert_allclose(
                        ga[key]["image"][()], want, rtol=0,
                        atol=1e-4 * np.abs(want).max(), err_msg=name)
        elif name == "checkpoint.npz":
            za, zb = np.load(a), np.load(b)
            assert set(za.files) == set(zb.files)
            for key in ("iteration", "mirror", "ref_id"):
                np.testing.assert_array_equal(za[key], zb[key])
        elif name == "logfile.txt":
            def body(path):
                with open(path) as f:
                    return [line.split(" :: ", 1)[1].split()[0]
                            for line in f]
            assert body(a) == body(b)
        else:
            ta, tb = np.loadtxt(a), np.loadtxt(b)
            if name.startswith("resolution"):
                ta[0, 1] = tb[0, 1] = 0.0    # the zero-frequency shell
            np.testing.assert_allclose(ta, tb, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_reffree_matches_jax(tmp_path, case):
    kw = dict(CASES[case])
    if kw.get("CTF"):
        kw["ctf_params"] = _ctf_params()
    imgs = _stack(mirror=not kw.get("nomirror", False))
    got, want, d_port, d_jax = _run_both(imgs, tmp_path, **kw)
    _assert_results_match(got, want)
    _assert_outputs_match(d_port, d_jax)
    with open(os.path.join(d_port, "logfile.txt")) as f:
        log_text = f.read()
    assert ("SHC:" in log_text) == (case == "shc")
    assert ("CTF premultiplication on, snr=2" in log_text) == (case == "ctf")
    if case == "shc":
        ck = np.load(os.path.join(d_port, "checkpoint.npz"))
        np.testing.assert_allclose(
            ck["x_previousmax"],
            np.load(os.path.join(d_jax, "checkpoint.npz"))["x_previousmax"],
            rtol=1e-5)
    if case in ("mode_h", "mode_h_dst"):
        # half rings: rotations in [0, 180), +180 when mirrored
        alpha = got.params[:, 0]
        flipped = got.params[:, 3] == 1
        assert ((alpha[~flipped] > 179.0) | (alpha[~flipped] < 1e-3)).all()
    if case == "nomirror":
        assert (got.params[:, 3] == 0).all()
    if case == "dst":
        with open(os.path.join(d_port, "logfile.txt")) as f:
            text = f.read()
        assert "Discrete angle used" in text
        assert text.count("uses discrete angles") == 1
        assert got.iterations == 11
    if case == "maxit0":
        assert 1 <= got.iterations <= 10


def test_reffree_resumes_a_jax_checkpoint(tmp_path):
    """Two iterations (by either package), then the port resumes to four:
    the same as a straight run of four."""
    imgs = _stack(seed=5)
    kw = dict(ou=OU, xr=XR, ts=1.0)
    straight = ali2d_base(imgs, outdir=str(tmp_path / "straight"), maxit=4,
                          device="cpu", log=RunLogger(None, quiet=True), **kw)
    for pkg in ("port", "jax"):
        d = str(tmp_path / pkg)
        if pkg == "port":
            ali2d_base(imgs, outdir=d, maxit=2, device="cpu",
                       log=RunLogger(None, quiet=True), **kw)
        else:
            ali2d_base_tpu(imgs, outdir=d, maxit=2, sampler="gather",
                           log=JaxLogger(None, quiet=True), **kw)
        resumed = ali2d_base(imgs, outdir=d, maxit=4, resume=True,
                             device="cpu", log=RunLogger(None, quiet=True),
                             **kw)
        assert resumed.iterations == 4
        _assert_params_match(resumed.params, straight.params)
        np.testing.assert_allclose(
            resumed.average, straight.average, rtol=0,
            atol=1e-4 * np.abs(straight.average).max())
        np.testing.assert_allclose(resumed.criteria, straight.criteria[2:],
                                   rtol=1e-5)


@pytest.mark.parametrize("start", [0, 1])
def test_even_odd_sums_are_the_jax_numpy_sums(monkeypatch, start):
    """Iteration 0's even/odd sums equal the JAX driver's numpy sums
    (``data[0::2].sum(0)``, added in stack order in f32) bit for bit, by
    blocks of any size and from an odd first global index.  At this
    count torch's own ``sum(0)`` adds in another order: it differs from
    numpy's at 87% of the pixels, by up to 9.2e-5 (measured), and f64
    sums rounded once at 88%, by up to 1.1e-4."""
    from cryo_ralib_tpu_torch.models import reffree
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((300, 24, 24))
            * rng.uniform(0.1, 10.0, (300, 1, 1))).astype(np.float32)
    for block in (7, 64, 2048):
        monkeypatch.setattr(reffree, "PREP_BLOCK", block)
        got = reffree._even_odd_sums(data, "cpu", start=start)
        first = data[start % 2::2].sum(0)
        second = data[1 - start % 2::2].sum(0)
        np.testing.assert_array_equal(got[0, 0], first)
        np.testing.assert_array_equal(got[0, 1], second)
