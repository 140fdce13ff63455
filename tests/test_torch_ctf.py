"""CTF-aware alignment in the port (``ops/ctf_ops.py``,
``cli/common.py::load_ctf_params``) against the JAX package on the CPU.
``mref_ali2d`` and ``ali2d_base`` with ``CTF=True`` are held end to end in
tests/test_torch_mref.py and tests/test_torch_reffree.py.

Tolerances.  The CTF's phase argument reaches ~270 rad at these
parameters (defocus to 2.5 um, 1.7 A/px, 200 kV), where one f32 ulp is
3e-5, so an f32 CTF of either package is good to a few ulp of that:
``CtfContext``'s f32 CTFs agree with JAX's f32 ones within 2e-4
(measured 5.6e-5: the same operations in the same order, but XLA
contracts multiply-adds and the two sin/cos differ), and an f64
evaluation is as far from JAX's (measured 5.4e-5), so nothing is gained
by f64 against this reference.  ``ctf_rfft2`` (f64 in both packages)
agrees within 1e-6.  Premultiplied images, ctf^2 sums and
Wiener-restored averages agree within 1e-4 of their largest value.
"""

import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu.analysis.ctf import compute_ctf as jax_compute_ctf
from cryo_ralib_tpu.cli.common import load_ctf_params as jax_load_ctf_params
from cryo_ralib_tpu.ops import ctf_ops as jctf
from cryo_ralib_tpu_torch.cli.common import load_ctf_params
from cryo_ralib_tpu_torch.ops import ctf_ops

NX, N, K = 48, 13, 3


def _ctf_params(n=N, seed=0, **kw):
    rng = np.random.default_rng(seed)
    dfu = rng.uniform(8000.0, 25000.0, n)
    p = dict(dfu=dfu, dfv=dfu + rng.uniform(-400.0, 400.0, n),
             dfang=rng.uniform(0.0, 180.0, n), apix=1.7, voltage=200.0,
             cs=2.0, w=0.07)
    p.update(kw)
    return p


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_rfft2_freqs_equal_jax():
    for nx, apix in ((48, 1.0), (45, 1.7)):
        np.testing.assert_array_equal(ctf_ops.rfft2_freqs(nx, apix),
                                      jctf.rfft2_freqs(nx, apix))


@pytest.mark.parametrize("per_particle,bfactor,phase", [
    (False, None, 0.0), (True, None, 0.0), (True, 80.0, 0.0),
    (True, None, "per_particle")])
def test_compute_ctf_matches_jax_in_f64(per_particle, bfactor, phase):
    """The tensor copy of ``analysis/ctf.py::compute_ctf`` against the
    numpy original, both f64: within 1e-9."""
    p = _ctf_params()
    freqs = ctf_ops.rfft2_freqs(NX, p["apix"]).reshape(-1, 2)
    if phase == "per_particle":
        phase = np.linspace(0.0, 90.0, N)
    df = ((p["dfu"], p["dfv"], p["dfang"]) if per_particle
          else (p["dfu"][0], p["dfv"][0], p["dfang"][0]))
    want = jax_compute_ctf(freqs, *df, p["voltage"], p["cs"], p["w"],
                           phase_shift=phase, bfactor=bfactor)
    got = ctf_ops.compute_ctf(torch.as_tensor(freqs), *df, p["voltage"],
                              p["cs"], p["w"], phase_shift=phase,
                              bfactor=bfactor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def test_ctf_rfft2_matches_jax():
    p = _ctf_params()
    want = jctf.ctf_rfft2(NX, p["apix"], p["dfu"], p["dfv"], p["dfang"],
                          p["voltage"], p["cs"], p["w"])
    got = ctf_ops.ctf_rfft2(NX, p["apix"], p["dfu"], p["dfv"], p["dfang"],
                            p["voltage"], p["cs"], p["w"])
    assert got.dtype == torch.float32 and got.shape == (N, NX, NX // 2 + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    one = ctf_ops.ctf_rfft2(NX, p["apix"], 12000.0, 11000.0, 30.0)
    np.testing.assert_allclose(
        one.numpy(), jctf.ctf_rfft2(NX, p["apix"], 12000.0, 11000.0, 30.0),
        rtol=0, atol=1e-6)


def test_context_ctf_is_f32_like_jax():
    """``CtfContext`` evaluates the CTF in f32 in JAX's order: it agrees
    with JAX's chunk CTFs within 2e-4 (a few f32 ulp of the ~270 rad
    phase), and so does an f64 evaluation."""
    p = _ctf_params(phase_shift=np.linspace(0.0, 60.0, N))
    jctx = jctf.CtfContext(NX, p, batch=5)
    want = np.concatenate([np.asarray(jctx._ctf_chunk(jnp.asarray(df)))[:rows]
                           for _i, rows, df in jctx._chunks()])
    ctx = ctf_ops.CtfContext(NX, p, batch=5)
    got = torch.cat([ctx.ctf_chunk(i) for i in range(0, N, 5)]).numpy()
    assert got.shape == want.shape == (N, NX, NX // 2 + 1)
    err32 = np.abs(got - want).max()
    f64 = ctf_ops.ctf_rfft2(NX, p["apix"], p["dfu"], p["dfv"], p["dfang"],
                            p["voltage"], p["cs"], p["w"],
                            phase_shift=p["phase_shift"]).numpy()
    err64 = np.abs(f64 - want).max()
    assert ctx.ctf_chunk(0).dtype == torch.float32
    assert err32 < 2e-4 and err64 < 2e-4, (err32, err64)


def test_filt_ctf_and_wiener_match_jax():
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((N, NX, NX)).astype(np.float32)
    p = _ctf_params()
    ctf = jctf.ctf_rfft2(NX, p["apix"], p["dfu"], p["dfv"], p["dfang"])
    _close(ctf_ops.filt_ctf(torch.as_tensor(imgs), torch.as_tensor(ctf)),
           jctf.filt_ctf(jnp.asarray(imgs), jnp.asarray(ctf)), 1e-5)
    # class ids K..: padding, adds nothing (and -1 likewise)
    rid = rng.integers(0, K, N).astype(np.int32)
    rid[-2:] = K
    want = np.asarray(jctf.class_ctf2_sum(jnp.asarray(ctf), jnp.asarray(rid),
                                          K))
    got = ctf_ops.class_ctf2_sum(torch.as_tensor(ctf), torch.as_tensor(rid),
                                 K)
    _close(got, want, 1e-5)
    direct = sum(ctf[i] ** 2 for i in range(N) if rid[i] == 1)
    _close(got[1], direct, 1e-5)
    summed = rng.standard_normal((K, NX, NX)).astype(np.float32)
    _close(ctf_ops.wiener_restore(torch.as_tensor(summed), got, 2.5),
           jctf.wiener_restore(jnp.asarray(summed), jnp.asarray(want), 2.5),
           1e-5)


@pytest.mark.parametrize("batch", [4, 2048])
def test_context_premultiply_and_restore_match_jax(batch):
    """Chunked (the last chunk short) and unchunked; the port keeps the
    premultiplied stack as a tensor on its device."""
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((N, NX, NX)).astype(np.float32)
    p = _ctf_params(phase_shift=20.0, bfactor=50.0)
    jctx = jctf.CtfContext(NX, p, snr=3.0, batch=batch)
    ctx = ctf_ops.CtfContext(NX, p, snr=3.0, batch=batch)
    pre = ctx.premultiply(imgs)
    assert torch.is_tensor(pre) and pre.device.type == "cpu"
    _close(pre, jctx.premultiply(imgs), 1e-4)
    summed = rng.standard_normal((K, NX, NX)).astype(np.float32)
    assign = rng.integers(0, K, N)
    _close(ctx.restore(summed, assign), jctx.restore(summed, assign), 1e-4)
    _close(ctx.restore(summed[:1]), jctx.restore(summed[:1]), 1e-4)
    with pytest.raises(ValueError, match="images vs"):
        ctx.premultiply(imgs[:-1])
    with pytest.raises(ValueError, match="unknown ctf_params"):
        ctf_ops.CtfContext(NX, dict(p, defocus=1.0))


def _args(path, **kw):
    base = dict(CTF=True, ctf_file=str(path), apix=None, voltage=300.0,
                Cs=2.7, ac=0.1, snr=1.0)
    base.update(kw)
    return argparse.Namespace(**base)


STAR_FULL = (
    "# a comment\n\ndata_\n\nloop_\n_rlnImageName #1\n_rlnDefocusU #2\n"
    "_rlnDefocusV #3\n_rlnDefocusAngle #4\n_rlnVoltage #5\n"
    "_rlnSphericalAberration #6\n_rlnAmplitudeContrast #7\n"
    "_rlnPhaseShift #8\n_rlnDetectorPixelSize #9\n_rlnMagnification #10\n"
    "1@a.mrcs 12000.0 11800.0 35.0 200.0 2.0 0.07 10.0 5.0 29411.76\n"
    "2@a.mrcs 15000.0 15100.0 80.0 200.0 2.0 0.07 45.0 5.0 29411.76\n")
STAR_DFU_ONLY = ("data_\n\nloop_\n_rlnDefocusU #1\n12000.0\n15000.0\n")


@pytest.mark.parametrize("name,text,apix", [
    ("full.star", STAR_FULL, None), ("full.star", STAR_FULL, 1.25),
    ("dfu.star", STAR_DFU_ONLY, None), ("one.txt", "12000\n15000\n", None),
    ("three.txt", "12000 11000 30\n15000 15500 60\n", 2.0)])
def test_load_ctf_params_equals_jax(tmp_path, name, text, apix):
    path = tmp_path / name
    path.write_text(text)
    args = _args(path, apix=apix)
    got, want = load_ctf_params(args, 2), jax_load_ctf_params(args, 2)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    assert load_ctf_params(_args(path, CTF=False), 2) is None


@pytest.mark.parametrize("case", ["no_file", "no_defocus", "count"])
def test_load_ctf_params_exits_nonzero(tmp_path, capsys, case):
    path = tmp_path / "p.star"
    path.write_text("data_\n\nloop_\n_rlnImageName #1\n"
                    "_rlnDetectorPixelSize #2\n1@a.mrcs 1.0\n2@a.mrcs 1.0\n"
                    if case == "no_defocus" else STAR_FULL)
    args = _args("" if case == "no_file" else path)
    with pytest.raises(SystemExit) as exc:
        load_ctf_params(args, 3 if case == "count" else 2)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert {"no_file": "--ctf_file", "no_defocus": "_rlnDefocusU",
            "count": "CTF rows"}[case] in err
