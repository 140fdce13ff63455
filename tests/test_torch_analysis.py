"""The port's analysis layer (``cryo_ralib_tpu_torch/analysis``) against
the JAX package's, on the CPU.

``ctf``, ``poses``, ``metrics`` and ``plots`` are numpy copies: equal
outputs on the inputs of tests/test_analysis.py.  ``reduction`` (MPCA,
TwoSDR) is a port on ``torch.einsum`` / ``torch.linalg.eigh``, run with
``device="cpu"``.  Eigenvectors are defined up to sign, so it is held on
data with a separated spectrum (a rank-3 signal with weights 8, 4, 2
plus unit-0.3 noise): means within 1e-5; each column's overlap with
JAX's, ``|diag(A_port^T A_jax)|``, at least 1 - 1e-3 for At, Bt and Gt;
factors within 1e-3 of the largest after the sign of each column is
aligned; captured energy within rtol 1e-4; iterations within one of
JAX's (the stop rule ``energy - prev < 1e-7`` is absolute, so f32
rounding could part them by one).  Measured here: overlaps within 5e-7
of 1, factors within 1.4e-6 of the largest, energy within 5e-7, and the
same iterations in both packages (3, 4 and 3).
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu.analysis import MPCA as JaxMPCA
from cryo_ralib_tpu.analysis import TwoSDR as JaxTwoSDR
from cryo_ralib_tpu.analysis import ctf as jctf
from cryo_ralib_tpu.analysis import metrics as jmetrics
from cryo_ralib_tpu.analysis import poses as jposes
from cryo_ralib_tpu.analysis import reduction as jreduction
from cryo_ralib_tpu.io.star import Table
from cryo_ralib_tpu_torch.analysis import (MPCA, TwoSDR, ctf, metrics,
                                           poses, reduction)


def test_ctf_copy_equals_jax(capsys):
    freqs = ctf.ctf_freqs(32, apix=1.2)
    np.testing.assert_array_equal(freqs, jctf.ctf_freqs(32, apix=1.2))
    args = (freqs, 15000.0, 14000.0, 30.0, 300.0, 2.7, 0.1)
    kw = dict(phase_shift=10.0, bfactor=50.0)
    np.testing.assert_array_equal(ctf.compute_ctf(*args, **kw),
                                  jctf.compute_ctf(*args, **kw))
    # per-particle defocus arrays and phase shifts
    dfu = np.array([15000.0, 20000.0])
    np.testing.assert_array_equal(
        ctf.compute_ctf(freqs, dfu, dfu - 500, np.array([0.0, 45.0]), 300.0,
                        2.7, 0.1, phase_shift=np.array([0.0, 90.0])),
        jctf.compute_ctf(freqs, dfu, dfu - 500, np.array([0.0, 45.0]),
                         300.0, 2.7, 0.1, phase_shift=np.array([0.0, 90.0])))
    row = [32, 1.2, 15000.0, 14000.0, 30.0, 300.0, 2.7, 0.1, 0.0]
    ctf.print_ctf_params(row)
    ours = capsys.readouterr().out
    jctf.print_ctf_params(row)
    assert ours == capsys.readouterr().out and "DefocusU" in ours


def test_poses_copy_equals_jax():
    a = np.array([0.0, 33.0, 120.0])
    b = np.array([10.0, 71.0, 45.0])
    y = np.array([5.0, -12.0, 240.0])
    for name in ("R_from_eman", "R_from_relion"):
        np.testing.assert_array_equal(getattr(poses, name)(a, b, y),
                                      getattr(jposes, name)(a, b, y))
        np.testing.assert_array_equal(getattr(poses, name)(33.0, 71.0, -12.0),
                                      getattr(jposes, name)(33.0, 71.0, -12.0))
    t = Table(["angle_psi", "shift_x", "shift_y", "class"],
              {"angle_psi": np.array([10.0, 20.0]),
               "shift_x": np.array([1.0, -1.0]),
               "shift_y": np.array([0.5, 2.0]),
               "class": np.array([0, 3])})
    for g, w in zip(poses.parse_pose_hdf(t), jposes.parse_pose_hdf(t)):
        np.testing.assert_array_equal(g, w)
    ts = Table(["_rlnAngleRot", "_rlnAngleTilt", "_rlnAnglePsi",
                "_rlnOriginX", "_rlnOriginY"],
               {"_rlnAngleRot": np.array(["10.0"], object),
                "_rlnAngleTilt": np.array(["20.0"], object),
                "_rlnAnglePsi": np.array(["30.0"], object),
                "_rlnOriginX": np.array(["1.5"], object),
                "_rlnOriginY": np.array(["-2.5"], object)})
    for g, w in zip(poses.parse_pose_star(ts), jposes.parse_pose_star(ts)):
        np.testing.assert_array_equal(g, w)


def test_metrics_copy_equals_jax():
    y_true = [0, 0, 1, 1, 2, 2, 2]
    y_pred = [0, 0, 1, 1, 1, 2, 0]
    np.testing.assert_array_equal(metrics.contingency_matrix(y_true, y_pred),
                                  jmetrics.contingency_matrix(y_true, y_pred))
    for name in ("purity_score", "c_purity_score"):
        assert (getattr(metrics, name)(y_true, y_pred)
                == getattr(jmetrics, name)(y_true, y_pred))
    m = np.arange(24.0).reshape(2, 3, 4)
    np.testing.assert_array_equal(metrics.matlab2py(m), jmetrics.matlab2py(m))


def test_plots_draw_under_agg():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cryo_ralib_tpu_torch.analysis import plots

    rng = np.random.default_rng(0)
    try:
        ax = plots.plot_by_cluster(rng.random(20), rng.random(20), 3,
                                   rng.integers(0, 3, 20))
        assert len(ax.collections) == 3
        fig = plots.plot_euler(rng.random((20, 3)) * 360, rng.random((20, 2)),
                               classes=rng.integers(0, 3, 20), plot_class=True)
        assert len(fig.axes) >= 3
        assert plots.plot_defocus(rng.random((20, 9))).axes
        assert plots.plot_ctf([16, 1.2, 15000.0, 14000.0, 30.0, 300.0, 2.7,
                               0.1, 0.0]).axes
        fig = plots.visualise_images(rng.random((5, 8, 8)), 4, 2,
                                     rng=np.random.default_rng(1))
        assert len(fig.axes) == 4
    finally:
        plt.close("all")


def _stack(n=80, p=14, q=12, seed=3):
    """A rank-3 signal with separated weights (8, 4, 2) plus noise."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((p, 3)))
    v, _ = np.linalg.qr(rng.standard_normal((q, 3)))
    coef = rng.standard_normal((n, 3)) * np.array([8.0, 4.0, 2.0])
    arr = np.einsum("nk,pk,qk->npq", coef, u, v)
    arr += 0.3 * rng.standard_normal((n, p, q))
    return arr.astype(np.float32)


def _assert_columns(got, want):
    """Each column spans the same direction as JAX's."""
    overlap = np.abs(np.diag(got.T @ want))
    np.testing.assert_allclose(overlap, 1.0, atol=1e-3)


def _assert_factors(got, want):
    """Factors equal after aligning the sign of each column."""
    sign = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * sign, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
    np.testing.assert_allclose((got ** 2).sum(), (want ** 2).sum(), rtol=1e-4)


def _port_and_jax(fn, jax_fn, arr, args, caplog, monkeypatch):
    """Both packages' results, and the iterations each ran: the port's
    from its log, JAX's from its eigensolves (two per iteration, plus
    TwoSDR's final one)."""
    calls = []
    top = jreduction._top_eigvecs
    monkeypatch.setattr(jreduction, "_top_eigvecs",
                        lambda S, k: calls.append(k) or top(S, k))
    with caplog.at_level(logging.INFO, logger=reduction.__name__):
        got = fn(arr, *args, device="cpu")
    want = jax_fn(arr, *args)
    port_it = [int(r.getMessage().rsplit(": ", 1)[1].split()[0])
               for r in caplog.records if r.name == reduction.__name__]
    jax_it = len(calls) // 2
    assert len(port_it) == 1 and abs(port_it[0] - jax_it) <= 1
    return got, want


@pytest.mark.parametrize("p0,q0", [(3, 3), (2, 3)])
def test_mpca_matches_jax(caplog, monkeypatch, p0, q0):
    (f, At, Bt, mY), (fj, Atj, Btj, mYj) = _port_and_jax(
        MPCA, JaxMPCA, _stack(), (p0, q0), caplog, monkeypatch)
    assert f.shape == (80, p0 * q0) and At.shape == (14, p0)
    assert all(isinstance(x, np.ndarray) for x in (f, At, Bt, mY))
    np.testing.assert_allclose(mY, mYj, atol=1e-5)
    _assert_columns(At, Atj)
    _assert_columns(Bt, Btj)
    _assert_factors(f, fj)


def test_twosdr_matches_jax(caplog, monkeypatch):
    (f, Gt, At, Bt, mY), (fj, Gtj, Atj, Btj, mYj) = _port_and_jax(
        TwoSDR, JaxTwoSDR, _stack(seed=4), (3, 3, 3), caplog, monkeypatch)
    assert f.shape == (80, 3) and Gt.shape == (9, 3)
    np.testing.assert_allclose(mY, mYj, atol=1e-5)
    _assert_columns(At, Atj)
    _assert_columns(Bt, Btj)
    # Gt's rows follow At's and Bt's column signs: align them first
    sa = np.sign(np.diag(At.T @ Atj))
    sb = np.sign(np.diag(Bt.T @ Btj))
    _assert_columns(np.kron(sa, sb)[:, None] * Gt, Gtj)
    _assert_factors(f, fj)


def test_reduction_defaults_to_cuda(monkeypatch):
    """Without ``device`` the reduction runs on the GPU: with no CUDA it
    raises naming CUDA, as the drivers do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = _stack(n=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        MPCA(arr, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoSDR(arr, 2, 2, 2)
