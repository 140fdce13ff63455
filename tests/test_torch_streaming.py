"""The port's streaming mode on the CPU: the batch planner, the engine
streamed against itself resident and against the JAX engine streamed
(``sampler="gather"``, as tests/test_streaming.py runs it), the drivers
and the command line streamed, the blocked end of a step, a streamed
resume, and the profiling helpers.

Tolerances (those of tests/test_streaming.py): counts, ref_id and mirror
exactly equal; class sums within 5e-4 of their largest value (blocks add
up in another order than one product); angles within 1e-3 degree (SCF
against JAX 2e-2, as tests/test_torch_scf.py); shifts within 1e-5 between
the port's two modes and 1e-3 against JAX; the drivers' params within
1e-3 (the parity bar of BASELINE.json).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import cryo_ralib_tpu.ops.fourvar as jfourvar
from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import ali2d_base_tpu, mref_ali2d_tpu
from cryo_ralib_tpu.models.engine import AlignmentEngine as JaxEngine
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu.utils.synthetic import asymmetric_templates
from cryo_ralib_tpu_torch.cli import mref as port_mref
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf
from cryo_ralib_tpu_torch.io.mrc import write_mrc
from cryo_ralib_tpu_torch.models import ali2d_base
from cryo_ralib_tpu_torch.models import steps
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.ops import classavg
from cryo_ralib_tpu_torch.parallel import batching
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.utils import profiling
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

NX, K, N, BATCH = 64, 3, 22, 8
HEADLINE = dict(img_dim=90, ring_num=36, ring_len=256, shift_step=1.0,
                shift_rng_x=3.0, shift_rng_y=3.0)


def _quiet():
    return dict(log=RunLogger(None, quiet=True))


# ---- the planner

@pytest.mark.parametrize("sampler,method", [("kernel", ""), ("plain", ""),
                                            ("plain", "SHC"),
                                            ("kernel", "SCF")])
def test_plan_batch_size_monotone_and_fits(sampler, method):
    cfg = AlignConfig(**HEADLINE)
    route = steps.resolve_route(sampler, "cuda", cfg, method, n_refs=8)
    assert route.search == sampler
    sizes = [batching.plan_batch_size(10 ** 6, route, cfg,
                                      limit_bytes=g * 2**30)
             for g in (2, 8, 32)]
    assert 1 <= sizes[0] <= sizes[1] <= sizes[2] < 10 ** 6
    for g, b in zip((2, 8, 32), sizes):
        fp = batching.step_footprint(b, route, cfg, streamed=True)
        assert b == 1 or fp.total <= 0.8 * g * 2**30
        # a power of two, and the next one would not fit
        assert b & (b - 1) == 0
        assert (batching.step_footprint(2 * b, route, cfg,
                                        streamed=True).total
                > 0.8 * g * 2**30)
    # a tiny stack is resident; without a limit on the CPU, any stack is
    assert batching.plan_batch_size(64, route, cfg,
                                    limit_bytes=2 * 2**30) == 64
    assert batching.plan_batch_size(10 ** 6, route, cfg,
                                    device="cpu") == 10 ** 6
    assert batching.device_memory_bytes("cpu") is None


def test_footprint_counts_what_the_port_allocates():
    """The transform block is fixed past its size, the plain search's
    samples are charged, streaming charges the second buffer."""
    cfg = AlignConfig(**HEADLINE)
    kernel = steps.resolve_route("auto", "cuda", cfg, n_refs=8)
    a = batching.step_footprint(16384, kernel, cfg)
    b = batching.step_footprint(32768, kernel, cfg)
    assert a.transform == b.transform > 0
    assert b.images == 2 * a.images
    assert (batching.step_footprint(16384, kernel, cfg, streamed=True).images
            == 2 * a.images)
    plain = batching.step_footprint(
        16384, steps.resolve_route("auto", "cpu", cfg, n_refs=8), cfg)
    assert plain.search > 10 * a.search
    # at 16384 x 90 px the model charges the images and the transform
    # block (2048 particles) and stays under 6 GiB
    assert a.total < 6 * 2**30


# ---- the engine: streamed, resident, and the JAX engine streamed

def _data(k=K, seed=7):
    tmpl = asymmetric_templates(k, NX)
    imgs = np.asarray(scattered_stack(tmpl, N, max_shift=1, noise=0.05,
                                      seed=seed)[0], np.float32)
    return imgs, tmpl


ENGINE_CASES = {
    "standard": dict(k=K, geom={}, kw={}, discrete=False),
    "dst": dict(k=K, geom={}, kw=dict(delta=45.0), discrete=True),
    "shc": dict(k=K, geom={}, kw=dict(random_method="SHC"), discrete=False),
    "scf": dict(k=1, geom=dict(mode="H"), kw=dict(random_method="SCF"),
                discrete=False),
}


def _run_engine(make, refs, discrete, iters=2):
    eng = make()
    outs = [eng.iterate(refs, discrete=discrete and i == 0)
            for i in range(iters)]
    return eng, outs


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_streamed_equals_resident_and_jax(case):
    c = ENGINE_CASES[case]
    imgs, tmpl = _data(c["k"])
    geom = dict(img_dim=NX, ring_num=20, ring_len=256, shift_step=1.0,
                shift_rng_x=1.0, shift_rng_y=1.0, **c["geom"])
    cfg, jcfg = AlignConfig(**geom), JaxConfig(**geom)
    refs = tmpl if c["k"] > 1 else imgs.mean(0)[None]
    runs = {}
    for name, bs in (("resident", None), ("streamed", BATCH)):
        runs[name] = _run_engine(lambda: AlignmentEngine(
            imgs, cfg, n_classes=c["k"], device="cpu", batch_size=bs,
            **c["kw"]), refs, c["discrete"])
    runs["jax"] = _run_engine(lambda: JaxEngine(
        imgs, jcfg, n_classes=c["k"], sampler="gather", batch_size=BATCH,
        **c["kw"]), refs, c["discrete"])
    assert runs["resident"][0].resident
    assert not runs["streamed"][0].resident
    assert runs["streamed"][0].batch == runs["jax"][0].batch == BATCH
    eng_s, outs_s = runs["streamed"]
    # SCF's refined angle is ill-conditioned: a rounding-level change of
    # the second iteration's reference moves it by up to ~1e-2 degree
    ang_tol = 2e-2 if case == "scf" else 1e-3
    for other, shift_tol in (("resident", 1e-5), ("jax", 1e-3)):
        eng_o, outs_o = runs[other]
        for o_s, o_o in zip(outs_s, outs_o):
            np.testing.assert_array_equal(o_s.counts, o_o.counts)
            np.testing.assert_allclose(
                o_s.class_sums, o_o.class_sums, rtol=0,
                atol=5e-4 * np.abs(o_o.class_sums).max())
            np.testing.assert_allclose(o_s.sx_sum, o_o.sx_sum, atol=1e-2)
            np.testing.assert_allclose(o_s.sy_sum, o_o.sy_sum, atol=1e-2)
            assert o_s.nope == o_o.nope
        p_s, p_o = eng_s.params_np(), eng_o.params_np()
        np.testing.assert_array_equal(p_s.ref_id, np.asarray(p_o.ref_id))
        np.testing.assert_array_equal(p_s.mirror, np.asarray(p_o.mirror))
        d = np.abs(p_s.angle - np.asarray(p_o.angle))
        assert np.minimum(d, 360.0 - d).max() < ang_tol
        np.testing.assert_allclose(p_s.shift_x, np.asarray(p_o.shift_x),
                                   atol=shift_tol)
        np.testing.assert_allclose(p_s.shift_y, np.asarray(p_o.shift_y),
                                   atol=shift_tol)
        if case == "shc":
            np.testing.assert_allclose(eng_s.previousmax_np(),
                                       eng_o.previousmax_np(), rtol=1e-4)


def test_engine_state_round_trips_in_both_modes():
    imgs, tmpl = _data()
    cfg = AlignConfig(img_dim=NX, ring_num=20, shift_rng_x=1.0,
                      shift_rng_y=1.0)
    rng = np.random.default_rng(3)
    p = AlignParams(rng.uniform(0, 360, N).astype(np.float32),
                    rng.normal(size=N).astype(np.float32),
                    rng.normal(size=N).astype(np.float32),
                    rng.integers(0, 2, N).astype(np.int32),
                    rng.integers(0, K, N).astype(np.int32))
    pm = rng.uniform(1, 2, N).astype(np.float32)
    for bs in (None, BATCH):
        eng = AlignmentEngine(imgs, cfg, n_classes=K, device="cpu",
                              batch_size=bs, random_method="SHC")
        eng.set_params(p)
        eng.set_previousmax(pm)
        for got, want in zip(eng.params_np(), p):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(eng.previousmax_np(), pm)
        eng.set_ref_id(np.zeros(N, np.int32))
        assert (eng.params_np().ref_id == 0).all()


@pytest.mark.parametrize("block", [1, 5, N])
def test_finish_step_blocks_equal_one_block(block, monkeypatch):
    imgs, _ = _data()
    rng = np.random.default_rng(block)
    params = AlignParams(
        torch.as_tensor(rng.uniform(0, 360, N).astype(np.float32)),
        torch.as_tensor(rng.uniform(-1, 1, N).astype(np.float32)),
        torch.as_tensor(rng.uniform(-1, 1, N).astype(np.float32)),
        torch.as_tensor(rng.integers(0, 2, N).astype(np.int32)),
        torch.as_tensor(rng.integers(0, K, N).astype(np.int32)))
    x = torch.as_tensor(imgs)
    gidx = torch.arange(N) + 3     # an odd offset: parity from the index
    peak = torch.as_tensor(rng.normal(size=N).astype(np.float32))
    # the blocks of _finish_step's plain route (a CPU tensor)
    monkeypatch.setattr(classavg, "transform_block", lambda h, w: 10 ** 6)
    want = steps._finish_step(x, params, peak, gidx, None, K, "plain")
    monkeypatch.setattr(classavg, "transform_block", lambda h, w: block)
    got = steps._finish_step(x, params, peak, gidx, None, K, "plain")
    np.testing.assert_array_equal(got.counts.numpy(), want.counts.numpy())
    sums = want.class_sums.numpy()
    np.testing.assert_allclose(got.class_sums.numpy(), sums, rtol=0,
                               atol=5e-4 * np.abs(sums).max())
    assert float(got.sx_sum) == float(want.sx_sum)
    # the parity split follows the global index
    odd = (gidx.numpy() % 2 == 1) & (params.ref_id.numpy() == 0)
    assert np.abs(sums[0, 1]).sum() > 0 and odd.any()


# ---- the drivers

def _mref_stack(seed=11):
    tmpl = asymmetric_templates(K, 48)
    imgs = np.asarray(scattered_stack(tmpl, 18, max_shift=1, noise=0.05,
                                      seed=seed)[0], np.float32)
    return imgs, tmpl


MREF_KW = dict(ou=16, xr=1, yr=1, ts=1, maxit=2,
               user_func_name="ref_ali2d_no_filter")


def _assert_tables_match(got, want, tol=1e-3):
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    d = np.abs(got[:, 0] - want[:, 0])
    assert np.minimum(d, 360.0 - d).max() < tol
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], atol=tol)


def test_mref_streamed_equals_resident_and_jax():
    imgs, tmpl = _mref_stack()
    res_r = mref_ali2d(imgs, tmpl.copy(), device="cpu", **MREF_KW, **_quiet())
    res_s = mref_ali2d(imgs, tmpl.copy(), device="cpu", batch_size=BATCH,
                       **MREF_KW, **_quiet())
    res_j = mref_ali2d_tpu(imgs, tmpl.copy(), sampler="gather",
                           batch_size=BATCH, log=JaxLogger(None, quiet=True),
                           **MREF_KW)
    for other in (res_r, res_j):
        np.testing.assert_array_equal(res_s.assignments, other.assignments)
        np.testing.assert_array_equal(res_s.class_counts, other.class_counts)
        _assert_tables_match(res_s.params, other.params)
        np.testing.assert_allclose(res_s.references, other.references,
                                   rtol=0, atol=1e-4
                                   * np.abs(other.references).max())


def _reffree_stack(n=14, seed=3):
    tmpl = asymmetric_templates(1, 48)
    return np.asarray(scattered_stack(tmpl, n, max_shift=1, noise=0.05,
                                      seed=seed)[0], np.float32)


def _ctf_params(n, seed=0):
    rng = np.random.default_rng(seed)
    dfu = rng.uniform(8000.0, 25000.0, n)
    return dict(dfu=dfu, dfv=dfu + rng.uniform(-400.0, 400.0, n),
                dfang=rng.uniform(0.0, 180.0, n), apix=1.7, voltage=200.0,
                cs=2.0, w=0.07)


@pytest.mark.parametrize("ctf", [False, True], ids=["plain", "ctf"])
def test_reffree_streamed_equals_resident_and_jax(ctf):
    imgs = _reffree_stack()
    kw = dict(ou=16, xr=1.0, ts=1.0, maxit=3)
    if ctf:
        kw.update(CTF=True, snr=2.0, ctf_params=_ctf_params(len(imgs)))
    res_r = ali2d_base(imgs, device="cpu", **kw, **_quiet())
    res_s = ali2d_base(imgs, device="cpu", batch_size=BATCH, **kw,
                       **_quiet())
    res_j = ali2d_base_tpu(imgs, sampler="gather", batch_size=BATCH,
                           log=JaxLogger(None, quiet=True), **kw)
    for other in (res_r, res_j):
        _assert_tables_match(res_s.params, other.params)
        np.testing.assert_allclose(res_s.criteria, other.criteria,
                                   rtol=1e-5)
        np.testing.assert_allclose(res_s.average, other.average, rtol=0,
                                   atol=1e-4 * np.abs(other.average).max())


def test_reffree_fourvar_streamed(tmp_path, monkeypatch):
    """``Fourvar`` from a one-iteration start (tests/test_torch_fourvar.py):
    streamed equals resident, and the JAX driver streamed, both packages
    with their exact variance engine (the shear engine is held in
    tests/test_torch_fourvar.py)."""
    exact = jfourvar.fourier_variance
    monkeypatch.setattr(
        jfourvar, "fourier_variance",
        lambda data, params, mask=None: exact(data, params, mask=mask,
                                              engine="exact"))
    from cryo_ralib_tpu_torch.models import reffree as port_reffree

    port_shear = port_reffree.fourier_variance
    monkeypatch.setattr(
        port_reffree, "fourier_variance",
        lambda data, params, mask=None, mesh=None: port_shear(
            data, params, mask=mask, mesh=mesh, engine="exact"))
    imgs = _reffree_stack()
    kw = dict(ou=16, xr=1.0, ts=1.0)
    res = {}
    for name in ("resident", "streamed", "jax"):
        d = str(tmp_path / name)
        for more in (dict(maxit=1), dict(maxit=3, resume=True, Fourvar=True)):
            if name == "jax":
                res[name] = ali2d_base_tpu(
                    imgs, outdir=d, sampler="gather", batch_size=BATCH,
                    log=JaxLogger(None, quiet=True), **kw, **more)
            else:
                res[name] = ali2d_base(
                    imgs, outdir=d, device="cpu",
                    batch_size=BATCH if name == "streamed" else None,
                    **kw, **more, **_quiet())
    got = res["streamed"]
    for other, rel in ((res["resident"], 1e-4), (res["jax"], 2e-3)):
        np.testing.assert_array_equal(got.params[:, 3], other.params[:, 3])
        for g, w in zip(got.radial_variances, other.radial_variances):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=rel * np.abs(w).max())
    # the variance divides the average, which makes the run as sensitive
    # to the class sums' rounding as tests/test_torch_fourvar.py finds it
    # to the two packages' differences: its bars hold
    d = np.abs(got.params[:, 0] - res["resident"].params[:, 0])
    assert np.minimum(d, 360.0 - d).max() < 0.5
    np.testing.assert_allclose(got.params[:, 1:3],
                               res["resident"].params[:, 1:3], atol=0.05)
    np.testing.assert_allclose(got.criteria, res["resident"].criteria,
                               rtol=0.03)


def test_streamed_resume_equals_resident_resume(tmp_path):
    imgs, tmpl = _mref_stack()
    kw = dict(MREF_KW, maxit=1)
    res = {}
    for name, bs in (("resident", None), ("streamed", BATCH)):
        d = str(tmp_path / name)
        mref_ali2d(imgs, tmpl.copy(), outdir=d, device="cpu", **kw,
                   **_quiet())
        res[name] = mref_ali2d(imgs, tmpl.copy(), outdir=d, device="cpu",
                               batch_size=bs, resume=True,
                               **dict(kw, maxit=3), **_quiet())
    np.testing.assert_array_equal(res["streamed"].assignments,
                                  res["resident"].assignments)
    _assert_tables_match(res["streamed"].params, res["resident"].params)


def test_cli_mref_streams_under_a_small_limit(tmp_path, monkeypatch, capsys):
    """With the planner's limit patched small, ``cli.mref`` streams (its
    log says so) and writes the files of a resident run."""
    imgs, tmpl = _mref_stack()
    stack, refs = str(tmp_path / "stack.mrcs"), str(tmp_path / "refs.mrcs")
    write_mrc(stack, imgs)
    write_mrc(refs, tmpl)
    argv = ["--ou=16", "--xr=1", "--ts=1", "--maxit=2"]
    d_r, d_s = str(tmp_path / "resident"), str(tmp_path / "streamed")
    assert port_mref.main([stack, refs, d_r, *argv], device="cpu") == 0
    capsys.readouterr()
    cfg = AlignConfig(img_dim=48, ring_num=16, shift_rng_x=1.0,
                      shift_rng_y=1.0)
    fits = batching.step_footprint(
        BATCH, steps.resolve_route("auto", "cpu", cfg, n_refs=K), cfg,
        streamed=True).total
    monkeypatch.setattr(batching, "device_memory_bytes",
                        lambda device=None: int(fits / 0.8) + 1)
    assert port_mref.main([stack, refs, d_s, *argv], device="cpu") == 0
    text = capsys.readouterr().out
    assert "batch plan: 18 particles streamed in batches of 8" in text
    assert "streaming 18 particles in batches of 8" in text
    names = set(os.listdir(d_r))
    assert set(os.listdir(d_s)) == names
    for name in sorted(names):
        a, b = os.path.join(d_r, name), os.path.join(d_s, name)
        if name.endswith(".hdf"):
            (ia, ha), (ib, hb) = read_own_hdf(a), read_own_hdf(b)
            np.testing.assert_allclose(ib, ia, rtol=0,
                                       atol=1e-4 * np.abs(ia).max())
            assert ([(h["ave_n"], h["members"]) for h in hb]
                    == [(h["ave_n"], h["members"]) for h in ha])
        elif name.endswith(".txt") and name != "logfile.txt":
            np.testing.assert_allclose(np.loadtxt(b), np.loadtxt(a),
                                       rtol=0, atol=1e-3)


# ---- profiling

def test_profiling_helpers_on_the_cpu(tmp_path):
    # no profile: a job and its spans are the shared null context
    assert profiling.job() is profiling.span("engine.step", "cpu")
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.job(driver="test") as job:
            for i in range(2):
                with profiling.span("engine.step", "cpu", start=i) as s:
                    torch.ones(64, 64) @ torch.ones(64, 64)
            job.set(n=2)
        # a span outside the recorded job is not recorded
        with profiling.span("engine.step", "cpu"):
            pass
    spans = profiling.last_job()
    assert [s.name for s in spans] == ["job", "engine.step", "engine.step"]
    assert spans[0].attrs == {"driver": "test", "n": 2}
    assert [s.attrs["start"] for s in spans[1:]] == [0, 1]
    assert {s.parent for s in spans[1:]} == {spans[0].id}
    assert s.device_ms() == s.host_ms > 0
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
