"""Mode H (half rings) and SHC (stochastic hill climbing) in the port
against the JAX package on the CPU: the searches, the steps, the engine's
rules and ``ali2d_base`` end to end.

Tolerances: winners (ref, shift index, mirror, angle bin) and SHC's
``found`` exactly equal; peak values and rows within 1e-5 of the largest
peak (f32 FFT against an f32 matmul DFT); decoded angles within 1e-3
degree, decoded shifts exactly equal; class sums within 1e-4 of their
largest value.  The SHC ``previousmax`` thresholds are kept 10% away from
any peak, so that f32 rounding cannot flip a strict comparison.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import ali2d_base_tpu
from cryo_ralib_tpu.models import steps as jsteps
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu.utils.synthetic import (asymmetric_templates,
                                            scattered_stack)
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import ali2d_base
from cryo_ralib_tpu_torch.models import steps
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.ops import fused_search, search
from cryo_ralib_tpu_torch.params import AlignParams, params_from_numpy
from cryo_ralib_tpu_torch.utils.log import RunLogger

NX, N = 48, 16
WINNERS = ("best_ref", "best_sidx", "best_mirror", "best_aidx")


def _cfgs(**kw):
    base = dict(img_dim=NX, ring_num=16, ring_len=256, shift_step=1.0,
                shift_rng_x=2.0, shift_rng_y=1.0)
    base.update(kw)
    return JaxConfig(**base), AlignConfig(**base)


def _case(k, seed, **kw):
    """Configs, particles, refs and accumulated shifts (integer and
    fractional) in both packages' types."""
    jcfg, cfg = _cfgs(**kw)
    refs = asymmetric_templates(k, NX)
    imgs = np.asarray(scattered_stack(refs, N, max_shift=2, noise=0.3,
                                      seed=seed)[0], np.float32)
    rng = np.random.default_rng(seed)
    sx = rng.choice([0.0, 1.0, -1.0, 0.5], N).astype(np.float32)
    z = np.zeros(N, np.float32)
    jp = JaxParams(jnp.asarray(z), jnp.asarray(sx), jnp.asarray(-sx),
                   jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32))
    return jcfg, cfg, refs, imgs, jp, params_from_numpy(jp.to_numpy())


def _assert_results_match(got, want, rows=None):
    rows = slice(None) if rows is None else rows
    for f in WINNERS:
        np.testing.assert_array_equal(getattr(got, f).numpy()[rows],
                                      np.asarray(getattr(want, f))[rows],
                                      err_msg=f)
    scale = np.abs(np.asarray(want.best_val)[rows]).max()
    for f in ("best_val", "best_row"):
        np.testing.assert_allclose(getattr(got, f).numpy()[rows],
                                   np.asarray(getattr(want, f))[rows],
                                   rtol=0, atol=1e-5 * scale, err_msg=f)


def _assert_params_match(got, want, atol_angle=1e-3):
    for f in ("ref_id", "mirror", "shift_x", "shift_y"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    d = np.abs(got.angle.numpy() - np.asarray(want.angle))
    assert np.minimum(d, 360.0 - d).max() < atol_angle


@pytest.mark.parametrize("k,mirror,delta", [(3, True, 0.0), (1, True, 0.0),
                                            (1, False, 0.0), (3, True, 15.0),
                                            (1, True, 45.0)])
def test_mode_h_search_matches_jax(k, mirror, delta):
    """The plain search on half rings (as tests/test_modes.py holds the
    JAX one), with the --dst mask built for the 180-degree span."""
    jcfg, cfg, refs, imgs, jp, tp = _case(k, 3, mode="H", mirror=mirror)
    assert cfg.angle_step == 180.0 / 256
    mask = (search.delta_angle_mask(256, delta, "H") if delta else None)
    if delta:
        np.testing.assert_array_equal(
            mask, jsearch.delta_angle_mask(256, delta, "H"))
    want = jsearch.rotational_shift_search(
        jnp.asarray(imgs), jsearch.prepare_ref_spectra(jnp.asarray(refs),
                                                       jcfg),
        jp, jcfg, angle_mask=None if mask is None else jnp.asarray(mask))
    got = search.rotational_shift_search(
        torch.as_tensor(imgs),
        search.prepare_ref_spectra(torch.as_tensor(refs), cfg), tp, cfg,
        angle_mask=mask)
    _assert_results_match(got, want)
    refine = mask is None
    p_got = search.decode_params(got, tp, cfg, refine=refine)
    p_want = jsearch.decode_params(want, jp, jcfg, refine=refine)
    _assert_params_match(p_got, p_want)
    # half rings: unmirrored angles in (180, 360], mirrored ones +180
    ang = p_got.angle.numpy()[p_got.mirror.numpy() == 0]
    assert ((ang > 180.0 - 1.0) & (ang <= 360.0 + 1e-3)).all()


@pytest.mark.parametrize("mode", ["F", "H"])
@pytest.mark.parametrize("thresholds,shift_chunk", [
    ("init", 8), ("mixed", 4), ("mixed", 15), ("high", 8)])
def test_shc_search_matches_jax(mode, thresholds, shift_chunk):
    """The SHC pick: the first candidate in priority order whose peak is
    strictly above ``previousmax``, whatever the port's shift chunk."""
    jcfg, cfg, refs, imgs, jp, tp = _case(3, 5, mode=mode)
    rfw_j = jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg)
    rfw = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    full = jsearch.rotational_shift_search(jnp.asarray(imgs), rfw_j, jp, jcfg)
    peak = np.asarray(full.best_val)
    factor = {"init": None, "high": np.full(N, 1.1),
              "mixed": np.random.default_rng(0).choice([0.5, 0.9, 1.1], N)
              }[thresholds]
    pm = (np.full(N, search.PREVIOUSMAX_INIT, np.float32) if factor is None
          else (peak * factor).astype(np.float32))
    want, found_j = jsearch.rotational_shift_search_shc(
        jnp.asarray(imgs), rfw_j, jp, jcfg, jnp.asarray(pm))
    got, found = search.rotational_shift_search_shc(
        torch.as_tensor(imgs), rfw, tp, cfg, torch.as_tensor(pm),
        shift_chunk=shift_chunk)
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_j))
    hit = found.numpy()
    assert hit.all() if thresholds == "init" else True
    assert not hit.any() if thresholds == "high" else True
    if thresholds == "mixed":
        assert hit.any() and not hit.all()
    if hit.any():
        _assert_results_match(got, want, rows=hit)
        # the pick beats previousmax and no earlier candidate does
        assert (got.best_val.numpy()[hit] > pm[hit]).all()


@pytest.mark.parametrize("with_valid", [False, True])
def test_align_step_shc_matches_jax(with_valid):
    jcfg, cfg, refs, imgs, jp, tp = _case(3, 7)
    peak = np.asarray(jsearch.rotational_shift_search(
        jnp.asarray(imgs), jsearch.prepare_ref_spectra(jnp.asarray(refs),
                                                       jcfg),
        jp, jcfg).best_val)
    pm = (peak * np.random.default_rng(1).choice([0.5, 1.1], N)
          ).astype(np.float32)
    valid = ((np.arange(N) < N - 3).astype(np.float32) if with_valid
             else None)
    gidx = np.arange(N, dtype=np.int32)
    want = jsteps.align_step_shc(
        jnp.asarray(imgs), jnp.asarray(refs), jp, jnp.asarray(gidx),
        None if valid is None else jnp.asarray(valid), jnp.asarray(pm), jcfg,
        n_classes=3, sampler="gather")
    got = steps.align_step_shc(
        torch.as_tensor(imgs), torch.as_tensor(refs), tp,
        torch.as_tensor(gidx),
        None if valid is None else torch.as_tensor(valid),
        torch.as_tensor(pm), cfg, n_classes=3)
    assert int(got.nope) == int(want.nope) > 0
    _assert_params_match(got.step.params, want.step.params)
    np.testing.assert_allclose(got.previousmax.numpy(),
                               np.asarray(want.previousmax),
                               rtol=0, atol=1e-5 * peak.max())
    np.testing.assert_array_equal(got.step.counts.numpy(),
                                  np.asarray(want.step.counts))
    sums = np.asarray(want.step.class_sums)
    np.testing.assert_allclose(got.step.class_sums.numpy(), sums, rtol=0,
                               atol=1e-4 * np.abs(sums).max())
    np.testing.assert_allclose(got.step.peak.numpy(),
                               np.asarray(want.step.peak), rtol=0,
                               atol=1e-5 * peak.max())
    # a particle with no improving candidate keeps params and previousmax
    kept = got.previousmax.numpy() == pm
    assert kept.sum() >= int(got.nope)
    np.testing.assert_array_equal(got.step.params.shift_x.numpy()[kept],
                                  tp.shift_x.numpy()[kept])


@pytest.mark.parametrize("n,want", [(16384, 1), (512, 8), (4096, 4),
                                    (8192, 2), (10**6, 1)])
def test_plain_shift_chunk_stays_inside_the_budget(n, want):
    """The shift chunk of a PyTorch search at the headline geometry: the
    most shifts whose samples fit the budget, at least one."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_rng_x=3.0,
                      shift_rng_y=3.0)
    got = search.plain_shift_chunk(n, cfg)
    assert got == want
    assert got == 1 or n * got * 36 * 256 <= search.PLAIN_SAMPLE_BUDGET


RESOLVE = [
    # sampler, device, ring_scheme, random_method -> search or error
    ("auto", "cpu", "cuda", "", "plain"),
    ("auto", "cuda", "cuda", "", "kernel"),
    ("kernel", "cuda", "cuda", "", "kernel"),
    ("plain", "cuda", "cuda", "", "plain"),
    ("auto", "cuda", "cuda", "SHC", "kernel"),
    ("plain", "cuda", "cuda", "SHC", "plain"),
    ("kernel", "cuda", "cuda", "SHC", "kernel"),
    ("auto", "cuda", "cuda", "SCF", "kernel"),
    ("auto", "cpu", "cuda", "SCF", "plain"),
    ("auto", "cuda", "eman2", "", "plain"),
    ("kernel", "cuda", "eman2", "", ValueError),
    ("kernel", "cpu", "eman2", "", ValueError),
    ("fused", "cuda", "cuda", "", ValueError),
    ("template", "cuda", "cuda", "", "template"),
    ("template", "cpu", "cuda", "", "template"),
    ("template", "cuda", "cuda", "SHC", "template"),
    ("template", "cuda", "eman2", "", "template"),
    ("template", "cuda", "cuda", "SCF", ValueError),
    ("auto", "cpu", "cuda", "SHC", "plain"),
    ("auto", "cuda", "eman2", "SHC", "plain"),
    ("kernel", "cuda", "eman2", "SHC", ValueError),
]


@pytest.mark.parametrize("sampler,device,scheme,method,want", RESOLVE)
def test_resolve_sampler_rules(sampler, device, scheme, method, want):
    """The explicit engine rule: the kernel where there is one (mode H,
    SCF's rotation stage and the SHC pick included), the PyTorch search
    on the CPU and for eman2 on either device, an error where the kernel
    is forced there, as JAX's ``sampler="fused"`` raises."""
    cfg = _cfgs(ring_scheme=scheme)[1]
    if want is ValueError:
        with pytest.raises(ValueError, match="sampler"):
            steps.resolve_route(sampler, device, cfg, method)
    else:
        route = steps.resolve_route(sampler, device, cfg, method)
        assert (route.search, route.method) == (want, method)
        # the sums go with the search and the device
        assert route.sums == ("shear" if want == "template" else
                              "kernel" if device == "cuda" else "plain")
        assert (route.plan is not None) == (want == "kernel"
                                             and device == "cuda")
        cfg_h = _cfgs(mode="H")[1]
        if scheme == "cuda":
            assert steps.resolve_route(sampler, device, cfg_h,
                                       method).search == want


ENGINE_ERRORS = [
    (dict(random_method="SHC", delta=15.0), {}, "delta"),
    (dict(random_method="SCF", delta=15.0), dict(mode="H"), "delta"),
    (dict(random_method="SHC", sampler="kernel"), dict(ring_len=128),
     "sampler='kernel'"),
    (dict(sampler="kernel"), dict(ring_scheme="eman2"), "sampler='kernel'"),
    (dict(random_method="SHC"), dict(ring_scheme="eman2"), "standard ring"),
    (dict(random_method="XYZ"), {}, "unsupported random_method"),
]


@pytest.mark.parametrize("kw,geom,match", ENGINE_ERRORS)
def test_engine_refuses_what_jax_refuses(kw, geom, match):
    """Combinations the JAX engine or steps refuse raise ``ValueError``
    when the port's engine is built."""
    data = np.zeros((4, NX, NX), np.float32)
    with pytest.raises(ValueError, match=match):
        AlignmentEngine(data, _cfgs(**geom)[1], n_classes=1, device="cpu",
                        **kw)


@pytest.mark.parametrize("sampler,want", [("auto", "plain"),
                                           ("kernel", ValueError)])
def test_shc_outside_the_kernel_gate_stays_plain(sampler, want):
    """SHC takes the kernel only where ``kernel_gate`` admits the
    geometry: a device whose shared memory holds no block of it runs the
    plain SHC search under "auto" and refuses "kernel"."""
    cfg = _cfgs()[1]
    assert steps.resolve_route(sampler, "cuda", cfg,
                               "SHC").search == "kernel"
    if want is ValueError:
        with pytest.raises(ValueError, match="sampler='kernel'"):
            steps.resolve_route(sampler, "cuda", cfg, "SHC",
                                smem_limit=48 * 1024)
    else:
        assert steps.resolve_route(sampler, "cuda", cfg, "SHC",
                                   smem_limit=48 * 1024).search == want


@pytest.mark.parametrize("sampler,want", [("auto", "plain"),
                                           ("kernel", ValueError)])
def test_shc_with_more_than_one_reference_stays_plain(sampler, want):
    """The kernel's SHC pick is built for one reference (the
    reference-free driver's): SHC with more on a CUDA device runs the
    plain search under "auto" and refuses "kernel", while the standard
    search with as many takes the kernel."""
    cfg = _cfgs()[1]
    assert steps.resolve_route(sampler, "cuda", cfg, "",
                               n_refs=8).search == "kernel"
    if want is ValueError:
        with pytest.raises(ValueError, match="SHC' with 8 references"):
            steps.resolve_route(sampler, "cuda", cfg, "SHC", n_refs=8)
    else:
        assert steps.resolve_route(sampler, "cuda", cfg, "SHC",
                                   n_refs=8).search == want


def test_steps_call_the_kernel_shc_search_by_a_search_shc_name(monkeypatch):
    """``align_step_shc`` under "kernel" calls the kernel's SHC search as
    the module global ``models.steps.fused_search_shc``, a name that
    holds ``search_shc``: a caller that wraps every such global (the
    benchmark's capture) sees each SHC search, whichever runs."""
    names = sorted(n for n, f in vars(steps).items()
                   if "search_shc" in n and callable(f))
    assert "fused_search_shc" in names
    assert steps.fused_search_shc is fused_search.fused_search_shc
    calls = []

    def wrapped(images, ref_fw, params, cfg, previousmax, *a, **k):
        calls.append(images.shape[0])
        return fused_search.fused_search_shc(images, ref_fw, params, cfg,
                                             previousmax, *a, **k)

    monkeypatch.setattr(steps, "fused_search_shc", wrapped)
    _, cfg, refs, imgs, _, tp = _case(1, 3)
    pm = torch.full((N,), search.PREVIOUSMAX_INIT)
    out = steps.align_step_shc(torch.as_tensor(imgs), torch.as_tensor(refs),
                               tp, torch.arange(N), None, pm, cfg,
                               n_classes=1, sampler="kernel")
    assert calls == [N] and int(out.nope) == 0


@pytest.mark.parametrize("thresholds", ["init", "mixed", "high"])
@pytest.mark.parametrize("mirror", [True, False], ids=["mirror", "nomirror"])
def test_fused_search_shc_on_the_cpu_is_the_plain_search(thresholds, mirror):
    """On a CPU tensor ``fused_search_shc`` is ``rotational_shift_search_shc``
    bit for bit; it has no kernel whose shift groups ``out_groups`` or
    unclamped ring samplings ``out_interior`` could count, so asking for
    either raises (``fused_search``'s ``out_interior`` too)."""
    _, cfg, refs, imgs, _, tp = _case(3, 5, mirror=mirror)
    imgs = torch.as_tensor(imgs)
    rfw = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    peak = search.rotational_shift_search(imgs, rfw, tp, cfg).best_val
    factor = {"init": None, "high": torch.full((N,), 1.1),
              "mixed": torch.as_tensor(np.random.default_rng(0).choice(
                  [0.5, 0.9, 1.1], N), dtype=torch.float32)}[thresholds]
    pm = (torch.full((N,), search.PREVIOUSMAX_INIT) if factor is None
          else peak * factor)
    got, found = fused_search.fused_search_shc(imgs, rfw, tp, cfg, pm)
    want, found_w = search.rotational_shift_search_shc(imgs, rfw, tp, cfg, pm)
    assert torch.equal(found, found_w)
    for f in search.SearchResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="out_groups"):
        fused_search.fused_search_shc(
            imgs, rfw, tp, cfg, pm,
            out_groups=torch.zeros(N, dtype=torch.int32))
    with pytest.raises(ValueError, match="out_interior"):
        fused_search.fused_search_shc(
            imgs, rfw, tp, cfg, pm,
            out_interior=torch.zeros(N, dtype=torch.int32))
    with pytest.raises(ValueError, match="out_interior"):
        fused_search.fused_search(
            imgs, rfw, tp, cfg, out_interior=torch.zeros(N, dtype=torch.int32))
    if thresholds == "init":
        assert found.all()
    if thresholds == "high":
        assert not found.any()
        assert (got.best_val == -3.0e38).all() and not got.best_row.any()
    if thresholds == "mixed":
        assert found.any() and not found.all()


def test_engine_shc_previousmax_round_trip():
    imgs = _case(1, 9)[3]
    eng = AlignmentEngine(imgs, _cfgs()[1], n_classes=1, device="cpu",
                          update_ref=False, random_method="SHC")
    np.testing.assert_array_equal(
        eng.previousmax_np(), np.full(N, 1.0e-23, np.float32))
    out = eng.iterate(imgs.mean(0)[None])
    assert out.nope == 0 and (eng.previousmax_np() > 1.0e-23).all()
    again = eng.iterate(imgs.mean(0)[None])
    assert 0 <= again.nope <= N
    pm = np.linspace(1.0, 2.0, N).astype(np.float32)
    eng.set_previousmax(pm)
    np.testing.assert_array_equal(eng.previousmax_np(), pm)
    plain = AlignmentEngine(imgs, _cfgs()[1], n_classes=1, device="cpu")
    with pytest.raises(ValueError, match="SHC"):
        plain.previousmax_np()


def test_align_step_takes_mode_h_and_eman2():
    """The gates are gone: ``align_step`` runs half rings and the eman2
    scheme (held against JAX in test_torch_eman.py)."""
    for geom in (dict(mode="H"), dict(ring_scheme="eman2")):
        jcfg, cfg, refs, imgs, jp, tp = _case(2, 11, **geom)
        gidx = np.arange(N, dtype=np.int32)
        want = jsteps.align_step(jnp.asarray(imgs), jnp.asarray(refs), jp,
                                 jnp.asarray(gidx), None, jcfg, n_classes=2,
                                 sampler="gather")
        got = steps.align_step(torch.as_tensor(imgs), torch.as_tensor(refs),
                               tp, torch.as_tensor(gidx), None, cfg,
                               n_classes=2)
        _assert_params_match(got.params, want.params)
        sums = np.asarray(want.class_sums)
        np.testing.assert_allclose(got.class_sums.numpy(), sums, rtol=0,
                                   atol=1e-4 * np.abs(sums).max())


@pytest.mark.parametrize("first", ["port", "jax"])
def test_reffree_shc_resumes_either_checkpoint(tmp_path, first):
    """SHC keeps ``previousmax`` in the checkpoint's ``extra``: two
    iterations by either package, then the port resumes to four, equal to
    a straight run of four."""
    tmpl = asymmetric_templates(1, NX)
    imgs = np.asarray(scattered_stack(tmpl, N, max_shift=1, noise=0.05,
                                      seed=5)[0], np.float32)
    kw = dict(ou=16, xr=1.0, ts=1.0, random_method="SHC")
    quiet = dict(log=RunLogger(None, quiet=True))
    straight = ali2d_base(imgs, outdir=str(tmp_path / "s"), maxit=4,
                          device="cpu", **quiet, **kw)
    d = str(tmp_path / first)
    if first == "port":
        ali2d_base(imgs, outdir=d, maxit=2, device="cpu", **quiet, **kw)
    else:
        ali2d_base_tpu(imgs, outdir=d, maxit=2, sampler="gather",
                       log=JaxLogger(None, quiet=True), **kw)
    ck = np.load(tmp_path / first / "checkpoint.npz")
    assert ck["x_previousmax"].shape == (N,)
    resumed = ali2d_base(imgs, outdir=d, maxit=4, resume=True, device="cpu",
                         **quiet, **kw)
    np.testing.assert_array_equal(resumed.params[:, 3], straight.params[:, 3])
    np.testing.assert_allclose(resumed.params[:, 1:3],
                               straight.params[:, 1:3], atol=1e-3)
    dang = np.abs(resumed.params[:, 0] - straight.params[:, 0])
    assert np.minimum(dang, 360.0 - dang).max() < 1e-3
    np.testing.assert_allclose(resumed.criteria, straight.criteria[2:],
                               rtol=1e-5)
    np.testing.assert_allclose(
        np.load(tmp_path / first / "checkpoint.npz")["x_previousmax"],
        np.load(tmp_path / "s" / "checkpoint.npz")["x_previousmax"],
        rtol=1e-5)
