"""The template engine end to end against the JAX package's on the CPU:
``align_step``, the drivers, the device loop, the planner and the
command line with ``sampler="template"`` (tests/torch_template_common.py
holds the shared helpers).

Both packages search by the template engine and sum their classes by the
FFT shear with bf16 DFTs (``class_sum_transform_mm``), so from the
second iteration on they search against the same references up to bf16
rounding.  One ``align_step`` from the same references: params within
1e-3, class sums within 2e-3 of their largest value.  The drivers' first
iteration: every assignment and mirror equal, header shifts within 1e-3,
angles within 1e-2 degree (bf16 rows move the refined angle of a flat
peak by more than 1e-3); it is read after the engine's first
``iterate``, and under ``--dst`` it is the discrete iteration.  Over 2-3
iterations (11 with ``--dst``) and in the device loop: every assignment
and mirror equal and the median angle difference within 0.05 degree of
JAX's (each test states its measured values; before the class sums were
the FFT shear's, 99% of assignments and a median of 0.1 degree was the
rule, and ``--dst``'s 11 iterations drifted 0.17 degree apart).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import ali2d_base_tpu, mref_ali2d_tpu
from cryo_ralib_tpu.models import device_loop as jloop
from cryo_ralib_tpu.models import steps as jsteps
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import (ali2d_base, make_mref_device_loop,
                                         mref_ali2d)
from cryo_ralib_tpu_torch.models import steps
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.ops import search
from cryo_ralib_tpu_torch.ops import template_search as ts
from cryo_ralib_tpu_torch.parallel import batching
from cryo_ralib_tpu_torch.utils.log import RunLogger
from tests.torch_template_common import (E2E, K, NX, _assert_drivers_agree,
                                         _assert_first_iteration, _cfgs,
                                         _jit, _params, _spies, _stack_k,
                                         one_torch_thread)


@pytest.mark.parametrize("geom,delta", [(dict(), 0.0),
                                        (dict(ring_scheme="eman2"), 0.0),
                                        (dict(), 15.0)])
def test_align_step_template_matches_jax(geom, delta):
    """One step from the same references, ``--dst``'s angle mask
    included: params as the module docstring says, and the class sums,
    both by the FFT shear with bf16 DFTs, within 2e-3 of their largest
    value of JAX's (measured 6.0e-4-7.3e-4: the two round the same f32
    values to bf16, and a value one f32 ulp apart, as XLA's fused
    complex products leave it, rounds to the next bf16 step; JAX's own
    compiled and eager warps differ as much)."""
    tmpl, imgs = _stack_k(3, 16, 41)
    base = dict(img_dim=48, ring_num=16, shift_rng_x=1.0, shift_rng_y=1.0)
    jcfg, cfg = JaxConfig(**base, **geom), AlignConfig(**base, **geom)
    gidx = np.arange(16, dtype=np.int32)
    jp, tp = _params("integer", 16, seed=9)
    mask = (search.delta_angle_mask(cfg.ring_len, delta) if delta
            else None)
    want = _jit(jsteps.align_step, cfg=jcfg, n_classes=3,
                sampler="template")(
        jnp.asarray(imgs), jnp.asarray(tmpl), jp, jnp.asarray(gidx), None,
        angle_mask=None if mask is None else jnp.asarray(mask))
    got = steps.align_step(
        torch.as_tensor(imgs), torch.as_tensor(tmpl), tp,
        torch.as_tensor(gidx), None, cfg, n_classes=3, sampler="template",
        angle_mask=None if mask is None else torch.as_tensor(mask))
    for f in ("ref_id", "mirror", "shift_x", "shift_y"):
        np.testing.assert_array_equal(getattr(got.params, f).numpy(),
                                      np.asarray(getattr(want.params, f)), f)
    d = np.abs(got.params.angle.numpy() - np.asarray(want.params.angle))
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    s = np.asarray(want.class_sums)
    np.testing.assert_allclose(got.class_sums.numpy(), s, rtol=0,
                               atol=2e-3 * np.abs(s).max())
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))



MREF = {"standard": dict(), "eman2": dict(ring_scheme="eman2")}


@pytest.mark.parametrize("case", MREF)
def test_mref_template_matches_jax(case, monkeypatch):
    tmpl, imgs = _stack_k(3, 24, 43)
    first_want, first_got = _spies(monkeypatch)
    kw = dict(E2E, maxit=2, **MREF[case])
    want = mref_ali2d_tpu(imgs, tmpl.copy(), sampler="template",
                          log=JaxLogger(None, quiet=True), **kw)
    got = mref_ali2d(imgs, tmpl.copy(), device="cpu", sampler="template",
                     log=RunLogger(None, quiet=True), **kw)
    _assert_first_iteration(first_got[0], first_want[0])
    # measured medians: standard 0.00026, eman2 0.00043 degree
    _assert_drivers_agree(got, want)
    np.testing.assert_array_equal(got.class_counts, want.class_counts)


REFFREE = {
    "standard": dict(maxit=3),
    "dst": dict(maxit=11, dst=90.0, user_func_name="ref_ali2d_no_filter"),
    "shc": dict(maxit=3, random_method="SHC"),
    "eman2": dict(maxit=3, ring_scheme="eman2"),
}


@pytest.mark.parametrize("case", REFFREE)
def test_reffree_template_matches_jax(case, monkeypatch):
    """The first iteration, then the case's iterations, held to
    ``ali2d_base_tpu(sampler="template")``: every mirror equal and the
    median angle within 0.05 degree (measured: standard 0.0046, SHC
    0.026, eman2 0.0023, and over ``--dst``'s 11 iterations 0.012,
    whose discrete iteration is the first)."""
    _, imgs = _stack_k(1, 16, 3)
    kw = dict(ou=16, xr=1.0, ts=1.0, **REFFREE[case])
    first_want, first_got = _spies(monkeypatch)
    want = ali2d_base_tpu(imgs, sampler="template",
                          log=JaxLogger(None, quiet=True), **kw)
    got = ali2d_base(imgs, device="cpu", sampler="template",
                     log=RunLogger(None, quiet=True), **kw)
    assert got.iterations == want.iterations
    _assert_first_iteration(first_got[0], first_want[0])
    _assert_drivers_agree(got, want)


def test_mref_device_loop_template_matches_jax():
    tmpl, imgs = _stack_k(3, 16, 47)
    base = dict(img_dim=48, ring_num=16, shift_rng_x=1.0, shift_rng_y=1.0)
    n_iter, cut = 2, np.full(2, 0.25, np.float32)
    run = jloop.make_mref_device_loop(JaxConfig(**base), n_iter, 3, cut,
                                      sampler="template")
    jp, tp = _params("zero", 16)
    gidx = np.arange(16, dtype=np.int32)
    valid = np.ones(16, np.float32)
    want_p, _ = run(jnp.asarray(imgs), jnp.asarray(tmpl), jp,
                    jnp.asarray(gidx), jnp.asarray(valid))
    loop = make_mref_device_loop(AlignConfig(**base), n_iter, 3, cut,
                                 device="cpu", sampler="template")
    got_p, refs = loop(torch.as_tensor(imgs), torch.as_tensor(tmpl), tp,
                       torch.as_tensor(gidx), torch.as_tensor(valid))
    assert bool(torch.isfinite(refs).all())
    same = ((got_p.ref_id.numpy() == np.asarray(want_p.ref_id))
            & (got_p.mirror.numpy() == np.asarray(want_p.mirror)))
    assert same.all(), np.nonzero(~same)
    d = np.abs(got_p.angle.numpy() - np.asarray(want_p.angle)) % 360
    # measured median 0.00024 degree (before: 99% and 0.1 degree)
    assert np.median(np.minimum(d, 360.0 - d)) < 0.05


def test_template_sampler_rules_and_engine():
    """``resolve_route`` takes "template" only as asked: SCF, a
    per-particle reference and a geometry outside the gate raise; "auto"
    never picks it; the template route sums by the FFT shear; the engine
    builds the splat spectra once and plans with the template
    footprint."""
    _, cfg = _cfgs()
    for dev in ("cpu", "cuda"):
        route = steps.resolve_route("template", dev, cfg)
        assert (route.search, route.sums, route.plan) == (
            "template", "shear", None)
        assert steps.resolve_route("template", dev, cfg,
                                   "SHC").search == "template"
        assert steps.resolve_route("auto", dev, cfg).search != "template"
    for kw, match in ((dict(random_method="SCF"), "SCF"),
                      (dict(per_particle_ref=True), "per_particle_ref"),
                      (dict(n_refs=40000), "geometry gate")):
        with pytest.raises(ValueError, match=match):
            steps.resolve_route("template", "cpu", cfg, **kw)
    with pytest.raises(ValueError, match="geometry gate"):
        steps.resolve_route("template", "cpu", _cfgs(ring_num=29)[1])
    data = np.zeros((4, NX, NX), np.float32)
    eng = AlignmentEngine(data, cfg, n_classes=K, device="cpu",
                          sampler="template")
    assert len(eng._sf) == 1 and eng._sf[0].shape[1] == cfg.ring_len // 2 + 1
    assert AlignmentEngine(data, cfg, n_classes=K, device="cpu")._sf is None
    with pytest.raises(ValueError, match="SCF"):
        AlignmentEngine(data, _cfgs(mode="H")[1], n_classes=1, device="cpu",
                        sampler="template", random_method="SCF")


def test_step_footprint_template_branch():
    """The template branch charges the bf16 window, the blocks, the splat
    spectra (with the tables) and the largest of translate, build and
    chunk, and plans a streamed batch where the stack does not fit."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_rng_x=3.0,
                      shift_rng_y=3.0)
    n = 16384
    route = steps.resolve_route("template", "cpu", cfg, n_refs=8)
    fp = batching.step_footprint(n, route, cfg)
    kern = batching.step_footprint(
        n, steps.resolve_route("kernel", "cuda", cfg, n_refs=8), cfg)
    _, width, _ = ts.template_geometry(cfg)
    wp = ts._padded(width * width)
    assert wp == 6568 and wp % 8 == 0
    assert fp.tables - kern.tables == ts._splat_spectra_bytes(cfg)
    window, blocks = n * wp * 2, ts._template_blocks_bytes(cfg, 8)
    scan = 2048 * wp * 6 + n * 2048 * 4 + 5 * n * 256 * 4
    assert fp.search == batching.template_search_bytes(n, 8, cfg)
    assert fp.search >= window + blocks + scan
    assert fp.search > n * wp * 2 + 62 * 10**6
    assert fp.total > kern.total
    # a limit below the resident footprint streams, in powers of two
    limit = int(fp.total / 0.8) - 1
    b = batching.plan_batch_size(n, route, cfg, limit_bytes=limit)
    assert b < n and b & (b - 1) == 0
    assert batching.step_footprint(b, route, cfg,
                                   streamed=True).total <= 0.8 * limit


def test_cli_template_writes_the_jax_file_set(tmp_path):
    """``--sampler=template`` runs through the CLI on the CPU and writes
    the files the JAX CLI writes with the same flag."""
    from cryo_ralib_tpu.cli import mref as jax_cli
    from cryo_ralib_tpu_torch.cli import mref as port_cli
    from cryo_ralib_tpu_torch.io.mrc import write_mrc

    tmpl, imgs = _stack_k(2, 12, 5)
    stack, refs = str(tmp_path / "stack.mrcs"), str(tmp_path / "refs.mrcs")
    write_mrc(stack, imgs)
    write_mrc(refs, tmpl)
    flags = ["--ou=16", "--xr=1", "--ts=1", "--maxit=2",
             "--sampler=template"]
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_cli.main([stack, refs, d_port] + flags, device="cpu") == 0
    assert jax_cli.main([stack, refs, d_jax] + flags + ["--devices=1"]) == 0
    assert set(os.listdir(d_port)) == set(os.listdir(d_jax))
    got = np.loadtxt(os.path.join(d_port, "final2Dparams.txt"))
    want = np.loadtxt(os.path.join(d_jax, "final2Dparams.txt"))
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
