"""The matmul sampler of the port (``sampler="matmul"``: ``ops/polar_mm.py``,
``ops/search.py::rotational_shift_search_mm`` / ``_shc_mm``, the matmul
branches of ``ops/eman_search.py`` and ``ops/scf.py``) against the JAX
package's on the CPU, op by op and end to end, at 48 px with 12-16 rings
of 128 samples and 16-24 particles (the JAX engines are slow on a CPU).
The JAX functions run compiled (``jax.jit``), as its drivers run them.

Tolerances: the tent tables exactly equal (numpy in both packages); the
f32 products (``fast=False``) within 1e-5 of the largest value; with
``fast=True`` the operands rounded to bf16 in both packages, so a
translate or a polar sample within two bf16 steps of its value, and
exactly the bf16 cast of the exact one for integer shifts; winners
exactly equal at ``fast=False``, and at ``fast=True`` equal except where
the two peaks lie within 1e-5 relative (measured: one particle of 16 in
mode H, its mirror flag only, peaks 5.4e-7 apart: on half rings a disc's
mirrored candidate is a near-twin, and the bf16 samples decide it);
peaks and rows within 1e-5 of the largest peak.  The drivers through
``sampler="matmul"``, both summing their classes by the FFT shear: the
first iteration's assignments and mirrors all equal, then every
assignment and mirror equal and the median angle difference within
0.05 degree (tests/torch_template_common.py's rules; measured medians
in each test).
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from cryo_ralib_tpu.cli import mref as jax_mref_cli
from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import ali2d_base_tpu, mref_ali2d_tpu
from cryo_ralib_tpu.models import device_loop as jloop
from cryo_ralib_tpu.ops import eman_search as jeman
from cryo_ralib_tpu.ops import polar_mm as jpolar_mm
from cryo_ralib_tpu.ops import scf as jscf
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu_torch.cli import common as cli_common
from cryo_ralib_tpu_torch.cli import mref as port_mref_cli
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.io.mrc import write_mrc
from cryo_ralib_tpu_torch.models import (ali2d_base, make_mref_device_loop,
                                         mref_ali2d, steps)
from cryo_ralib_tpu_torch.ops import eman_search, polar_mm, scf, search
from cryo_ralib_tpu_torch.parallel import batching
from cryo_ralib_tpu_torch.params import params_from_numpy
from cryo_ralib_tpu_torch.utils.log import RunLogger
from tests.conftest import make_class_bases, make_disc_stack
from tests.torch_template_common import (E2E, _assert_drivers_agree,
                                         _assert_first_iteration,
                                         one_torch_thread, _spies,
                                         _stack_k)

NX, K, N = 48, 3, 16
WINNERS = ("best_mirror", "best_sidx", "best_ref", "best_aidx")


def _cfgs(**kw):
    base = dict(img_dim=NX, ring_num=14, ring_len=128, shift_step=1.0,
                shift_rng_x=2.0, shift_rng_y=1.0)
    base.update(kw)
    return JaxConfig(**base), AlignConfig(**base)


@pytest.fixture(scope="module")
def stack():
    return make_disc_stack(np.random.default_rng(17), N, NX).astype(
        np.float32)


@pytest.fixture(scope="module")
def refs():
    return make_class_bases(K, NX).astype(np.float32)


def _params(kind, n=N, seed=5):
    """Integer or fractional accumulated shifts (classes 0..K-1 for a
    per-particle reference) in both packages' types."""
    rng = np.random.default_rng(seed)
    if kind == "integer":
        sx, sy = (rng.integers(-1, 2, n).astype(np.float32)
                  for _ in range(2))
    else:
        sx, sy = (rng.uniform(-1.5, 1.5, n).astype(np.float32)
                  for _ in range(2))
    p = dict(angle=np.zeros(n, np.float32), shift_x=sx, shift_y=sy,
             mirror=np.zeros(n, np.int32),
             ref_id=rng.integers(0, K, n).astype(np.int32))
    return (JaxParams(*[jnp.asarray(p[f]) for f in JaxParams._fields]),
            params_from_numpy(p))


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_winners(got, want, exact=True):
    """Winners equal (``exact``), or equal except where the two peaks
    lie within 1e-5 relative; peaks within 1e-5 of the largest peak, and
    rows where the winners agree."""
    same = np.ones(N, bool)
    for f in WINNERS:
        same &= getattr(got, f).numpy() == np.asarray(getattr(want, f))
    gv, wv = got.best_val.numpy(), np.asarray(want.best_val)
    if exact:
        assert same.all(), np.nonzero(~same)
    else:
        gap = np.abs(gv - wv) / np.abs(wv)
        assert (gap[~same] < 1e-5).all(), (np.nonzero(~same), gap[~same])
    scale = np.abs(wv).max()
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5 * scale)
    finite = np.asarray(want.best_row) > -1e30   # the angle mask's bins
    finite[~same] = False
    np.testing.assert_allclose(got.best_row.numpy()[finite],
                               np.asarray(want.best_row)[finite], rtol=0,
                               atol=1e-5 * scale)


# ---- the tables and the products ---------------------------------------

@pytest.mark.parametrize("geom", [dict(), dict(shift_step=0.5),
                                  dict(mode="H", ring_num=9)])
def test_polar_tables_equal_jax(geom):
    jcfg, cfg = _cfgs(**geom)
    for window in (None, (4, 40)):
        got = polar_mm.build_polar_tables(cfg, x_window=window)
        want = jpolar_mm.build_polar_tables(jcfg, x_window=window)
        np.testing.assert_array_equal(got.wy, want.wy)
        np.testing.assert_array_equal(got.wx, want.wx)
        assert (got.n_dy, got.n_dx, got.ring_num, got.ring_len) == (
            want.n_dy, want.n_dx, want.ring_num, want.ring_len)
    wy, wx = polar_mm.polar_tables(cfg, torch.device("cpu"))
    np.testing.assert_array_equal(wy.numpy(), want.wy if window is None
                                  else jpolar_mm.build_polar_tables(jcfg).wy)
    np.testing.assert_array_equal(wx.numpy(),
                                  jpolar_mm.build_polar_tables(jcfg).wx)


def test_eman_tents_equal_jax():
    jcfg, cfg = _cfgs(ring_scheme="eman2", ring_num=16)
    got = eman_search.eman_mm_tables(cfg, torch.device("cpu"))
    want = jeman._group_tables(jcfg)
    assert len(got) == len(want) > 1
    for (wy, wx), (_ln, jwy, jwx) in zip(got, want):
        np.testing.assert_array_equal(wy.numpy(), jwy)
        np.testing.assert_array_equal(wx.numpy(), jwx)


@pytest.mark.parametrize("kind", ["integer", "fractional"])
@pytest.mark.parametrize("fast", [False, True])
def test_translate_bilinear_mm_matches_jax(stack, kind, fast):
    """f32: within 1e-5 of the largest value (measured 8.5e-8); bf16:
    within two bf16 steps of each value (both round the image, the tents
    and the first product to bf16; measured bitwise equal); integer
    shifts: the exact translate (f32) and its bf16 cast (fast),
    bitwise."""
    jp, tp = _params(kind)
    want = np.asarray(_jit(jpolar_mm.translate_bilinear_mm, fast=fast)(
        jnp.asarray(stack), jp.shift_x, jp.shift_y))
    got = polar_mm.translate_bilinear_mm(torch.as_tensor(stack), tp.shift_x,
                                         tp.shift_y, fast=fast).numpy()
    if not fast:
        assert _rel(got, want) < 1e-5, _rel(got, want)
    else:
        step = 2.0 ** -7 * np.abs(want) + 1e-6 * np.abs(want).max()
        assert (np.abs(got - want) <= 2 * step).all()
    if kind == "integer":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fast", [False, True])
def test_polar_group_mm_matches_jax(stack, fast):
    """One dy group of samples within 1e-5 of the largest value: f32
    (measured 8.4e-8), and bf16 with the intermediate rounded to bf16
    between the contractions (measured bitwise equal: a tent row has
    two nonzeros, so each sum is exact in f32)."""
    jcfg, cfg = _cfgs()
    t = polar_mm.build_polar_tables(cfg)
    want = _jit(jpolar_mm.polar_group_mm, ring_num=cfg.ring_num,
                ring_len=cfg.ring_len, fast=fast)(
        jnp.asarray(stack), jnp.asarray(t.wy[1]), jnp.asarray(t.wx))
    got = polar_mm.polar_group_mm(torch.as_tensor(stack),
                                  torch.as_tensor(t.wy[1]),
                                  torch.as_tensor(t.wx), cfg.ring_num,
                                  cfg.ring_len, fast=fast)
    assert got.shape == (N, t.n_dx, cfg.ring_num, cfg.ring_len)
    assert _rel(got, want) < 1e-5, _rel(got, want)


def test_polar_resample_mm_matches_jax_and_the_gather(refs):
    """Full f32 tents: JAX's and the bilinear gather's samples within
    1e-5 of the largest value (measured 1.3e-7 for both)."""
    from cryo_ralib_tpu_torch.ops.polar import polar_resample

    jcfg, cfg = _cfgs()
    want = jax.jit(lambda x: jpolar_mm.polar_resample_mm(x, jcfg))(
        jnp.asarray(refs))
    got = polar_mm.polar_resample_mm(torch.as_tensor(refs), cfg)
    assert _rel(got, want) < 1e-5
    gather = polar_resample(torch.as_tensor(refs),
                            torch.as_tensor(cfg.polar_coords))
    assert _rel(got, gather) < 1e-5


# ---- the searches -------------------------------------------------------

SEARCHES = {
    "f32_integer": (dict(), "integer", False, {}),
    "f32_fractional": (dict(), "fractional", False, {}),
    "bf16_integer": (dict(), "integer", True, {}),
    "bf16_fractional": (dict(), "fractional", True, {}),
    "nomirror": (dict(mirror=False), "integer", True, {}),
    "mode_h": (dict(mode="H"), "integer", True, {}),
    "ts05": (dict(shift_step=0.5, shift_rng_x=1.0, shift_rng_y=0.5),
             "fractional", True, {}),
    "masked": (dict(), "integer", True, dict(mask=15.0)),
    "per_particle_ref": (dict(), "integer", True,
                         dict(per_particle_ref=True)),
}


@pytest.mark.parametrize("case", SEARCHES)
def test_rotational_shift_search_mm_matches_jax(stack, refs, case):
    geom, kind, fast, more = SEARCHES[case]
    jcfg, cfg = _cfgs(**geom)
    jp, tp = _params(kind)
    jr = jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg)
    tr = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    mask = (search.delta_angle_mask(cfg.ring_len, more["mask"], cfg.mode)
            if "mask" in more else None)
    ppr = more.get("per_particle_ref", False)
    want = _jit(jsearch.rotational_shift_search_mm, cfg=jcfg, fast=fast,
                per_particle_ref=ppr)(
        jnp.asarray(stack), jr, jp,
        angle_mask=None if mask is None else jnp.asarray(mask))
    got = search.rotational_shift_search_mm(
        torch.as_tensor(stack), tr, tp, cfg, per_particle_ref=ppr,
        fast=fast, angle_mask=None if mask is None else torch.as_tensor(mask))
    _assert_winners(got, want, exact=not fast)
    if mask is not None:
        assert (mask[got.best_aidx.numpy()] == 0).all()


def test_search_mm_blocks_equal_one_call(stack, refs, monkeypatch):
    """A stack over ``mm_block`` particles goes by blocks: the same
    winners, and every value to f32 rounding."""
    _, cfg = _cfgs()
    _, tp = _params("fractional")
    tr = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    whole = search.rotational_shift_search_mm(torch.as_tensor(stack), tr, tp,
                                              cfg)
    monkeypatch.setattr(search, "MM_SEARCH_BUDGET",
                        3 * search.mm_search_bytes(1, K, cfg))
    assert search.mm_block(N, K, cfg) == 3
    blocked = search.rotational_shift_search_mm(torch.as_tensor(stack), tr,
                                                tp, cfg)
    for f in WINNERS:
        assert torch.equal(getattr(blocked, f), getattr(whole, f)), f
    torch.testing.assert_close(blocked.best_row, whole.best_row, rtol=0,
                               atol=1e-5 * float(whole.best_val.abs().max()))


@pytest.mark.parametrize("fast", [False, True])
def test_rotational_shift_search_shc_mm_matches_jax(stack, refs, fast,
                                                    monkeypatch):
    """SHC from thresholds at half or 1.1x each particle's peak (a
    threshold equal to a peak would be decided by rounding), in one call
    and by blocks of 5: ``found`` and the picks equal JAX's."""
    jcfg, cfg = _cfgs()
    jp, tp = _params("integer")
    jr = jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg)
    tr = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    full = search.rotational_shift_search_mm(torch.as_tensor(stack), tr, tp,
                                             cfg, fast=fast)
    rng = np.random.default_rng(11)
    pm = (full.best_val.numpy() * rng.choice([0.5, 1.1], N)).astype(
        np.float32)
    want, wfound = _jit(jsearch.rotational_shift_search_shc_mm, cfg=jcfg,
                        fast=fast)(jnp.asarray(stack), jr, jp,
                                   previousmax=jnp.asarray(pm))
    for budget in (None, 5 * search.mm_search_bytes(1, K, cfg)):
        if budget:
            monkeypatch.setattr(search, "MM_SEARCH_BUDGET", budget)
        got, found = search.rotational_shift_search_shc_mm(
            torch.as_tensor(stack), tr, tp, cfg, torch.as_tensor(pm),
            fast=fast)
        np.testing.assert_array_equal(found.numpy(), np.asarray(wfound))
        assert 0 < int(found.sum()) < N
        f = found.numpy()
        for name in WINNERS:
            np.testing.assert_array_equal(getattr(got, name).numpy()[f],
                                          np.asarray(getattr(want, name))[f])


@pytest.mark.parametrize("fast", [False, True])
def test_eman_matmul_branch_matches_jax(stack, refs, fast):
    """The eman2 rings through the matmul sampler: winners equal JAX's
    (its default sampler), and the plain search's at ``fast=False``."""
    jcfg, cfg = _cfgs(ring_scheme="eman2", ring_num=16)
    jp, tp = _params("fractional")
    jr = jeman.prepare_ref_spectra_eman(jnp.asarray(refs), jcfg)
    tr = eman_search.prepare_ref_spectra_eman(torch.as_tensor(refs), cfg)
    want = _jit(jeman.rotational_shift_search_eman, cfg=jcfg,
                sampler="matmul", fast=fast)(jnp.asarray(stack), jr, jp)
    got = eman_search.rotational_shift_search_eman(
        torch.as_tensor(stack), tr, tp, cfg, sampler="matmul", fast=fast)
    _assert_winners(got, want, exact=not fast)
    with pytest.raises(ValueError, match="sampler"):
        eman_search.rotational_shift_search_eman(
            torch.as_tensor(stack), tr, tp, cfg, sampler="template")


@pytest.mark.parametrize("fast", [False, True])
def test_scf_matmul_matches_jax(fast):
    """SCF through the matmul sampler (the rotation search on the scf
    images, the references inverse-transformed by the FFT shear): shifts
    and mirrors equal JAX's, angles within 1e-3 degree (measured 7.5e-4
    f32, 6.6e-4 bf16: the refined angle of an S=1 search), peaks within
    1e-3 relative (measured 6.7e-7, 1.3e-4)."""
    tmpl, imgs = _stack_k(1, N, 21)
    base = dict(img_dim=NX, ring_num=14, ring_len=128, mode="H",
                shift_rng_x=2.0, shift_rng_y=2.0)
    jcfg, cfg = JaxConfig(**base), AlignConfig(**base)
    ref = imgs.mean(0)
    want_p, want_peak = _jit(jscf.scf_align, cfg=jcfg, sampler="matmul",
                             fast=fast)(jnp.asarray(imgs), jnp.asarray(ref))
    got_p, got_peak = scf.scf_align(torch.as_tensor(imgs),
                                    torch.as_tensor(ref), cfg,
                                    sampler="matmul", fast=fast)
    for f in ("shift_x", "shift_y", "mirror", "ref_id"):
        np.testing.assert_array_equal(getattr(got_p, f).numpy(),
                                      np.asarray(getattr(want_p, f)), f)
    d = np.abs(got_p.angle.numpy() - np.asarray(want_p.angle)) % 360.0
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    np.testing.assert_allclose(got_peak.numpy(), np.asarray(want_peak),
                               rtol=1e-3)


# ---- the drivers, the loop, the CLI, the rules ---------------------------

def test_mref_matmul_matches_jax(monkeypatch):
    """``mref_ali2d(sampler="matmul")`` against ``mref_ali2d_tpu``'s, 2
    iterations (measured median 3.1e-5 degree; the eman2 rings are held
    in ``test_reffree_matmul_matches_jax[eman2]``)."""
    tmpl, imgs = _stack_k(3, 24, 43)
    first_want, first_got = _spies(monkeypatch)
    kw = dict(E2E, maxit=2)
    want = mref_ali2d_tpu(imgs, tmpl.copy(), sampler="matmul",
                          log=JaxLogger(None, quiet=True), **kw)
    got = mref_ali2d(imgs, tmpl.copy(), device="cpu", sampler="matmul",
                     log=RunLogger(None, quiet=True), **kw)
    _assert_first_iteration(first_got[0], first_want[0])
    _assert_drivers_agree(got, want)
    np.testing.assert_array_equal(got.class_counts, want.class_counts)


REFFREE = {
    "standard": dict(maxit=2),
    "shc": dict(maxit=2, random_method="SHC"),
    "scf": dict(maxit=2, random_method="SCF"),
    "eman2": dict(maxit=2, ring_scheme="eman2"),
}


@pytest.mark.parametrize("case", REFFREE)
def test_reffree_matmul_matches_jax(case, monkeypatch):
    """``ali2d_base(sampler="matmul")`` against ``ali2d_base_tpu``'s in
    every mode, 2 iterations (measured medians: standard 3.7e-4, SHC
    6.7e-4, SCF 3.1e-4, eman2 3.8e-5 degree; the angle mask is held by
    ``test_rotational_shift_search_mm_matches_jax[masked]``)."""
    _, imgs = _stack_k(1, 16, 3)
    kw = dict(ou=16, xr=1.0, ts=1.0, **REFFREE[case])
    first_want, first_got = _spies(monkeypatch)
    want = ali2d_base_tpu(imgs, sampler="matmul",
                          log=JaxLogger(None, quiet=True), **kw)
    got = ali2d_base(imgs, device="cpu", sampler="matmul",
                     log=RunLogger(None, quiet=True), **kw)
    assert got.iterations == want.iterations
    _assert_first_iteration(first_got[0], first_want[0])
    _assert_drivers_agree(got, want)


def test_mref_device_loop_matmul_matches_jax():
    """The multireference loop through the matmul sampler, 2 iterations:
    every assignment and mirror equal, the median angle within 0.05
    degree of JAX's loop."""
    tmpl, imgs = _stack_k(3, 16, 47)
    base = dict(img_dim=48, ring_num=16, shift_rng_x=1.0, shift_rng_y=1.0)
    cut = np.full(2, 0.25, np.float32)
    run = jloop.make_mref_device_loop(JaxConfig(**base), 2, 3, cut,
                                      sampler="matmul")
    jp, tp = _params("integer", 16)
    gidx = np.arange(16, dtype=np.int32)
    valid = np.ones(16, np.float32)
    zero = dict(angle=np.zeros(16, np.float32),
                shift_x=np.zeros(16, np.float32),
                shift_y=np.zeros(16, np.float32),
                mirror=np.zeros(16, np.int32), ref_id=np.zeros(16, np.int32))
    want_p, _ = run(jnp.asarray(imgs), jnp.asarray(tmpl),
                    JaxParams(*[jnp.asarray(zero[f])
                                for f in JaxParams._fields]),
                    jnp.asarray(gidx), jnp.asarray(valid))
    loop = make_mref_device_loop(AlignConfig(**base), 2, 3, cut,
                                 device="cpu", sampler="matmul")
    got_p, got_refs = loop(torch.as_tensor(imgs), torch.as_tensor(tmpl),
                           params_from_numpy(zero), torch.as_tensor(gidx),
                           torch.as_tensor(valid))
    assert bool(torch.isfinite(got_refs).all())
    for f in ("ref_id", "mirror"):
        np.testing.assert_array_equal(getattr(got_p, f).numpy(),
                                      np.asarray(getattr(want_p, f)))
    d = np.abs(got_p.angle.numpy() - np.asarray(want_p.angle)) % 360.0
    assert np.median(np.minimum(d, 360.0 - d)) < 0.05


def test_cli_matmul_writes_the_jax_file_set(tmp_path):
    """``--sampler=matmul`` runs through the CLI on the CPU (it exited 2
    before this port had the sampler) and writes the files the JAX CLI
    writes with the same flag, with the same mirrors and classes in the
    checkpoint and angles within 0.05 degree."""
    tmpl, imgs = _stack_k(2, 12, 5)
    stack_f, refs_f = str(tmp_path / "stack.mrcs"), str(tmp_path / "r.mrcs")
    write_mrc(stack_f, imgs)
    write_mrc(refs_f, tmpl)
    flags = ["--ou=16", "--xr=1", "--ts=1", "--maxit=2", "--sampler=matmul"]
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_mref_cli.main([stack_f, refs_f, d_port] + flags,
                              device="cpu") == 0
    assert jax_mref_cli.main([stack_f, refs_f, d_jax] + flags
                             + ["--devices=1"]) == 0
    assert set(os.listdir(d_port)) == set(os.listdir(d_jax))
    got = np.load(os.path.join(d_port, "checkpoint.npz"))
    want = np.load(os.path.join(d_jax, "checkpoint.npz"))
    for f in ("mirror", "ref_id"):
        np.testing.assert_array_equal(got[f], want[f])
    d = np.abs(got["angle"] - want["angle"]) % 360.0
    assert np.minimum(d, 360.0 - d).max() < 0.05


def test_every_jax_sampler_is_taken():
    """No ``--sampler``, ``sampler=`` or ``engine=`` value that the JAX
    package accepts raises in the port: every ``--sampler`` choice maps
    to a search that ``resolve_route`` takes in every mode JAX takes
    it; "matmul" is taken only as asked (SHC, SCF, eman2, a
    per-particle reference, on either device), "auto" never picks it."""
    _, cfg = _cfgs()
    _, cfg_h = _cfgs(mode="H")
    _, cfg_e = _cfgs(ring_scheme="eman2")
    parser = port_mref_cli.build_parser()
    choices = next(a.choices for a in parser._actions
                   if a.dest == "sampler")
    assert set(choices) == set(cli_common.SAMPLERS) == {
        "auto", "fused", "template", "matmul", "gather"}
    assert cli_common.SAMPLERS["matmul"] == "matmul"
    for dev in ("cpu", "cuda"):
        for c, rm in ((cfg, ""), (cfg, "SHC"), (cfg_h, "SCF"), (cfg_e, "")):
            route = steps.resolve_route("matmul", dev, c, rm)
            assert (route.search, route.sums) == ("matmul", "shear")
        assert steps.resolve_route("matmul", dev, cfg,
                                   per_particle_ref=True).search == "matmul"
        for rm in ("", "SHC"):
            assert steps.resolve_route("auto", dev, cfg,
                                       rm).search != "matmul"
    with pytest.raises(ValueError, match="sampler"):
        steps.resolve_route("fft", "cpu", cfg)
    img = torch.zeros((2, 16, 16))
    for engine in ("auto", "quadri", "shear"):
        from cryo_ralib_tpu_torch.ops.transform import rot_shift2d

        rot_shift2d(img, torch.zeros(2), torch.zeros(2), torch.zeros(2),
                    engine=engine)


def test_step_footprint_matmul_branch():
    """The matmul sampler's step at the headline: the search's transient
    is one dy group of a block (``mm_search_bytes`` of ``mm_block``
    particles, under ``MM_SEARCH_BUDGET``) with the block's translate and
    every block's outputs; its sums are the FFT shear's
    (``shear_sum_bytes``), as the template engine's now; a stack that
    does not fit streams in powers of two."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_rng_x=3.0,
                      shift_rng_y=3.0)
    n = 16384
    route = steps.resolve_route("matmul", "cpu", cfg, n_refs=8)
    fp = batching.step_footprint(n, route, cfg)
    kern = batching.step_footprint(
        n, steps.resolve_route("kernel", "cuda", cfg, n_refs=8), cfg)
    tmpl = batching.step_footprint(
        n, steps.resolve_route("template", "cpu", cfg, n_refs=8), cfg)
    blk = search.mm_block(n, 8, cfg)
    assert 1 < blk < n
    assert search.mm_search_bytes(blk, 8, cfg) <= search.MM_SEARCH_BUDGET
    assert fp.search == batching.matmul_search_bytes(n, 8, cfg)
    assert fp.search >= search.mm_search_bytes(blk, 8, cfg)
    # one (Q, N, W) y contraction at 36 x 256 samples and 90 columns
    assert search.mm_search_bytes(1, 8, cfg) > 36 * 256 * 90 * 10
    assert fp.transform == tmpl.transform == batching.shear_sum_bytes(
        n, 8, 90) != kern.transform
    assert fp.tables - kern.tables == 14 * 36 * 256 * 90 * 4
    limit = int(fp.total / 0.8) - 1
    b = batching.plan_batch_size(n, route, cfg, limit_bytes=limit)
    assert b < n and b & (b - 1) == 0
