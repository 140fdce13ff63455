"""The port's template engine (``ops/template_search.py``, with the tent
helpers of ``ops/polar_mm.py``) against the JAX package's on the CPU, at
the sizes of tests/test_template.py (64 px, K=3, ring_len=128), then end
to end: ``align_step``, the drivers, the device loop, the planner and
the command line with ``sampler="template"``.

Tolerances: the copied numpy helpers, the geometry and the gate exactly
equal; splat spectra within 1e-5 of their largest value (f32 FFT against
a matmul DFT); template blocks within one bf16 ulp plus 1e-6 of their
largest value (their f32 inputs differ by rounding); winners exactly
equal at integer accumulated shifts and, at fractional ones, equal
except where the two peaks are within
5e-3 relative (tests/test_template.py's tie rule: both engines round
their window and columns to bf16); rows within 5e-3 of their largest
value; decoded shifts equal where winners agree, and angles within
1e-3 degree plus twice the change that the 7-point fit takes to first
order from the two rows' difference (chip_smoke.py's rule: a flat peak
turns a bf16-level row difference into more than 1e-3 degree).  One
``align_step`` from the same references: params within 1e-3.  The
drivers' first iteration (the same references in both packages): every
assignment and mirror equal, header shifts within 1e-3, angles within
1e-2 degree; it is read from the same run as the last, after the
engine's first ``iterate``, and under ``--dst`` it is the discrete
iteration.  Over 2-3 iterations (11 with ``--dst``) and in the device
loop: at least 99% of assignments and mirrors equal and the median angle
difference under 0.1 degree (the JAX package's own bar between two of
its engines, tests/test_template.py:118).  The JAX engine sums its
classes by an FFT shear (``class_sum_transform_mm``) and the port by the
bilinear transform, so from the second iteration on the two search
against references that differ by that interpolation: measured, angles
0.03-0.16 degree apart after 2-3 iterations, and one SHC pick of 16
(the first candidate above a threshold) on another candidate; after
``--dst``'s 11 the angles are held to the port's plain driver, which
sums its classes as the template path does.  The port's class sums are
held to its own plain step under the same params.
"""

import functools
import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import ali2d_base_tpu, mref_ali2d_tpu
from cryo_ralib_tpu.models import device_loop as jloop
from cryo_ralib_tpu.models.engine import AlignmentEngine as JaxEngine
from cryo_ralib_tpu.models import steps as jsteps
from cryo_ralib_tpu.ops import eman_search as jeman
from cryo_ralib_tpu.ops import polar_mm as jpolar_mm
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.params import params_table as jax_params_table
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu.utils.synthetic import (asymmetric_templates,
                                            scattered_stack)
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import (ali2d_base, make_mref_device_loop,
                                         mref_ali2d)
from cryo_ralib_tpu_torch.models import steps
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.ops import eman_search, polar_mm, search
from cryo_ralib_tpu_torch.ops import template_search as ts
from cryo_ralib_tpu_torch.parallel import batching
from cryo_ralib_tpu_torch.params import params_from_numpy, params_table
from cryo_ralib_tpu_torch.utils.log import RunLogger
from tests.conftest import make_class_bases, make_disc_stack

# the JAX ops package re-exports the function under the module's name
jts = importlib.import_module("cryo_ralib_tpu.ops.template_search")

NX, K, N = 64, 3, 8
WINNERS = ("best_mirror", "best_sidx", "best_ref", "best_aidx")


def _cfgs(**kw):
    base = dict(img_dim=NX, ring_num=20, ring_len=128, shift_step=1.0,
                shift_rng_x=2.0, shift_rng_y=2.0)
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
    """Zero, integer or fractional accumulated shifts in both packages'
    types."""
    rng = np.random.default_rng(seed)
    if kind == "zero":
        sx = sy = np.zeros(n, np.float32)
    elif kind == "integer":
        sx, sy = (rng.integers(-1, 2, n).astype(np.float32)
                  for _ in range(2))
    else:
        sx, sy = (rng.uniform(-1.5, 1.5, n).astype(np.float32)
                  for _ in range(2))
    p = dict(angle=np.zeros(n, np.float32), shift_x=sx, shift_y=sy,
             mirror=np.zeros(n, np.int32), ref_id=np.zeros(n, np.int32))
    return (JaxParams(*[jnp.asarray(p[f]) for f in JaxParams._fields]),
            params_from_numpy(p))


def _jit(fn, **static):
    """A JAX function compiled once with its static arguments bound
    (eager dispatch of the engine's many small ops takes seconds on the
    CPU)."""
    return jax.jit(functools.partial(fn, **static))


def _spectra(jcfg, cfg, refs):
    if cfg.ring_scheme == "eman2":
        return (jeman.prepare_ref_spectra_eman(jnp.asarray(refs), jcfg),
                eman_search.prepare_ref_spectra_eman(torch.as_tensor(refs),
                                                     cfg))
    return (jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg),
            search.prepare_ref_spectra(torch.as_tensor(refs), cfg))


def _assert_winners(got, want, exact):
    """Winners equal (``exact``) or equal except where the two peaks are
    within 5e-3 relative; rows within 5e-3 of their largest value and
    peaks within 5e-3 relative where they agree.  Returns the (N,) bool
    of agreeing particles."""
    same = np.ones(got.best_val.shape[0], bool)
    for f in WINNERS:
        same &= getattr(got, f).numpy() == np.asarray(getattr(want, f))
    gv, wv = got.best_val.numpy(), np.asarray(want.best_val)
    if exact:
        assert same.all(), np.nonzero(~same)
    else:
        gap = np.abs(gv - wv) / np.abs(wv)
        assert (gap[~same] < 5e-3).all(), (np.nonzero(~same), gap[~same])
    wr = np.asarray(want.best_row)
    for i in np.nonzero(same)[0]:
        np.testing.assert_allclose(got.best_row.numpy()[i], wr[i], rtol=0,
                                   atol=5e-3 * np.abs(wr[i]).max())
    np.testing.assert_allclose(gv[same], wv[same], rtol=5e-3)
    return same


C2 = np.array([49.0, 6.0, -21.0, -32.0, -27.0, -6.0, 31.0])
C3 = np.array([5.0, 0.0, -3.0, -4.0, -3.0, 0.0, 5.0])


def _angle_slack(got, want, step):
    """Per particle, 1e-3 degree plus twice the first-order change that
    ``decode_params``' fit (c2 / (2 c3)) takes from the two rows'
    difference e on its 7 points: step x (172 e + |c2 / c3| x 20 e) /
    (2 |c3|), 172 and 20 the sums of the |c2| and |c3| coefficients."""
    ring_len = want.best_row.shape[1]
    cols = (np.asarray(want.best_aidx)[:, None] + np.arange(-3, 4)) % ring_len
    xp = np.take_along_axis(np.asarray(want.best_row, np.float64), cols, 1)
    xk = np.take_along_axis(got.best_row.numpy().astype(np.float64), cols, 1)
    c2, c3 = xp @ C2, xp @ C3
    e = np.abs(xk - xp).max(1)
    return 1e-3 + step * (172.0 * e + np.abs(c2 / c3) * 20.0 * e) / np.abs(c3)


def _bf16_ulp(w):
    """One bf16 ulp of each value, plus 1e-6 of the largest: the f32
    inverse DFTs of the two packages differ by rounding, which moves a
    near-zero template value across a bf16 step."""
    return np.abs(w) * 2.0 ** -7 + 1e-6 * np.abs(w).max()


# ---- the copies and the geometry ------------------------------------

def test_tent_rows_is_a_copy():
    rng = np.random.default_rng(3)
    coords = np.concatenate([rng.uniform(-2.0, 70.0, 300),
                             [0.0, 63.0, 63.5, -0.5, 12.0]])
    for size in (64, 51):
        np.testing.assert_array_equal(polar_mm.tent_rows(coords, size),
                                      jpolar_mm.tent_rows(coords, size))


@pytest.mark.parametrize("offset,out_size", [(0, None), (7, 51)])
def test_traced_tents_and_window_match_jax(stack, offset, out_size):
    """The traced tent matrices equal JAX's; the fused translate + window
    (bf16 rounding points) within one bf16 ulp of JAX's, equal at
    integer shifts."""
    rng = np.random.default_rng(8)
    shift = np.concatenate([rng.uniform(-3, 3, N - 2), [1.0, -2.0]])
    shift = shift.astype(np.float32)
    got = polar_mm._tent_rows_traced(torch.as_tensor(shift), NX,
                                     torch.float32, offset, out_size)
    want = jpolar_mm._tent_rows_traced(jnp.asarray(shift), NX, jnp.float32,
                                       offset, out_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    if out_size is None:
        return
    sy = np.roll(shift, 3)
    got = polar_mm.translate_window_mm(torch.as_tensor(stack),
                                       torch.as_tensor(shift),
                                       torch.as_tensor(sy), offset, out_size)
    want = np.asarray(jpolar_mm.translate_window_mm(
        jnp.asarray(stack), jnp.asarray(shift), jnp.asarray(sy), offset,
        out_size))
    g16 = got.to(torch.bfloat16).float().numpy()
    w16 = np.asarray(jnp.asarray(want).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    ulp = np.abs(w16) * 2.0 ** -7
    assert (np.abs(g16 - w16) <= ulp + 1e-30).all()
    integer = (shift == np.round(shift)) & (sy == np.round(sy))
    np.testing.assert_array_equal(g16[integer], w16[integer])


GEOMS = [dict(), dict(shift_step=0.5),
         dict(shift_step=0.75, shift_rng_x=1.9, shift_rng_y=1.9),
         dict(ring_scheme="eman2", ring_num=20), dict(mode="H"),
         dict(ring_num=29), dict(shift_step=0.1, shift_rng_x=0.5,
                                 shift_rng_y=0.5)]


@pytest.mark.parametrize("geom", GEOMS)
def test_geometry_and_gate_equal_jax(geom):
    jcfg, cfg = _cfgs(**geom)
    assert ts.template_geometry(cfg) == jts.template_geometry(jcfg)
    assert ts._frac_groups(cfg) == jts._frac_groups(jcfg)
    for k in (1, K, 64, 256, 40000):
        assert (ts.template_supported(cfg, k)
                == jts.template_supported(jcfg, k)), k
        assert (ts._template_blocks_bytes(cfg, k)
                == jts._template_blocks_bytes(jcfg, k))
    assert ts._splat_spectra_bytes(cfg) == jts._splat_spectra_bytes(jcfg)
    # the gate's edges: the overshooting grid pads to 2.25, K=40000's
    # blocks are over the budget, 100 fractional groups are too many and
    # ring 29 + shift 2 + 1 leaves the image
    assert ts.template_supported(cfg, 40000) is False
    if geom.get("shift_step") == 0.75:
        assert ts.template_geometry(cfg)[2] == 3


@pytest.mark.parametrize("geom", [dict(), dict(shift_step=0.5),
                                  dict(ring_scheme="eman2")])
def test_splat_spectra_and_blocks_match_jax(refs, geom):
    jcfg, cfg = _cfgs(**geom)
    want = jax.jit(lambda: jts.splat_spectra_groups(jcfg))()
    got = ts.splat_spectra_groups(cfg)
    flat = (lambda sf: [g for grp in sf for g in grp]) if (
        cfg.ring_scheme == "eman2") else (lambda sf: list(sf))
    for g, w in zip(flat(got), flat(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    jr, tr = _spectra(jcfg, cfg, refs)
    # the column groups (one angle row block of one mirror, shift and
    # reference each) to hold against JAX's template matrix
    n_groups = (2 if cfg.mirror else 1) * cfg.n_shifts * K
    sel = np.unique(np.linspace(0, n_groups - 1, 29).astype(int))
    rows = (sel[:, None] * cfg.ring_len + np.arange(cfg.ring_len)).ravel()

    def jax_side(r):
        blocks = jts.build_template_blocks(r, jcfg)
        return blocks, jts.build_template_matrix(r, jcfg)[rows]

    (tb_w, fids_w, oys_w, oxs_w), wm = jax.jit(jax_side)(jr)
    tb_g, fids_g, oys_g, oxs_g = ts.build_template_blocks(tr, cfg, sf=got)
    for a, b in ((fids_g, fids_w), (oys_g, oys_w), (oxs_g, oxs_w)):
        np.testing.assert_array_equal(a, b)
    w = np.asarray(tb_w.astype(jnp.float32))
    g = tb_g.float().numpy()
    assert g.shape == w.shape and tb_g.dtype == torch.bfloat16
    assert (np.abs(g - w) <= _bf16_ulp(w)).all()
    # the columns the search reads are the blocks' slices in priority
    # order: from JAX's blocks, exactly JAX's template matrix
    wm = np.asarray(wm.astype(jnp.float32))
    blocks = torch.tensor(w).to(torch.bfloat16)
    tm = torch.zeros((cfg.ring_len, wm.shape[1]), dtype=torch.bfloat16)
    for i, grp in enumerate(sel):
        ts._fill_cols(tm, blocks, fids_w, oys_w, oxs_w, cfg, K, int(grp))
        np.testing.assert_array_equal(
            tm.float().numpy(), wm[i * cfg.ring_len:(i + 1) * cfg.ring_len])


# ---- the search -------------------------------------------------------

SEARCHES = {
    "integer": (dict(), "integer", True),
    "zero_ts05": (dict(shift_step=0.5), "zero", True),
    "overshoot": (dict(shift_step=0.75, shift_rng_x=1.9, shift_rng_y=1.9),
                  "integer", True),
    "fractional": (dict(), "fractional", False),
    "nomirror": (dict(mirror=False), "integer", True),
    "mode_h": (dict(mode="H"), "integer", True),
    "eman2": (dict(ring_scheme="eman2"), "integer", True),
}


@pytest.mark.parametrize("case", SEARCHES)
def test_template_search_matches_jax(stack, refs, case):
    geom, kind, exact = SEARCHES[case]
    jcfg, cfg = _cfgs(**geom)
    jp, tp = _params(kind)
    jr, tr = _spectra(jcfg, cfg, refs)
    want = _jit(jts.template_search, cfg=jcfg)(jnp.asarray(stack), jr, jp)
    got = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    same = _assert_winners(got, want, exact)
    if not cfg.mirror:
        assert int(got.best_mirror.max()) == 0
    # decoded params from the agreeing winners
    dg = search.decode_params(got, tp, cfg)
    dw = jsearch.decode_params(want, jp, jcfg)
    for f in ("shift_x", "shift_y", "mirror", "ref_id"):
        np.testing.assert_array_equal(getattr(dg, f).numpy()[same],
                                      np.asarray(getattr(dw, f))[same])
    d = np.abs(dg.angle.numpy() - np.asarray(dw.angle))
    d = np.minimum(d, 360.0 - d)
    assert (d <= _angle_slack(got, want, cfg.angle_step))[same].all()


def test_template_search_with_angle_mask(stack, refs):
    jcfg, cfg = _cfgs()
    jp, tp = _params("integer")
    jr, tr = _spectra(jcfg, cfg, refs)
    mask = search.delta_angle_mask(cfg.ring_len, 15.0)
    want = _jit(jts.template_search, cfg=jcfg)(
        jnp.asarray(stack), jr, jp, angle_mask=jnp.asarray(mask))
    got = ts.template_search(torch.as_tensor(stack), tr, tp, cfg,
                             angle_mask=torch.as_tensor(mask))
    assert (mask[got.best_aidx.numpy()] == 0).all()
    for f in WINNERS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    allowed = mask == 0
    w = np.asarray(want.best_row)[:, allowed]
    np.testing.assert_allclose(got.best_row.numpy()[:, allowed], w, rtol=0,
                               atol=5e-3 * np.abs(w).max())


def test_template_search_k64_streams(stack):
    """K=64, columns streamed from the blocks (JAX's materialized matrix
    would be 20x the blocks), against JAX's streamed search."""
    jcfg, cfg = _cfgs()
    refs = make_disc_stack(np.random.default_rng(64), 64, NX).astype(
        np.float32)
    assert (jts._template_matrix_bytes(jcfg, 64)
            > 20 * ts._template_blocks_bytes(cfg, 64) // 2)
    jp, tp = _params("integer")
    jr, tr = _spectra(jcfg, cfg, refs)
    want = _jit(jts.template_search, cfg=jcfg, stream=True)(
        jnp.asarray(stack), jr, jp)
    got = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    _assert_winners(got, want, exact=False)


@pytest.mark.parametrize("kind", ["integer", "fractional"])
def test_template_search_shc_matches_jax(stack, refs, kind):
    """SHC from thresholds at half or 1.1x each particle's peak (a
    threshold equal to a peak would be decided by rounding)."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(kind)
    jr, tr = _spectra(jcfg, cfg, refs)
    full = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    rng = np.random.default_rng(11)
    pm = (full.best_val.numpy() * rng.choice([0.5, 1.1], N)).astype(
        np.float32)
    want, wfound = _jit(jts.template_search_shc, cfg=jcfg)(
        jnp.asarray(stack), jr, jp, previousmax=jnp.asarray(pm))
    got, found = ts.template_search_shc(torch.as_tensor(stack), tr, tp, cfg,
                                        torch.as_tensor(pm))
    np.testing.assert_array_equal(found.numpy(), np.asarray(wfound))
    assert 0 < int(found.sum()) < N
    f = found.numpy()
    for name in WINNERS:
        np.testing.assert_array_equal(getattr(got, name).numpy()[f],
                                      np.asarray(getattr(want, name))[f],
                                      name)
    np.testing.assert_allclose(got.best_val.numpy()[f],
                               np.asarray(want.best_val)[f], rtol=5e-3)
    # the plain SHC pick on the same thresholds: the same candidates
    plain, pfound = search.rotational_shift_search_shc(
        torch.as_tensor(stack), tr, tp, cfg, torch.as_tensor(pm))
    np.testing.assert_array_equal(pfound.numpy(), f)


def test_ties_go_to_the_first_column():
    """Exact ties (integer operands: every sum is exact in f32) between
    columns in one chunk and across chunks: the flat argmax picks the
    first, as one unchunked argmax over the table would."""
    rng = np.random.default_rng(2)
    ring_len, n_groups, wp = 8, 6, 16
    win = torch.as_tensor(rng.integers(-3, 4, (5, wp)).astype(np.float32))
    base = rng.integers(-3, 4, (2 * ring_len, wp)).astype(np.float32)
    # groups: A B A B A B, and a repeated angle row inside A
    base[ring_len + 3] = base[ring_len + 1]
    base[2] = base[5]
    cols = torch.as_tensor(np.tile(base, (n_groups // 2, 1)))
    table = (win @ cols.T).numpy()
    want = table.argmax(1)
    for chunk in (ring_len, 2 * ring_len, 3 * ring_len, 6 * ring_len):
        val, idx, row = ts._online_argmax(
            win, lambda i: cols[i * chunk:(i + 1) * chunk].to(
                torch.bfloat16), cols.shape[0], chunk, ring_len, "f32")
        np.testing.assert_array_equal(idx.numpy(), want)
        np.testing.assert_array_equal(val.numpy(), table.max(1))
        g = want // ring_len
        np.testing.assert_array_equal(
            row.numpy(), table.reshape(5, n_groups, ring_len)[
                np.arange(5), g])
    assert (want < 2 * ring_len).all()


def test_tf32_route_is_the_same_function(stack, refs, monkeypatch):
    """The route taken where ``torch.mm`` has no bf16 -> f32 overload
    (f32 operands holding bf16 values, TF32 on around the products) gives
    the CPU route's results here, and the switches it sets are restored,
    the global TF32 switch included."""
    _, cfg = _cfgs()
    _, tp = _params("integer")
    tr = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    want = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    mm = torch.backends.cuda.matmul
    before = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    monkeypatch.setattr(ts, "product_route", lambda device: "tf32")
    got = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    assert (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction) \
        == before
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert ts.product_route(torch.device("cpu")) == "tf32"
    monkeypatch.undo()
    assert ts.product_route(torch.device("cpu")) == "f32"


def test_chunk_target_moves_no_winner(stack, refs, monkeypatch):
    jcfg, cfg = _cfgs(shift_step=0.5)
    _, tp = _params("fractional")
    tr = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    want = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    for target in (128, 640, 8192):
        monkeypatch.setattr(ts, "COL_CHUNK_TARGET", target)
        got = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
        for f in WINNERS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        # the CPU's matrix product sums in another order at another width
        np.testing.assert_allclose(got.best_val.numpy(),
                                   want.best_val.numpy(), rtol=1e-6)


# ---- the step, the drivers, the loop, the planner, the CLI ------------

def _stack_k(k, n, seed, noise=0.05, nx=48):
    tmpl = asymmetric_templates(k, nx)
    return tmpl, np.asarray(scattered_stack(tmpl, n, max_shift=1,
                                            noise=noise, seed=seed)[0],
                            np.float32)


E2E = dict(ou=16, xr=1, yr=1, ts=1)


@pytest.mark.parametrize("geom,delta", [(dict(), 0.0),
                                        (dict(ring_scheme="eman2"), 0.0),
                                        (dict(), 15.0)])
def test_align_step_template_matches_jax(geom, delta):
    """One step from the same references, ``--dst``'s angle mask
    included."""
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
    # the class sums: the port's own bilinear step under JAX's params
    plain = steps._finish_step(
        torch.as_tensor(imgs), params_from_numpy(want.params.to_numpy()),
        got.peak, torch.as_tensor(gidx), None, 3)
    s = plain.class_sums.numpy()
    np.testing.assert_allclose(got.class_sums.numpy(), s, rtol=0,
                               atol=1e-4 * np.abs(s).max())
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))


def _driver_diffs(got, want):
    """(particles with the same assignment and mirror, their angle
    differences on the circle, their header-shift differences)."""
    p, q = np.asarray(got.params), np.asarray(want.params)
    same = p[:, 3] == q[:, 3]
    if hasattr(got, "assignments"):
        same &= np.asarray(got.assignments) == np.asarray(want.assignments)
    d = np.abs(p[same, 0] - q[same, 0]) % 360.0
    return same, np.minimum(d, 360.0 - d), np.abs(p[same, 1:3]
                                                 - q[same, 1:3]).max(1)


def _first_iteration_spy(monkeypatch, engine_cls, table):
    """Record the params after the engine's first ``iterate``, in the
    drivers' header convention: the iteration in which both packages
    search against the same references."""
    seen = []
    iterate = engine_cls.iterate

    def spy(self, *args, **kw):
        out = iterate(self, *args, **kw)
        if not seen:
            p = self.params_np()
            seen.append(SimpleNamespace(params=table(p),
                                        assignments=np.asarray(p.ref_id)))
        return out

    monkeypatch.setattr(engine_cls, "iterate", spy)
    return seen


def _spies(monkeypatch):
    """(JAX's first iteration, the port's), filled as the drivers run."""
    return (_first_iteration_spy(monkeypatch, JaxEngine, jax_params_table),
            _first_iteration_spy(monkeypatch, AlignmentEngine,
                                 params_table))


def _assert_first_iteration(got, want):
    """One iteration, the same references in both packages: every
    assignment and mirror equal, header shifts within 1e-3, angles within
    1e-2 degree (bf16 rows move the refined angle of a flat peak by more
    than 1e-3; the search-level tests hold them by the fit's rule)."""
    same, d, ds = _driver_diffs(got, want)
    assert same.all(), np.nonzero(~same)
    assert d.max() < 1e-2 and ds.max() < 1e-3, (d.max(), ds.max())


def _assert_drivers_agree(got, want, angles=True):
    """Several iterations: at least 99% of assignments and mirrors equal,
    and where so (with ``angles``) the median angle within 0.1 degree
    (the module docstring: the references differ from the second
    iteration on, and an SHC pick, the first candidate above a
    threshold, can then move a particle to another candidate)."""
    same, d, _ = _driver_diffs(got, want)
    assert same.mean() >= 0.99, np.nonzero(~same)
    assert not angles or np.median(d) < 0.1, d


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
    """The first iteration, then the case's iterations.  ``--dst``'s
    discrete iteration is the first of 11 and is held to JAX's; over the
    11 the two packages' averages drift apart by their interpolation
    (median 0.17 degree measured), so the last angles are held to the
    port's plain driver, whose class sums are the template path's
    (median 0.04 degree measured), and the last mirrors to JAX's."""
    _, imgs = _stack_k(1, 16, 3)
    kw = dict(ou=16, xr=1.0, ts=1.0, **REFFREE[case])
    first_want, first_got = _spies(monkeypatch)
    want = ali2d_base_tpu(imgs, sampler="template",
                          log=JaxLogger(None, quiet=True), **kw)
    got = ali2d_base(imgs, device="cpu", sampler="template",
                     log=RunLogger(None, quiet=True), **kw)
    assert got.iterations == want.iterations
    _assert_first_iteration(first_got[0], first_want[0])
    _assert_drivers_agree(got, want, angles=case != "dst")
    if case == "dst":
        plain = ali2d_base(imgs, device="cpu", sampler="plain",
                           log=RunLogger(None, quiet=True), **kw)
        _assert_drivers_agree(got, plain)


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
    assert same.mean() >= 0.99
    d = np.abs(got_p.angle.numpy() - np.asarray(want_p.angle))[same] % 360
    assert np.median(np.minimum(d, 360.0 - d)) < 0.1


def test_template_sampler_rules_and_engine():
    """``resolve_sampler`` takes "template" only as asked: SCF, a
    per-particle reference and a geometry outside the gate raise; "auto"
    never picks it; the engine builds the splat spectra once and plans
    with the template footprint."""
    _, cfg = _cfgs()
    for dev in ("cpu", "cuda"):
        assert steps.resolve_sampler("template", dev, cfg) == "template"
        assert steps.resolve_sampler("template", dev, cfg, "SHC") \
            == "template"
        assert steps.resolve_sampler("auto", dev, cfg) != "template"
    for kw, match in ((dict(random_method="SCF"), "SCF"),
                      (dict(per_particle_ref=True), "per_particle_ref"),
                      (dict(n_refs=40000), "geometry gate")):
        with pytest.raises(ValueError, match=match):
            steps.resolve_sampler("template", "cpu", cfg, **kw)
    with pytest.raises(ValueError, match="geometry gate"):
        steps.resolve_sampler("template", "cpu", _cfgs(ring_num=29)[1])
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
    fp = batching.step_footprint(n, 8, cfg, sampler="template")
    kern = batching.step_footprint(n, 8, cfg, sampler="kernel")
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
    b = batching.plan_batch_size(n, 8, cfg, limit_bytes=limit,
                                 sampler="template")
    assert b < n and b & (b - 1) == 0
    assert batching.step_footprint(b, 8, cfg, "template",
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
