"""The port's template engine (``ops/template_search.py``, with the tent
helpers of ``ops/polar_mm.py``) against the JAX package's on the CPU,
op by op, at the sizes of tests/test_template.py (64 px, K=3,
ring_len=128); the search's other cases are in
tests/test_torch_template_search.py, the step, drivers, loop, planner
and command line in tests/test_torch_template_drivers.py
(tests/torch_template_common.py holds their shared helpers).

Tolerances: the copied numpy helpers, the geometry and the gate exactly
equal; splat spectra within 1e-5 of their largest value (f32 FFT against
a matmul DFT); template blocks within one bf16 ulp plus 1e-6 of their
largest value (their f32 inputs differ by rounding); winners exactly
equal at integer accumulated shifts and, at fractional ones, equal
except where the two peaks are within 5e-3 relative (tests/test_template.py's
tie rule: both engines round their window and columns to bf16); rows
within 5e-3 of their largest value; decoded shifts equal where winners
agree, and angles within 1e-3 degree plus twice the change that the
7-point fit takes to first order from the two rows' difference
(chip_smoke.py's rule: a flat peak turns a bf16-level row difference
into more than 1e-3 degree).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from cryo_ralib_tpu.ops import polar_mm as jpolar_mm
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu_torch.ops import polar_mm, search
from cryo_ralib_tpu_torch.ops import template_search as ts
from tests.torch_template_common import (K, N, NX, WINNERS, _angle_slack,
                                         _assert_winners, _bf16_ulp, _cfgs,
                                         _jit, _params, _spectra,
                                         one_torch_thread, refs, stack)

# the JAX ops package re-exports the function under the module's name
jts = importlib.import_module("cryo_ralib_tpu.ops.template_search")


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
