"""The port's search (the module that holds the CUDA kernel) against the
JAX package's searches on the CPU.

The kernel's own checks on the card are in tests/test_torch_kernel_gpu.py,
which imports no JAX.

Tolerances: winners (ref, shift, mirror, angle bin) exactly equal; peak
values within 1e-5 of the largest peak (f32 FFT against an f32 matmul
DFT); decoded angles within 1e-3 degrees (the parabolic fit amplifies
value rounding); decoded shifts exactly equal (grid lookup and f32 add).
Against the JAX Pallas kernel, which samples in bf16, values only agree
to 5e-3 relative.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu.ops.fused_search import fused_search as jax_fused_search
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils.synthetic import (asymmetric_templates,
                                            scattered_stack)
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.ops import search
from cryo_ralib_tpu_torch.params import params_from_numpy

WINNERS = ("best_ref", "best_sidx", "best_mirror", "best_aidx")


def _cfgs(nx=64, rings=24, xr=2.0, mirror=True):
    kw = dict(img_dim=nx, ring_num=rings, ring_len=256, shift_step=1.0,
              shift_rng_x=xr, shift_rng_y=xr, mirror=mirror)
    return JaxConfig(**kw), AlignConfig(**kw)


def _jax_params(n, sx=None, sy=None):
    z = np.zeros(n, np.float32)
    return JaxParams(jnp.asarray(z),
                     jnp.asarray(z if sx is None else sx),
                     jnp.asarray(z if sy is None else sy),
                     jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32))


def _np(result):
    return {f: np.asarray(getattr(result, f)) for f in result._fields}


def _assert_decoded_match(port_res, jax_res, tp, jp, cfg, jcfg,
                          refine=True):
    got = search.decode_params(port_res, tp, cfg, refine=refine)
    want = jsearch.decode_params(jax_res, jp, jcfg, refine=refine)
    d = np.abs(got.angle.numpy() - np.asarray(want.angle))
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    for f in ("shift_x", "shift_y", "mirror", "ref_id"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_prepare_ref_spectra_matches_jax():
    jcfg, cfg = _cfgs()
    refs = asymmetric_templates(3, 64)
    want = np.asarray(jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg))
    got = search.prepare_ref_spectra(torch.as_tensor(refs), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shift_chunk", [8, 25])
def test_plain_search_matches_jax_gather(shift_chunk):
    """(a) winners, values and decoded params against the JAX gather
    search, with integer and fractional accumulated shifts."""
    jcfg, cfg = _cfgs()
    k, n = 3, 12
    refs = asymmetric_templates(k, 64)
    imgs, _, _, _ = scattered_stack(refs, n, max_shift=2, seed=7)
    rng = np.random.default_rng(17)
    sx = rng.choice([0.0, 1.0, -2.0, 0.5, -0.75], n).astype(np.float32)
    sy = rng.choice([0.0, -1.0, 2.0, 0.25, 1.5], n).astype(np.float32)
    jp = _jax_params(n, sx, sy)
    rfw = jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg)
    want = jax.jit(functools.partial(jsearch.rotational_shift_search,
                                     cfg=jcfg))(jnp.asarray(imgs), rfw, jp)
    tp = params_from_numpy(jp.to_numpy())
    got = search.rotational_shift_search(
        torch.as_tensor(imgs), torch.as_tensor(np.array(rfw)), tp, cfg,
        shift_chunk=shift_chunk)
    g, w = _np(got), _np(want)
    for f in WINNERS:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    scale = np.abs(w["best_val"]).max()
    np.testing.assert_allclose(g["best_val"], w["best_val"], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(g["best_row"], w["best_row"], rtol=0,
                               atol=1e-5 * scale)
    _assert_decoded_match(got, want, tp, jp, cfg, jcfg)


@pytest.mark.parametrize("mirror,delta", [(False, 0.0), (True, 15.0),
                                          (False, 15.0), (True, 77.0)])
def test_plain_search_variants_match_jax_gather(mirror, delta):
    """The no-mirror and angle-masked searches (the kernel's K2 and K3
    variants) against JAX ``rotational_shift_search(angle_mask=...)``
    with ``cfg.mirror`` set; masked results decode with refine=False.
    JAX's own tests hold that function against the Pallas kernel in
    interpret mode (tests/test_delta.py, tests/test_modes.py)."""
    jcfg, cfg = _cfgs(mirror=mirror)
    k, n = 2, 12
    refs = asymmetric_templates(k, 64)
    imgs, _, _, _ = scattered_stack(refs, n, max_shift=2, seed=11)
    rng = np.random.default_rng(5)
    sx = rng.choice([0.0, 1.0, -0.5], n).astype(np.float32)
    jp = _jax_params(n, sx, -sx)
    mask = search.delta_angle_mask(256, delta) if delta else None
    rfw = jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg)
    want = jsearch.rotational_shift_search(
        jnp.asarray(imgs), rfw, jp, jcfg,
        angle_mask=None if mask is None else jnp.asarray(mask))
    tp = params_from_numpy(jp.to_numpy())
    got = search.rotational_shift_search(
        torch.as_tensor(imgs), torch.as_tensor(np.array(rfw)), tp, cfg,
        angle_mask=mask)
    g, w = _np(got), _np(want)
    for f in WINNERS:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    scale = np.abs(w["best_val"]).max()
    np.testing.assert_allclose(g["best_val"], w["best_val"], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(g["best_row"], w["best_row"], rtol=0,
                               atol=1e-5 * scale)
    if not mirror:
        assert (g["best_mirror"] == 0).all()
    if mask is not None:
        assert (mask[g["best_aidx"]] == 0).all()
    _assert_decoded_match(got, want, tp, jp, cfg, jcfg, refine=mask is None)


@pytest.mark.parametrize("ring_len,delta,mode", [
    (256, 15.0, "F"), (256, 77.0, "F"), (128, 90.0, "H"), (256, 400.0, "F")])
def test_delta_angle_bins_and_mask_equal_jax(ring_len, delta, mode):
    np.testing.assert_array_equal(
        search.delta_angle_bins(ring_len, delta, mode),
        jsearch.delta_angle_bins(ring_len, delta, mode))
    mask = search.delta_angle_mask(ring_len, delta, mode)
    np.testing.assert_array_equal(
        mask, jsearch.delta_angle_mask(ring_len, delta, mode))
    assert mask.dtype == np.float32 and mask[0] == 0.0
    with pytest.raises(ValueError):
        search.delta_angle_bins(ring_len, 0.0, mode)


def test_decode_params_without_refinement_matches_jax():
    """refine=False: the exact bin angle (360 - step * bin, +180 wrapped
    on the mirrored branch); the row is never read."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(21)
    n = 10
    fields = {"best_val": rng.standard_normal(n).astype(np.float32),
              "best_row": np.full((n, 256), -3.0e38, np.float32),
              "best_aidx": rng.integers(0, 256, n).astype(np.int32),
              "best_sidx": rng.integers(0, cfg.n_shifts, n).astype(np.int32),
              "best_ref": rng.integers(0, 3, n).astype(np.int32),
              "best_mirror": (np.arange(n) % 2).astype(np.int32)}
    fields["best_aidx"][:2] = [0, 128]
    jp = _jax_params(n, rng.uniform(-1, 1, n).astype(np.float32))
    got = search.decode_params(
        search.SearchResult(*[torch.as_tensor(fields[f])
                              for f in search.SearchResult._fields]),
        params_from_numpy(jp.to_numpy()), cfg, refine=False)
    want = jsearch.decode_params(
        jsearch.SearchResult(*[jnp.asarray(fields[f])
                               for f in jsearch.SearchResult._fields]),
        jp, jcfg, refine=False)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    # bin 0 unmirrored stays 360 (no wrap on that branch); bin 128
    # mirrored is 180 + 180, wrapped to 0
    np.testing.assert_array_equal(got.angle.numpy()[:2], [360.0, 0.0])


def test_plain_search_matches_jax_pallas_interpret():
    """(b) the structured stack of test_fused_recovers_structured against
    the JAX Pallas kernel in interpret mode (bf16 sampling).  The stack is
    built from asymmetric_templates: class_templates are dihedral, so their
    mirror flag is a tie that bf16 rounding decides."""
    jcfg, cfg = _cfgs()
    k, n = 3, 12
    base = asymmetric_templates(k, 64)
    imgs, cls, _, _ = scattered_stack(base, n, max_shift=2, seed=23)
    rfw = jsearch.prepare_ref_spectra(jnp.asarray(base), jcfg)
    jp = _jax_params(n)
    want = jax_fused_search(jnp.asarray(imgs), rfw, jp, jcfg, interpret=True)
    got = search.rotational_shift_search(
        torch.as_tensor(imgs), torch.as_tensor(np.array(rfw)),
        params_from_numpy(jp.to_numpy()), cfg)
    g, w = _np(got), _np(want)
    for f in ("best_ref", "best_sidx", "best_mirror"):
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    assert (g["best_ref"] == cls).all()
    np.testing.assert_allclose(g["best_val"], w["best_val"], rtol=0,
                               atol=5e-3 * np.abs(w["best_val"]).max())


def test_forced_ties_pick_the_jax_winner():
    """(c) identical refs tie exactly; a constant particle ties every
    (mirror, shift, angle) candidate of a ref.  The winner is the lowest
    priority index, as one unchunked JAX argmax picks it."""
    jcfg, cfg = _cfgs(xr=1.0)
    a, b = asymmetric_templates(2, 64)
    refs = np.stack([a, a, b])
    imgs = np.stack([a, np.ones_like(a), b]).astype(np.float32)
    n = imgs.shape[0]
    jp = _jax_params(n)
    rfw = jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg)
    want = jax.jit(functools.partial(
        jsearch.rotational_shift_search, cfg=jcfg,
        shift_chunk=cfg.n_shifts))(jnp.asarray(imgs), rfw, jp)
    got = search.rotational_shift_search(
        torch.as_tensor(imgs), torch.as_tensor(np.array(rfw)),
        params_from_numpy(jp.to_numpy()), cfg, shift_chunk=2)
    g, w = _np(got), _np(want)
    for f in WINNERS:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    assert g["best_ref"][0] == 0            # ref 0 and ref 1 tie
    # constant particle: every mirror, shift and angle ties
    assert [g[f][1] for f in ("best_sidx", "best_mirror", "best_aidx")] \
        == [0, 0, 0]
    assert g["best_ref"][2] == 2


def test_update_best_takes_lowest_priority_on_ties():
    """(c) the fold rule on a crafted table: ties across shift chunks
    between a mirrored early shift and an unmirrored late shift go to the
    unmirrored one (mirror is the outermost priority axis)."""
    n, m, s, k, ring_len = 3, 2, 5, 2, 8
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((n, m, s, k, ring_len)).astype(np.float32)
    rows[0, 1, 0, 1, 3] = rows[0, 0, 4, 0, 6] = 9.0     # mirror vs late shift
    rows[1, 0, 2, 1, 5] = rows[1, 0, 2, 0, 7] = 9.0     # ref tie
    rows[2, 1, 1, 0, 2] = rows[2, 1, 3, 0, 0] = 9.0     # shift tie, mirrored
    flat = rows.reshape(n, -1).argmax(1)
    want = np.stack(np.unravel_index(flat, (m, s, k, ring_len)), 1)
    init = search.SearchResult(
        torch.full((n,), -3.0e38), torch.zeros((n, ring_len)),
        *[torch.zeros(n, dtype=torch.int32) for _ in range(4)])
    for chunk in (1, 2, 5):
        best = init
        for s0 in range(0, s, chunk):
            best = search._update_best(
                best, torch.as_tensor(rows[:, :, s0:s0 + chunk]), s0, s, k)
        got = np.stack([best.best_mirror.numpy(), best.best_sidx.numpy(),
                        best.best_ref.numpy(), best.best_aidx.numpy()], 1)
        np.testing.assert_array_equal(got, want, err_msg=f"chunk={chunk}")
        assert (best.best_val.numpy() == 9.0).all()
    np.testing.assert_array_equal(want[:, :3], [[0, 4, 0], [0, 2, 0],
                                                [1, 1, 0]])


def test_cpu_wrapper_runs_plain_version():
    """(d) a CPU tensor takes the plain version; no kernel launch."""
    _, cfg = _cfgs(xr=1.0)
    refs = torch.as_tensor(asymmetric_templates(2, 64))
    imgs = refs[torch.tensor([1, 0, 1])] + 0.01
    params = params_from_numpy(_jax_params(3).to_numpy())
    rfw = search.prepare_ref_spectra(refs, cfg)
    before = dict(fs.fused_search.launches)
    got = fs.fused_search(imgs, rfw, params, cfg)
    assert fs.fused_search.launches == before
    want = search.rotational_shift_search(imgs, rfw, params, cfg)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_array_equal(got.best_ref.numpy(), [1, 0, 1])
    mask = search.delta_angle_mask(256, 90.0)
    masked = fs.fused_search(imgs, rfw, params, cfg, angle_mask=mask)
    assert fs.fused_search.launches == before
    want = search.rotational_shift_search(imgs, rfw, params, cfg,
                                          angle_mask=mask)
    for f in got._fields:
        assert torch.equal(getattr(masked, f), getattr(want, f)), f


def test_twiddle_table_quarter_turns_exact():
    tab = fs.twiddle_table()
    assert tab.dtype == np.float32 and tab.shape == (256,)
    np.testing.assert_array_equal(tab[[0, 64, 128, 192]], [1, 0, -1, 0])
    np.testing.assert_allclose(tab, np.cos(2 * np.pi * np.arange(256) / 256),
                               atol=6e-8)
