"""Differential geometry fuzz of the port's searches against the JAX
package's ``gather`` engine, the exact-semantics reference: the port's
counterpart of tests/test_fuzz_engines.py, with its five sweeps and its
seeds (8 + 6 + 6 + 6 + 4 cases).

The port's own parity tests pin a few geometries; here seeded random
configurations (odd boxes, asymmetric xr/yr, overshooting fractional
steps, few rings, 64-256 samples, full and half rings, with and without
mirrors) go through every search of the port whose gate admits them:
the plain search (``sampler="plain"``), the matmul sampler
(``rotational_shift_search_mm``, ``fast=False``), the template engine
where ``template_supported`` admits the geometry, their SHC picks, and
the eman2 rings' plain and matmul samplers.  The JAX references run
compiled (``jax.jit``), as its drivers run them.

The rule is tests/test_fuzz_engines.py's: each particle's winner
(mirror, shift, reference, angle bin) equals the gather engine's, or the
two peaks lie within 5e-3 relative (the template engine's bf16 tie-swap
tolerance); under an angle mask every winner's bin is an allowed one;
the SHC pick's ``found`` and its (mirror, shift, reference) equal, its
angle bin equal or within 5e-3 relative on the winning row.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.ops import eman_search as jeman
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops.eman_search import (prepare_ref_spectra_eman,
                                                  rotational_shift_search_eman)
from cryo_ralib_tpu_torch.ops.fused_search import search_plain
from cryo_ralib_tpu_torch.ops.search import (delta_angle_mask,
                                             prepare_ref_spectra,
                                             rotational_shift_search_mm,
                                             rotational_shift_search_shc,
                                             rotational_shift_search_shc_mm)
from cryo_ralib_tpu_torch.ops.template_search import (template_search,
                                                      template_search_shc,
                                                      template_supported)
from cryo_ralib_tpu_torch.params import AlignParams
from tests.conftest import make_disc_stack
from tests.torch_template_common import one_torch_thread  # noqa: F401

N, K = 4, 3


def _random_cfg(rng):
    """tests/test_fuzz_engines.py::_random_cfg's draws, as keywords."""
    img_dim = int(rng.choice([48, 56, 64, 75, 90]))
    max_ring = img_dim // 2 - 4
    ring_num = int(rng.integers(8, min(24, max_ring)))
    ring_len = int(rng.choice([64, 128, 256]))
    step = float(rng.choice([0.5, 0.75, 1.0, 2.0]))
    xr = float(rng.choice([1.0, 2.0, 3.0]))
    yr = float(rng.choice([0.0, 1.0, xr]))
    mode = str(rng.choice(["F", "H"]))
    mirror = bool(rng.integers(0, 2))
    return dict(img_dim=img_dim, ring_num=ring_num, ring_len=ring_len,
                shift_step=step, shift_rng_x=xr, shift_rng_y=yr, mode=mode,
                mirror=mirror)


def _random_cfg_with_margin(rng, margin: int):
    """tests/test_fuzz_engines.py::_random_cfg_with_margin's draws."""
    img_dim = int(rng.choice([64, 75, 90]))
    xr = float(rng.choice([1.0, 2.0]))
    max_ring = (img_dim - 1) // 2 - int(xr) - margin
    ring_num = int(rng.integers(8, min(20, max_ring)))
    ring_len = int(rng.choice([64, 128, 256]))
    step = float(rng.choice([0.5, 1.0]))
    yr = float(rng.choice([0.0, xr]))
    mirror = bool(rng.integers(0, 2))
    return dict(img_dim=img_dim, ring_num=ring_num, ring_len=ring_len,
                shift_step=step, shift_rng_x=xr, shift_rng_y=yr,
                mirror=mirror)


def _case(rng, geom, k=K):
    """Both packages' configs, the stack and the references."""
    stack = make_disc_stack(rng, N, geom["img_dim"]).astype(np.float32)
    refs = make_disc_stack(rng, k, geom["img_dim"]).astype(np.float32)
    return JaxConfig(**geom), AlignConfig(**geom), stack, refs


def _params(acc=None):
    """Zero (or integer accumulated) params in both packages' types."""
    p = dict(angle=np.zeros(N, np.float32), shift_x=np.zeros(N, np.float32),
             shift_y=np.zeros(N, np.float32), mirror=np.zeros(N, np.int32),
             ref_id=np.zeros(N, np.int32))
    if acc is not None:
        p["shift_x"], p["shift_y"] = acc[0], acc[1]
    return (JaxParams(*[jnp.asarray(p[f]) for f in JaxParams._fields]),
            AlignParams(*[torch.as_tensor(p[f]) for f in
                          AlignParams._fields]))


def _jax_search(stack, refs, jp, jcfg, mask=None):
    fn = jax.jit(functools.partial(jsearch.rotational_shift_search,
                                   cfg=jcfg, angle_mask=mask))
    return fn(jnp.asarray(stack),
              jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg), jp)


def _port_searches(stack, refs, tp, cfg, mask=None):
    """Every search of the port whose gate admits ``cfg``."""
    imgs = torch.as_tensor(stack)
    rfw = prepare_ref_spectra(torch.as_tensor(refs), cfg)
    out = {"plain": search_plain(imgs, rfw, tp, cfg, angle_mask=mask),
           "matmul": rotational_shift_search_mm(imgs, rfw, tp, cfg,
                                                fast=False, angle_mask=mask)}
    if template_supported(cfg, refs.shape[0]):
        out["template"] = template_search(imgs, rfw, tp, cfg,
                                          angle_mask=mask)
    return out


def _winners(res, i):
    return tuple(int(np.asarray(getattr(res, f))[i]) for f in
                 ("best_mirror", "best_sidx", "best_ref", "best_aidx"))


def _winners_match(res, res_g, name, seed, cfg):
    """The port's winners equal the gather engine's, or the peaks lie
    within 5e-3 relative (tests/test_fuzz_engines.py's rule)."""
    for i in range(N):
        same = _winners(res, i) == _winners(res_g, i)
        got = float(np.asarray(res.best_val)[i])
        want = float(np.asarray(res_g.best_val)[i])
        tol = 5e-3 * max(abs(want), 1e-6)
        assert same or abs(got - want) < tol, (
            f"{name} disagrees with JAX gather on seed {seed} cfg {cfg} "
            f"particle {i}: {_winners(res, i)} vs {_winners(res_g, i)} "
            f"gap {abs(got - want):.3e}")


@pytest.mark.parametrize("seed", range(8))
def test_searches_agree_with_jax_gather_on_random_geometry(seed):
    rng = np.random.default_rng(9000 + seed)
    jcfg, cfg, stack, refs = _case(rng, _random_cfg(rng))
    jp, tp = _params()
    res_g = _jax_search(stack, refs, jp, jcfg)
    for name, res in _port_searches(stack, refs, tp, cfg).items():
        _winners_match(res, res_g, name, seed, cfg)


@pytest.mark.parametrize("seed", range(6))
def test_searches_agree_with_accumulated_shifts(seed):
    """Integer accumulated shifts, inside a margin that keeps every
    sample off the clamp region: each engine's pre-translate stage is
    exact there, so the winners must agree."""
    rng = np.random.default_rng(11000 + seed)
    margin = 4
    jcfg, cfg, stack, refs = _case(rng, _random_cfg_with_margin(rng,
                                                                margin))
    acc = rng.integers(-(margin - 2), margin - 1, size=(2, N)).astype(
        np.float32)
    jp, tp = _params(acc)
    res_g = _jax_search(stack, refs, jp, jcfg)
    for name, res in _port_searches(stack, refs, tp, cfg).items():
        _winners_match(res, res_g, name, seed, cfg)


@pytest.mark.parametrize("seed", range(6))
def test_searches_agree_with_angle_mask(seed):
    """--dst masks on random geometry: every search picks an allowed
    bin, the gather engine's winner or a tie within the rule."""
    rng = np.random.default_rng(12000 + seed)
    geom = _random_cfg(rng)
    delta = float(rng.choice([10.0, 15.0, 30.0, 45.0]))
    jcfg, cfg, stack, refs = _case(rng, geom)
    mask = delta_angle_mask(cfg.ring_len, delta, cfg.mode)
    jp, tp = _params()
    res_g = _jax_search(stack, refs, jp, jcfg, mask=mask)
    allowed = set(int(b) for b in np.nonzero(mask == 0.0)[0])
    for name, res in _port_searches(stack, refs, tp, cfg,
                                    torch.as_tensor(mask)).items():
        _winners_match(res, res_g, name, seed, cfg)
        for i in range(N):
            assert int(res.best_aidx[i]) in allowed, (name, seed, i)


@pytest.mark.parametrize("seed", range(6))
def test_shc_picks_agree_with_jax_gather(seed):
    """The SHC first-passing-candidate pick (plain, matmul, template)
    against JAX's gather SHC, from thresholds spanning never-pass,
    near-peak and always-pass."""
    rng = np.random.default_rng(13000 + seed)
    jcfg, cfg, stack, refs = _case(rng, _random_cfg(rng))
    jp, tp = _params()
    peaks = np.asarray(_jax_search(stack, refs, jp, jcfg).best_val)
    scale = rng.uniform(0.5, 1.2, N).astype(np.float32)
    scale[0] = 2.0            # particle 0 never improves
    pm = peaks * scale
    fn = jax.jit(functools.partial(jsearch.rotational_shift_search_shc,
                                   cfg=jcfg))
    ref_res, ref_found = fn(
        jnp.asarray(stack),
        jsearch.prepare_ref_spectra(jnp.asarray(refs), jcfg), jp,
        previousmax=jnp.asarray(pm))
    imgs = torch.as_tensor(stack)
    rfw = prepare_ref_spectra(torch.as_tensor(refs), cfg)
    pm_t = torch.as_tensor(pm)
    engines = {"plain": rotational_shift_search_shc(imgs, rfw, tp, cfg, pm_t),
               "matmul": rotational_shift_search_shc_mm(imgs, rfw, tp, cfg,
                                                        pm_t, fast=False)}
    if template_supported(cfg, K):
        engines["template"] = template_search_shc(imgs, rfw, tp, cfg, pm_t)
    fr = np.asarray(ref_found)
    assert not fr[0]
    for name, (res, found) in engines.items():
        np.testing.assert_array_equal(found.numpy(), fr,
                                      err_msg=f"{name} seed {seed}")
        for i in np.nonzero(fr)[0]:
            i = int(i)
            assert _winners(res, i)[:3] == _winners(ref_res, i)[:3], (
                f"{name} seed {seed} cfg {cfg} particle {i}")
            ai_e, ai_r = int(res.best_aidx[i]), int(ref_res.best_aidx[i])
            if ai_e != ai_r:
                row = np.asarray(ref_res.best_row[i])
                gap = abs(float(row[ai_e]) - float(row[ai_r]))
                assert gap < 5e-3 * max(abs(float(row[ai_r])), 1e-6), (
                    f"{name} seed {seed} particle {i}: angle bins "
                    f"{ai_e} vs {ai_r} gap {gap:.3e}")


@pytest.mark.parametrize("seed", range(4))
def test_eman_searches_agree_with_jax_gather(seed):
    """The eman2 rings' plain and matmul samplers on random Numrinit
    plans (random first_ring and ring_step) against JAX's gather."""
    rng = np.random.default_rng(14000 + seed)
    img_dim = int(rng.choice([64, 75, 90]))
    xr = float(rng.choice([1.0, 2.0]))
    first = int(rng.integers(1, 4))
    rstep = int(rng.choice([1, 2]))
    max_ring = (img_dim - 1) // 2 - int(xr) - 1
    n_rings = int(rng.integers(6, (max_ring - first) // rstep))
    geom = dict(img_dim=img_dim, ring_num=n_rings, first_ring=first,
                ring_step=rstep, ring_scheme="eman2", shift_step=1.0,
                shift_rng_x=xr, shift_rng_y=xr,
                mirror=bool(rng.integers(0, 2)))
    jcfg, cfg, stack, refs = _case(rng, geom, k=2)
    jp, tp = _params()
    fn = jax.jit(functools.partial(jeman.rotational_shift_search_eman,
                                   cfg=jcfg, sampler="gather"))
    res_g = fn(jnp.asarray(stack),
               jeman.prepare_ref_spectra_eman(jnp.asarray(refs), jcfg), jp)
    imgs = torch.as_tensor(stack)
    rfw = prepare_ref_spectra_eman(torch.as_tensor(refs), cfg)
    for sampler in ("plain", "matmul"):
        res = rotational_shift_search_eman(imgs, rfw, tp, cfg,
                                           sampler=sampler, fast=False)
        _winners_match(res, res_g, "eman-" + sampler, seed, cfg)
