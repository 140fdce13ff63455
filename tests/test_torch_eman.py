"""The eman2 ring scheme in the port (``ops/eman_search.py``,
``align_step`` with ``cfg.ring_scheme == "eman2"``) against the JAX
package's gather formulation on the CPU, and against the numpy oracle
``utils/oracle.py::align_particle_eman_np`` as tests/test_eman_scheme.py
holds the JAX one.

Tolerances: ring groups and their coordinates exactly equal; reference
spectra within 1e-5 of their largest value; winners exactly equal, peak
values and rows within 1e-5 of the largest peak; decoded angles within
1e-3 degree; against the f64 oracle angles within 5e-3 degree and peaks
within 1e-3 relative, the JAX test's own bars.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.ops import eman_search as jeman
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils import oracle
from cryo_ralib_tpu.utils.synthetic import blob_stack
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops import eman_search as eman
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.ops import search
from cryo_ralib_tpu_torch.params import params_from_numpy

NX, N, K = 48, 10, 3
WINNERS = ("best_ref", "best_sidx", "best_mirror", "best_aidx")


def _cfgs(**kw):
    base = dict(img_dim=NX, ring_num=16, ring_scheme="eman2",
                shift_step=1.0, shift_rng_x=2.0, shift_rng_y=1.0)
    base.update(kw)
    return JaxConfig(**base), AlignConfig(**base)


@pytest.fixture(scope="module")
def stack():
    return blob_stack(N, NX, blobs=3, seed=61).astype(np.float32)


@pytest.fixture(scope="module")
def refs():
    return blob_stack(K, NX, blobs=3, seed=95).astype(np.float32)


def _params(seed):
    rng = np.random.default_rng(seed)
    sx = rng.choice([0.0, 1.0, -1.0, 0.5], N).astype(np.float32)
    z = np.zeros(N, np.float32)
    jp = JaxParams(jnp.asarray(z), jnp.asarray(sx), jnp.asarray(-sx),
                   jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32))
    return jp, params_from_numpy(jp.to_numpy())


@pytest.mark.parametrize("geom", [dict(), dict(ring_num=9, first_ring=3,
                                               ring_step=2)])
def test_eman_groups_equal_jax(geom):
    jcfg, cfg = _cfgs(**geom)
    assert cfg.ring_len == jcfg.ring_len == cfg.eman_rings[-1][1]
    got, want = eman.eman_groups(cfg), jeman.eman_groups(jcfg)
    assert len(got) == len(want) > 1
    for (ln, idx, coords), (wln, widx, wcoords) in zip(got, want):
        assert ln == wln
        np.testing.assert_array_equal(idx, widx)
        np.testing.assert_array_equal(coords, wcoords)
    with pytest.raises(ValueError, match="eman2"):
        eman.eman_groups(AlignConfig(img_dim=NX, ring_num=16))


def test_prepare_ref_spectra_eman_matches_jax(refs):
    jcfg, cfg = _cfgs()
    want = jeman.prepare_ref_spectra_eman(jnp.asarray(refs), jcfg)
    got = eman.prepare_ref_spectra_eman(torch.as_tensor(refs), cfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("geom,mirror,delta", [
    (dict(), True, 0.0), (dict(), False, 0.0), (dict(), True, 30.0),
    (dict(shift_step=0.5, shift_rng_x=1.0, shift_rng_y=0.5), True, 0.0),
    (dict(shift_rng_y=0.0), True, 0.0),
])
def test_eman_search_matches_jax_gather(stack, refs, geom, mirror, delta):
    """Winners under the non-contiguous global shift index (the loop
    walks dy with every dx per step), with accumulated shifts."""
    jcfg, cfg = _cfgs(mirror=mirror, **geom)
    jp, tp = _params(3)
    mask = (search.delta_angle_mask(cfg.ring_len, delta) if delta else None)
    want = jeman.rotational_shift_search_eman(
        jnp.asarray(stack), jeman.prepare_ref_spectra_eman(jnp.asarray(refs),
                                                           jcfg),
        jp, jcfg, sampler="gather",
        angle_mask=None if mask is None else jnp.asarray(mask))
    got = eman.rotational_shift_search_eman(
        torch.as_tensor(stack),
        eman.prepare_ref_spectra_eman(torch.as_tensor(refs), cfg), tp, cfg,
        angle_mask=mask)
    for f in WINNERS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    scale = np.abs(np.asarray(want.best_val)).max()
    for f in ("best_val", "best_row"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-5 * scale, err_msg=f)
    assert len(np.unique(got.best_sidx.numpy())) > 1 or cfg.n_shifts == 1
    refine = mask is None
    p_got = search.decode_params(got, tp, cfg, refine=refine)
    p_want = jsearch.decode_params(want, jp, jcfg, refine=refine)
    for f in ("ref_id", "mirror", "shift_x", "shift_y"):
        np.testing.assert_array_equal(getattr(p_got, f).numpy(),
                                      np.asarray(getattr(p_want, f)))
    d = np.abs(p_got.angle.numpy() - np.asarray(p_want.angle))
    assert np.minimum(d, 360.0 - d).max() < 1e-3


def test_eman_search_matches_oracle(stack, refs):
    _jcfg, cfg = _cfgs()
    tp = params_from_numpy(JaxParams.zeros(N).to_numpy())
    res = eman.rotational_shift_search_eman(
        torch.as_tensor(stack),
        eman.prepare_ref_spectra_eman(torch.as_tensor(refs), cfg), tp, cfg)
    new = search.decode_params(res, tp, cfg)
    rings = list(cfg.eman_rings)
    for i in range(N):
        want = oracle.align_particle_eman_np(
            stack[i].astype(np.float64), refs.astype(np.float64), rings,
            cfg.shifts, 0.0, 0.0, cfg.shift_limit)
        assert int(new.mirror[i]) == want["mirror"], i
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.shift_x[i]) - want["shift_x"]) < 1e-4
        assert abs(float(new.shift_y[i]) - want["shift_y"]) < 1e-4
        assert abs(float(new.angle[i]) - want["angle"]) < 5e-3
        assert (abs(float(res.best_val[i]) - want["peak"])
                < 1e-3 * abs(want["peak"]))


def test_kernel_wrapper_refuses_eman_rings(stack, refs):
    """``cfg.ring_len`` is maxrin, not 256: the kernel's launch check
    refuses the scheme rather than searching other rings."""
    _jcfg, cfg = _cfgs()
    assert cfg.ring_len != fs.RING_LEN
    tp = params_from_numpy(JaxParams.zeros(N).to_numpy())
    with pytest.raises((NotImplementedError, ValueError)):
        fs._launch(torch.as_tensor(stack), torch.zeros(K, 16, 129,
                                                       dtype=torch.complex64),
                   tp, cfg, None, 0, fs.fused_search.launches, "search")
    assert not any(fs.fused_search.launches.values())


def test_eman_search_in_particle_blocks_is_the_same(stack, refs, monkeypatch):
    """A stack over the sample budget is searched in blocks of particles
    (a memory rule only): the same winners, values to f32 rounding (the
    batch size changes the order of the FFTs' and products' sums)."""
    _jcfg, cfg = _cfgs()
    _jp, tp = _params(5)
    rfw = eman.prepare_ref_spectra_eman(torch.as_tensor(refs), cfg)
    whole = eman.rotational_shift_search_eman(torch.as_tensor(stack), rfw,
                                              tp, cfg)
    per_particle = 5 * max(c.shape[0] * c.shape[1]
                           for _l, c, _w in eman.eman_tables(
                               cfg, torch.device("cpu")).groups)
    monkeypatch.setattr(eman, "PLAIN_SAMPLE_BUDGET", 3 * per_particle)
    blocks = eman.rotational_shift_search_eman(torch.as_tensor(stack), rfw,
                                               tp, cfg)
    for f in WINNERS:
        assert torch.equal(getattr(whole, f), getattr(blocks, f)), f
    torch.testing.assert_close(blocks.best_val, whole.best_val, rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(blocks.best_row, whole.best_row, rtol=0,
                               atol=1e-5 * float(whole.best_val.max()))
