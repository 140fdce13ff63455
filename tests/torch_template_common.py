"""Shared helpers of the template engine's tests
(``tests/test_torch_template*.py``): the port's template engine
(``ops/template_search.py``, with the tent helpers of ``ops/polar_mm.py``)
against the JAX package's on the CPU, at the sizes of
tests/test_template.py (64 px, K=3, ring_len=128), and the rules that
hold two alignment drivers to each other (also read by
tests/test_torch_matmul.py).
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models.engine import AlignmentEngine as JaxEngine
from cryo_ralib_tpu.ops import eman_search as jeman
from cryo_ralib_tpu.ops import search as jsearch
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.params import params_table as jax_params_table
from cryo_ralib_tpu.utils.synthetic import (asymmetric_templates,
                                            scattered_stack)
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.ops import eman_search, search
from cryo_ralib_tpu_torch.params import params_from_numpy, params_table
from tests.conftest import make_class_bases, make_disc_stack

NX, K, N = 64, 3, 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test's PyTorch work on one intra-op thread: the suite runs in
    six worker processes on a few cores, where a worker's idle OpenMP
    threads, waiting by spinning, take cores from the others; these
    tests' tensors are small enough that one thread loses nothing."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
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



# ---- end to end ------------------------------------------------------

def _stack_k(k, n, seed, noise=0.05, nx=48):
    tmpl = asymmetric_templates(k, nx)
    return tmpl, np.asarray(scattered_stack(tmpl, n, max_shift=1,
                                            noise=noise, seed=seed)[0],
                            np.float32)


E2E = dict(ou=16, xr=1, yr=1, ts=1)


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


def _assert_drivers_agree(got, want, median: float = 0.05):
    """Several iterations, both packages summing their classes by the FFT
    shear: every assignment and mirror equal, and the median angle
    difference within ``median`` degree (the bf16 rows and class sums
    move a refined angle a little in either package; measured medians
    in each test's docstring)."""
    same, d, _ = _driver_diffs(got, want)
    assert same.all(), np.nonzero(~same)
    assert np.median(d) < median, (np.median(d), d)
