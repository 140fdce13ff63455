"""The FFT-shear warp of the port (``ops/transform.py::transform_batch_mm``,
``rot_shift2d(engine="shear")``, ``ops/classavg.py::class_sum_transform_mm``,
``ops/fourvar.py`` with ``engine="shear"``) against the JAX package's on
the CPU, the JAX functions compiled (``jax.jit``) as its drivers run them.

Inputs: noisy 48 and 47 px particles (odd and even boxes, both padded to
128), angles in all four quadrants and on the +-45 degree residual edges
(45, 135, 225, 315, -45 and -135 exactly, as a ``--dst`` iteration
decodes them), fractional shifts, mirrors.  Each test states its bound
with the value it measured:

* ``fast=False``: the port's f32 FFTs against JAX's f32 matmul DFTs,
  within 1e-4 of the output's largest value;
* ``fast=True``: both packages round the same operands to bf16 (the
  port's DFTs are bf16 products as JAX's are, ``ops/transform.py``), so
  they agree to f32 rounding op by op (``test_dfts_match_jax``); over
  the warp's seven
  DFTs an f32 value an ulp apart (XLA fuses the complex products of its
  compiled program) now and then rounds to the neighbouring bf16 step,
  which moves a whole row by a bf16 step of a large coefficient: the
  port lies 1.7e-3 of the largest value from JAX's compiled warp and
  8.5e-4 from its uncompiled one, and JAX's compiled warp 1.7e-3 from
  its own uncompiled one (measured on this stack's random angles; on the
  edges the uncompiled one picks the other quadrant, see
  ``ops/transform.py::_QUADRANT``);
* an f32 FFT in place of the bf16 DFTs, the measurement behind the
  choice: ``test_f32_fft_is_further_from_jax_fast``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from cryo_ralib_tpu.ops import classavg as jclassavg
from cryo_ralib_tpu.ops import fourvar as jfourvar
from cryo_ralib_tpu.ops import transform as jtransform
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils.synthetic import asymmetric_templates
from cryo_ralib_tpu_torch.ops import classavg, fourvar, transform
from cryo_ralib_tpu_torch.ops.masks import model_circle
from cryo_ralib_tpu_torch.params import params_from_numpy
from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack
from tests.torch_template_common import one_torch_thread

N, K = 24, 3
EDGES = [0.0, 45.0, 135.0, 225.0, 315.0, -45.0, -135.0, 90.0, 180.0, 270.0,
         44.99, 134.99]


def _stack(nx, seed=3):
    tmpl = asymmetric_templates(K, nx)
    return scattered_stack(tmpl, N, max_shift=1, noise=0.3,
                           seed=seed)[0].numpy()


def _params(seed=1):
    """The edge angles, then random ones; fractional shifts, mirrors and
    classes, in both packages' types."""
    rng = np.random.default_rng(seed)
    ang = np.concatenate([EDGES, rng.uniform(0, 360, N - len(EDGES))])
    p = dict(angle=ang.astype(np.float32),
             shift_x=rng.uniform(-2, 2, N).astype(np.float32),
             shift_y=rng.uniform(-2, 2, N).astype(np.float32),
             mirror=rng.integers(0, 2, N).astype(np.int32),
             ref_id=rng.integers(0, K, N).astype(np.int32))
    return (JaxParams(*[jnp.asarray(p[f]) for f in JaxParams._fields]),
            params_from_numpy(p))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_warp(fast):
    return jax.jit(lambda x, p: jtransform.transform_batch_mm(x, p,
                                                              fast=fast))


@pytest.mark.parametrize("fast", [False, True])
def test_dfts_match_jax(fast):
    """One DFT along the last axis, forward and inverse, against JAX's
    ``rfft_mm`` / ``irfft_mm``: within 1e-6 of the largest value
    (measured 2.3e-7 and 1.8e-7 at ``fast=True``), the f32 FFT's and the
    bf16 matmul's alike."""
    from cryo_ralib_tpu.ops import dft as jdft

    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    spec = np.fft.rfft(x).astype(np.complex64)
    want = jax.jit(lambda a: jdft.rfft_mm(a, fast=fast))(jnp.asarray(x))
    assert _rel(transform._rfft(torch.as_tensor(x), fast), want) < 1e-6
    want = jax.jit(lambda a: jdft.irfft_mm(a, 128, fast=fast))(
        jnp.asarray(spec))
    got = transform._irfft(torch.as_tensor(spec), 128, fast)
    assert _rel(got, want) < 1e-6


# fast -> bound on the largest difference over the largest value;
# measured: 48 px 1.4e-6 / 1.7e-3, 47 px 1.1e-6 / 1.8e-3
WARP_BOUND = {False: 1e-4, True: 5e-3}


@pytest.mark.parametrize("nx", [48, 47])
@pytest.mark.parametrize("fast", [False, True])
def test_transform_batch_mm_matches_jax(nx, fast):
    imgs = _stack(nx)
    jp, tp = _params()
    want = _jax_warp(fast)(jnp.asarray(imgs), jp)
    got = transform.transform_batch_mm(torch.as_tensor(imgs), tp, fast=fast)
    assert got.shape == (N, nx, nx) and got.dtype == torch.float32
    assert _rel(got, want) < WARP_BOUND[fast], _rel(got, want)


def test_f32_fft_is_further_from_jax_fast():
    """The port at ``fast=False`` (f32 FFTs) lies within 1e-4 of JAX at
    ``fast=False`` (measured 1.4e-6) but 3e-3 to 2e-2 of the largest
    value from JAX at ``fast=True``, the drivers' setting (measured
    8.3e-3); the port at ``fast=True`` lies less than half as far
    (measured 1.7e-3, 5x closer): the bf16 DFT matrices are part of the
    function."""
    imgs = _stack(48)
    jp, tp = _params()
    want_fast = _jax_warp(True)(jnp.asarray(imgs), jp)
    want_f32 = _jax_warp(False)(jnp.asarray(imgs), jp)
    f32 = transform.transform_batch_mm(torch.as_tensor(imgs), tp, fast=False)
    bf16 = transform.transform_batch_mm(torch.as_tensor(imgs), tp, fast=True)
    assert _rel(f32, want_f32) < 1e-4
    assert 3e-3 < _rel(f32, want_fast) < 2e-2, _rel(f32, want_fast)
    assert _rel(bf16, want_fast) < 0.5 * _rel(f32, want_fast)


def test_transform_batch_mm_blocks_equal_one_call(monkeypatch):
    """A stack over ``shear_block`` particles goes by blocks, with one
    call's result to f32 rounding (12 particles, blocks of 4)."""
    imgs = torch.as_tensor(_stack(48))[:12]
    _, tp = _params()
    tp = type(tp)(*[f[:12] for f in tp])
    whole = transform.transform_batch_mm(imgs, tp, fast=True)
    monkeypatch.setattr(transform, "shear_block", lambda h: 4)
    blocked = transform.transform_batch_mm(imgs, tp, fast=True)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=1e-5)


@pytest.mark.parametrize("nx", [48, 47])
def test_rot_shift2d_shear_matches_jax(nx):
    """``rot_shift2d(engine="shear")`` (f32 DFTs, as JAX's): within 1e-4
    of the largest value (measured 1.0e-6 and 1.4e-6), the mirror
    post-flip included; "auto" stays quadri, as JAX's "auto" off a
    TPU."""
    imgs = _stack(nx)
    jp, _ = _params()
    args = [np.asarray(f) for f in (jp.angle, jp.shift_x, jp.shift_y,
                                    jp.mirror)]
    want = jax.jit(lambda x, a, sx, sy, m: jtransform.rot_shift2d(
        x, a, sx, sy, m, engine="shear"))(jnp.asarray(imgs), *args)
    got = transform.rot_shift2d(torch.as_tensor(imgs), *args, engine="shear")
    assert _rel(got, want) < 1e-4, _rel(got, want)
    quadri = transform.rot_shift2d(torch.as_tensor(imgs), *args)
    assert torch.equal(quadri, transform.rot_shift2d(
        torch.as_tensor(imgs), *args, engine="quadri"))


# fast -> bound on the class sums' largest difference over their largest
# value; measured 7.7e-7 / 6.5e-4
SUM_BOUND = {False: 1e-4, True: 2e-3}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_class_sum_transform_mm_matches_jax(fast, masked):
    """The (class, parity, mirror) sums on the spectra, with an odd
    first global index (the parity of every particle flips) and with
    padding particles excluded by ``valid``: counts equal, sums within
    ``SUM_BOUND`` of JAX's."""
    imgs = _stack(48)
    jp, tp = _params()
    gidx = np.arange(N, dtype=np.int32) + 7
    valid = ((np.arange(N) < N - 5).astype(np.float32) if masked
             else None)
    want_s, want_c = jax.jit(
        lambda x, p, g, v: jclassavg.class_sum_transform_mm(
            x, p, K, global_index=g, valid=v, fast=fast))(
        jnp.asarray(imgs), jp, jnp.asarray(gidx),
        None if valid is None else jnp.asarray(valid))
    got_s, got_c = classavg.class_sum_transform_mm(
        torch.as_tensor(imgs), tp, K, global_index=torch.as_tensor(gidx),
        valid=None if valid is None else torch.as_tensor(valid), fast=fast)
    assert got_s.shape == (K, 2, 48, 48) and got_s.dtype == torch.float64
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert _rel(got_s, want_s) < SUM_BOUND[fast], _rel(got_s, want_s)


def test_class_sum_transform_mm_is_the_warp_summed(monkeypatch):
    """The sums on the spectra equal ``class_sum_oe`` of the warped
    stack (the final inverse DFT and flip hoisted past the sum), and a
    stack over ``shear_block`` particles sums by blocks to the same,
    within 1e-5 of the largest value (12 particles, blocks of 4)."""
    imgs = torch.as_tensor(_stack(48))[:12]
    _, tp = _params()
    tp = type(tp)(*[f[:12] for f in tp])
    gidx = torch.arange(12) + 3
    got, counts = classavg.class_sum_transform_mm(imgs, tp, K,
                                                  global_index=gidx,
                                                  fast=False)
    want, want_c = classavg.class_sum_oe(
        transform.transform_batch_mm(imgs, tp), tp.ref_id, K,
        global_index=gidx)
    assert torch.equal(counts, want_c)
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    monkeypatch.setattr(classavg, "shear_block", lambda h: 4)
    blocked, _ = classavg.class_sum_transform_mm(imgs, tp, K,
                                                 global_index=gidx,
                                                 fast=False)
    torch.testing.assert_close(blocked, got, rtol=0, atol=tol)


# fast -> bound on the moments' largest difference over their largest
# value; measured 3.3e-7 / 1.9e-4
MOMENT_BOUND = {False: 1e-4, True: 1e-3}


@pytest.mark.parametrize("fast", [False, True])
def test_fourier_moments_shear_matches_jax(fast):
    """``fourier_moments(engine="shear")`` (the default) with a mask and
    ``valid``: the count equal, each moment within ``MOMENT_BOUND``."""
    imgs = _stack(48)
    jp, tp = _params()
    mask = np.asarray(model_circle(16, 48), np.float32)
    valid = (np.arange(N) < N - 3).astype(np.float32)
    want = jax.jit(lambda x, p, m, v: jfourvar.fourier_moments(
        x, p, mask=m, valid=v, fast=fast))(
        jnp.asarray(imgs), jp, jnp.asarray(mask), jnp.asarray(valid))
    got = fourvar.fourier_moments(torch.as_tensor(imgs), tp, mask=mask,
                                  valid=torch.as_tensor(valid), fast=fast)
    assert float(got[3]) == float(want[3]) == N - 3
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == (48, 25)
        assert _rel(g, w) < MOMENT_BOUND[fast], _rel(g, w)


@pytest.mark.parametrize("engine", ["shear", "exact"])
def test_fourier_variance_matches_jax(engine):
    """``fourier_variance`` in chunks of 10 with a short last one, both
    engines at the defaults of both packages: the variance and its radial
    profile within 2e-3 of their largest value (measured shear 4.1e-5 /
    2.3e-5, exact 1.6e-7 / 1.4e-7), and the criterion ``ali2d_base``
    takes after dividing an average by it within a ratio of 0.8-1.25
    (measured shear 0.99998, exact 1.0): the division weighs the
    smallest bins, ~1e-3 of the largest."""
    imgs = _stack(48)
    jp, tp = _params()
    mask = np.asarray(model_circle(16, 48), np.float32)
    want_v, want_r = jfourvar.fourier_variance(
        imgs, JaxParams(*[np.asarray(f) for f in jp]), mask=mask, batch=10,
        engine=engine)
    got_v, got_r = fourvar.fourier_variance(
        torch.as_tensor(imgs), tp, mask=torch.as_tensor(mask), batch=10,
        engine=engine)
    assert _rel(got_v, want_v) < 2e-3 and _rel(got_r, want_r) < 2e-3
    avg = imgs.mean(0)

    def criterion(var):
        t = fourvar.divide_by_variance(avg, var)
        return float(np.sum(t * t * mask))

    ratio = criterion(got_v) / criterion(want_v)
    assert 0.8 < ratio < 1.25, ratio


def test_engines_are_checked():
    imgs = torch.as_tensor(_stack(48))
    _, tp = _params()
    with pytest.raises(ValueError, match="engine"):
        fourvar.fourier_moments(imgs, tp, engine="fft")
    with pytest.raises(ValueError, match="square"):
        transform.transform_batch_mm(imgs[:, :, :40], tp)
