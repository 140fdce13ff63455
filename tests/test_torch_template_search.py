"""The template engine's search (``ops/template_search.py``) in the cases
that stream, pick by SHC, tie, take the tf32 route or move the column
chunks, against the JAX package's on the CPU; the rules and sizes of
tests/test_torch_template.py (tests/torch_template_common.py)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from cryo_ralib_tpu_torch.ops import search
from cryo_ralib_tpu_torch.ops import template_search as ts
from tests.conftest import make_disc_stack
from tests.torch_template_common import (N, NX, WINNERS, _assert_winners,
                                         _cfgs, _jit, _params, _spectra,
                                         one_torch_thread, refs, stack)

# the JAX ops package re-exports the function under the module's name
jts = importlib.import_module("cryo_ralib_tpu.ops.template_search")


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
    the CPU route's winners here, and its scores are the CPU route's
    search with the products summed in f32 (the CPU route sums them in
    f64, ``_scores``), bit for bit; the switches it sets are restored,
    the global TF32 switch included."""
    _, cfg = _cfgs()
    _, tp = _params("integer")
    tr = search.prepare_ref_spectra(torch.as_tensor(refs), cfg)
    exact = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    with monkeypatch.context() as m:
        m.setattr(ts, "_scores",
                  lambda win, cols, route: torch.mm(win, cols.float().t()))
        want = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    mm = torch.backends.cuda.matmul
    before = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    monkeypatch.setattr(ts, "product_route", lambda device: "tf32")
    got = ts.template_search(torch.as_tensor(stack), tr, tp, cfg)
    assert (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction) \
        == before
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in WINNERS:
        assert torch.equal(getattr(got, f), getattr(exact, f)), f
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
