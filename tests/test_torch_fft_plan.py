"""The CPU model of the search kernel's FFT plan (ops/fused_search.py,
``plan_*``) against torch.fft.

The model follows csrc/search.cu's index maps on the same Python-built
twiddle table: rings packed two by two (``ring_pairs``), the 16 x 16
plan with its transpose, the split through the partner thread's
registers, the (DC, Nyquist) slot, the ccf's row order and the packing
of two real rows into one complex inverse.  A fault in those maps shows
here without a card.

Tolerance: 1e-5 of the largest magnitude (f32 rounding of a 256-point
FFT, ~log2(256) x 6e-8, against torch's own f32 FFT).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.ops.ccf import ccf_rows, ccf_spectra, ring_spectra

TOL = 1e-5


def _close(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (err, scale)


def _rings(n, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n, 256), dtype=np.float32))


def _spectra(shape, seed):
    """Random spectra with real DC and Nyquist bins, as C2R reads them."""
    rng = np.random.default_rng(seed)
    spec = torch.as_tensor(rng.standard_normal((*shape, 129, 2),
                                               dtype=np.float32))
    spec = torch.view_as_complex(spec).clone()
    spec[..., 0].imag.zero_()
    spec[..., 128].imag.zero_()
    return spec


def test_fft_twiddles_layout_and_quarter_turns():
    tw = fs.fft_twiddles()
    assert tw.shape == (16, 16, 2) and tw.dtype == np.float32
    e = np.outer(np.arange(16), np.arange(16))    # [k1, j]
    want = np.exp(-2j * np.pi * e / 256)
    np.testing.assert_allclose(tw[..., 0] + 1j * tw[..., 1], want, atol=6e-8)
    # the one quarter turn of the table, j = k1 = 8, is exact
    np.testing.assert_array_equal(tw[8, 8], [0.0, -1.0])
    np.testing.assert_array_equal(tw[0], np.tile([1.0, 0.0], (16, 1)))


@pytest.mark.parametrize("shifts,rings", [(1, 36), (3, 36), (1, 35), (3, 35),
                                          (2, 1)],
                         ids=["R36", "G3-R36", "R35-odd", "G3-R35-odd",
                              "two-rings"])
def test_plan_rfft_matches_torch(shifts, rings):
    """Rings of a shift group in (shift, ring) order; an odd count pairs
    the last ring with zeros."""
    x = _rings(shifts * rings, seed=rings + shifts)
    _close(fs.plan_rfft(x), torch.fft.rfft(x, dim=-1))


@pytest.mark.parametrize("shifts", [1, 2, 3, 4])
@pytest.mark.parametrize("rings", [36, 35, 1])
def test_ring_pairs_cover_the_group_once(shifts, rings):
    """Every (shift, ring) slot of a group lies in one pair, in as many
    FFTs as rings packed two by two; a pair across two shifts holds one
    ring (one radius), and only the last pair of an odd shift with an odd
    ring count holds zeros."""
    pairs = fs.ring_pairs(shifts, rings)
    assert pairs.shape == (-(-shifts * rings // 2), 2)
    slots = pairs[pairs >= 0]
    assert sorted(slots.tolist()) == list(range(shifts * rings))
    cross = pairs[: shifts // 2 * rings]
    assert (cross[:, 1] - cross[:, 0] == rings).all()
    assert (cross[:, 0] % rings == cross[:, 1] % rings).all()
    assert (pairs[:, 1] < 0).sum() == (shifts % 2) * (rings % 2)


@pytest.mark.parametrize("shifts", [2, 3, 4])
@pytest.mark.parametrize("rings", [36, 35])
def test_plan_rfft_on_the_kernels_pairs_matches_torch(shifts, rings):
    """The kernel's pairs of a group of G shifts (ring r at two shifts,
    then an odd shift's neighbours) give every ring its own spectrum."""
    x = _rings(shifts * rings, seed=3 * rings + shifts)
    _close(fs.plan_rfft(x, fs.ring_pairs(shifts, rings)),
           torch.fft.rfft(x, dim=-1))


@pytest.mark.parametrize("n", [36, 35])
def test_plan_rfft_bins_0_and_128_are_real_exactly(n):
    spec = fs.plan_rfft(_rings(n, seed=5))
    assert bool((spec[:, 0].imag == 0).all())
    assert bool((spec[:, 128].imag == 0).all())
    slots = fs.pack_slots(spec)
    assert torch.equal(slots[:, 0].real, spec[:, 0].real)
    assert torch.equal(slots[:, 0].imag, spec[:, 128].real)
    assert torch.equal(slots[:, 1:], spec[:, 1:128])


@pytest.mark.parametrize("n_mirr", [1, 2])
@pytest.mark.parametrize("kg", [1, 8])
@pytest.mark.parametrize("shifts", [1, 3])
def test_plan_irfft_matches_torch(n_mirr, kg, shifts):
    """Rows in the kernel's (shift, ref, mirror) order, two per complex
    inverse: orig and mirror of one ref (NMIRR=2), two refs (NMIRR=1,
    KG=8), two shifts (NMIRR=1, KG=1); an odd count pairs the last row
    with zeros."""
    spec = _spectra((shifts * kg * n_mirr,), seed=kg + n_mirr + shifts)
    rows = fs.plan_irfft(fs.pack_slots(spec / 256))
    _close(rows, torch.fft.irfft(spec, n=256, dim=-1))


@pytest.mark.parametrize("rings,n_mirr,kn", [(36, 2, 8), (35, 2, 8),
                                             (36, 1, 8), (35, 1, 1),
                                             (36, 2, 1), (20, 2, 3)])
def test_plan_search_rows_match_plain(rings, n_mirr, kn):
    """One shift group (G=3) against one ref group through the whole plan
    (forward FFTs, the slot-0 ccf, the inverse) against the plain
    version's ring_spectra -> ccf_spectra -> ccf_rows."""
    g = 3
    rng = np.random.default_rng(rings * 10 + kn)
    polar = torch.as_tensor(rng.standard_normal((g, rings, 256),
                                                dtype=np.float32))
    ref_fw = ring_spectra(torch.as_tensor(
        rng.standard_normal((kn, rings, 256), dtype=np.float32)))
    got = fs.plan_search_rows(polar, ref_fw, n_mirr)     # (G, kn, M, L)
    orig, mirr = ccf_spectra(ring_spectra(polar)[None], ref_fw)
    want = ccf_rows(orig, mirr if n_mirr == 2 else None, 256)[0]  # (M, G, kn, L)
    _close(got, want.permute(1, 2, 0, 3))


@pytest.mark.parametrize("kw", [dict(img_dim=90, ring_num=36),
                                dict(img_dim=64, ring_num=12, ring_step=2,
                                     first_ring=2),
                                dict(img_dim=75, ring_num=20, mode="H"),
                                dict(img_dim=256, ring_num=100)],
                         ids=["headline", "ring-step", "mode-H", "256px"])
def test_polar_tables_give_polar_coords_bitwise(kw):
    """The kernel computes each polar offset as f32(cos * radius) in f64
    from these tables: bitwise the offsets polar_resample reads."""
    from cryo_ralib_tpu_torch.config import AlignConfig

    cfg = AlignConfig(**kw)
    cs, radii = fs.polar_tables(cfg)
    assert cs.shape == (256, 2) and cs.dtype == np.float64
    assert radii.shape == (cfg.ring_num,) and radii.dtype == np.float64
    got = (cs[None, :, :] * radii[:, None, None]).astype(np.float32)
    np.testing.assert_array_equal(got, cfg.polar_coords)
