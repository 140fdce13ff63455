"""The hand-written CUDA search kernel against its plain PyTorch version.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.
They import no JAX, so on the GPU machine they run with::

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_gpu.py

Tolerances: winners (ref, shift, mirror, angle bin) identical on
structured data; peak values and winning rows within 1e-4 of the largest
peak (the kernel's 16 x 16 FFTs against cuFFT in the plain version,
both f32).  Under an angle mask the rows are compared on the
allowed bins only: the kernel's row is unmasked, the plain version's
masked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.ops import search
from cryo_ralib_tpu_torch.ops.search import decode_params, delta_angle_mask
from cryo_ralib_tpu_torch.params import AlignParams, params_from_numpy
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  blob_stack, scattered_stack)

WINNERS = ("best_ref", "best_sidx", "best_mirror", "best_aidx")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(n, dev, seed=2):
    rng = np.random.default_rng(seed)
    return params_from_numpy(
        {"angle": np.zeros(n, np.float32),
         "shift_x": rng.choice([0.0, 1.0, -0.5], n).astype(np.float32),
         "shift_y": rng.choice([0.0, -2.0, 0.25], n).astype(np.float32),
         "mirror": np.zeros(n, np.int32), "ref_id": np.zeros(n, np.int32)},
        dev)


def _edge_params(n, dev, cfg, seed=3):
    """Accumulated shifts that leave some particles' rings inside the box
    and put other rings across its edge (the kernel's clamped path): near
    0, and a few pixels short of, past and far past the distance from
    the outermost ring to the edge."""
    room = cfg.img_dim // 2 - float(cfg.radii[-1]) - 1
    rng = np.random.default_rng(seed)
    steps = np.array([0.0, 0.25, -1.5, room - 2, -(room - 2.5), room + 3.5,
                      -(room + 4.25), room + 9.25, -(room + 12.0)],
                     np.float32)
    return params_from_numpy(
        {"angle": np.zeros(n, np.float32),
         "shift_x": rng.choice(steps, n).astype(np.float32),
         "shift_y": rng.choice(steps, n).astype(np.float32),
         "mirror": np.zeros(n, np.int32), "ref_id": np.zeros(n, np.int32)},
        dev)


def _check(got, want, winners_equal=True, allowed=None):
    torch.cuda.synchronize()
    if winners_equal:
        for f in WINNERS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    scale = want.best_val.abs().max()
    assert (got.best_val - want.best_val).abs().max() <= 1e-4 * scale
    rows = slice(None) if allowed is None else allowed
    assert ((got.best_row[:, rows] - want.best_row[:, rows]).abs().max()
            <= 1e-4 * scale)


# (img_dim, rings, xr, refs, ring_step): the headline, the 160 px box, a
# 256 px box at ou=100, an odd box with a ring count that is no multiple
# of the kernel's ring group, more refs than one ref group, and a
# --ir/--rs ring plan
GEOMETRIES = [(90, 36, 3.0, 8, 1), (160, 48, 2.0, 4, 1),
              (256, 100, 1.0, 2, 1), (75, 20, 2.0, 3, 1),
              (64, 24, 1.0, 11, 1), (90, 12, 2.0, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
def test_kernel_matches_plain(cuda_device, geom):
    nx, rings, xr, k, rs = geom
    cfg = AlignConfig(img_dim=nx, ring_num=rings, ring_step=rs,
                      first_ring=1 + (rs > 1), shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr)
    tmpl = asymmetric_templates(k, nx)
    n = 64
    imgs = scattered_stack(tmpl, n, max_shift=1, noise=0.1, seed=4,
                           device=cuda_device)[0].contiguous()
    params = _params(n, cuda_device)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    before = dict(fs.fused_search.launches)
    got = fs.fused_search(imgs, rfw, params, cfg)
    assert fs.fused_search.launches["search"] == before["search"] + 1
    _check(got, fs.search_plain(imgs, rfw, params, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("mirror", [True, False], ids=["mirror", "nomirror"])
@pytest.mark.parametrize("delta", [0.0, 15.0, 77.0],
                         ids=["unmasked", "dst15", "dst77"])
@pytest.mark.parametrize("geom", [(90, 36, 3.0, 1), (90, 36, 3.0, 8),
                                  (160, 48, 2.0, 4)], ids=str)
def test_kernel_variants_match_plain(cuda_device, geom, delta, mirror):
    """The no-mirror (K2) and angle-mask (K3) variants and both together,
    at K=1 (the reference-free driver) and K>1: winners equal the plain
    version's, masked winners sit on allowed bins, and the refine-free
    decode agrees."""
    nx, rings, xr, k = geom
    cfg = AlignConfig(img_dim=nx, ring_num=rings, shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr, mirror=mirror)
    tmpl = asymmetric_templates(k, nx)
    n = 64
    imgs = scattered_stack(tmpl, n, max_shift=1, noise=0.1, seed=5,
                           device=cuda_device, mirror=mirror)[0].contiguous()
    params = _params(n, cuda_device, seed=7)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    mask = (torch.as_tensor(delta_angle_mask(256, delta), device=cuda_device)
            if delta else None)
    key = fs.variant(cfg, mask is not None)
    before = fs.fused_search.launches[key]
    got = fs.fused_search(imgs, rfw, params, cfg, angle_mask=mask)
    assert fs.fused_search.launches[key] == before + 1
    want = fs.search_plain(imgs, rfw, params, cfg, angle_mask=mask)
    allowed = None if mask is None else mask == 0
    _check(got, want, allowed=allowed)
    if not mirror:
        assert int(got.best_mirror.max()) == 0
    if mask is not None:
        assert bool(allowed[got.best_aidx.long()].all())
        p_got = decode_params(got, params, cfg, refine=False)
        p_want = decode_params(want, params, cfg, refine=False)
        for f in p_got._fields:
            assert torch.equal(getattr(p_got, f), getattr(p_want, f)), f


@pytest.mark.cuda
def test_kernel_large_k_matches_plain(cuda_device):
    """K=64 (eight ref groups in one launch, the large-K case K4), on
    distinct random-blob templates (asymmetric_templates repeat
    themselves, turned by ~1 degree, beyond ~40 classes)."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    tmpl = blob_stack(64, 90, blobs=6, noise=0.0, seed=64)
    imgs = scattered_stack(tmpl, 128, max_shift=1, noise=0.1, seed=9,
                           device=cuda_device)[0].contiguous()
    params = _params(128, cuda_device, seed=4)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    before = fs.fused_search.launches["search"]
    got = fs.fused_search(imgs, rfw, params, cfg)
    assert fs.fused_search.launches["search"] == before + 1
    _check(got, fs.search_plain(imgs, rfw, params, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 60])
def test_kernel_winners_in_the_last_ref_group(cuda_device, k):
    """Every particle made from a reference of the kernel's last group of
    8 (references 56-63 at K=64; 56-59 at K=60, a group of 4), and the
    references before that group at a tenth of their amplitude, so that
    no particle's best candidate lies outside it (the ccf is not
    normalised, so a stronger template of another group could win): each
    block's loop reaches that group, the winners lie in it and equal the
    plain version's, the launch counts under its K, and a step's
    ``step.search`` span records the eight groups."""
    from cryo_ralib_tpu_torch.models.steps import align_step
    from cryo_ralib_tpu_torch.utils import profiling

    cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    tmpl = blob_stack(64, 90, blobs=6, noise=0.0, seed=64)[:k]
    n = 128
    imgs = scattered_stack(tmpl[56:], n, max_shift=1, noise=0.1, seed=13,
                           device=cuda_device)[0].contiguous()
    tmpl[:56] *= 0.1
    params = _params(n, cuda_device, seed=6)
    refs = torch.as_tensor(tmpl, device=cuda_device)
    rfw = search.prepare_ref_spectra(refs, cfg)
    before = fs.fused_search.launches_by_k.get(("search", k), 0)
    got = fs.fused_search(imgs, rfw, params, cfg)
    assert fs.fused_search.launches_by_k[("search", k)] == before + 1
    _check(got, fs.search_plain(imgs, rfw, params, cfg))
    assert int(got.best_ref.min()) >= 56
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.job():
            align_step(imgs, refs, params,
                       torch.arange(n, device=cuda_device), None, cfg,
                       n_classes=k)
    searches = [s for s in profiling.last_job() if s.name == "step.search"]
    assert len(searches) == 1
    assert searches[0].attrs["sampler"] == "kernel"
    assert searches[0].attrs["ref_groups"] == 8
    assert searches[0].attrs["K"] == k


# (img_dim, rings, xr, refs, mirror, mode): shift grids of 49, 25, 9 and
# 1 shifts (a ragged last group of shifts where G does not divide S),
# 256 px at ou=100 (one shift per group), 160 px at ou=48 (at K=4 the
# image read through the cache for a larger G), an odd ring count, K=1
# with and without the mirror channel (one ccf row per shift without
# it), and half rings at G=3 and G=4
SHIFT_GROUPS = [(90, 36, 3.0, 8, True, "F"), (90, 36, 2.0, 8, True, "F"),
                (90, 36, 1.0, 8, True, "F"), (90, 36, 0.0, 8, True, "F"),
                (256, 100, 1.0, 8, True, "F"), (160, 48, 2.0, 4, True, "F"),
                (160, 48, 2.0, 1, False, "F"), (90, 35, 2.0, 8, True, "F"),
                (90, 35, 2.0, 1, True, "F"), (90, 35, 2.0, 1, False, "F"),
                (90, 36, 3.0, 1, False, "F"), (90, 36, 3.0, 8, True, "H"),
                (90, 36, 3.0, 1, True, "H")]


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ["centred", "edge"])
@pytest.mark.parametrize("geom", SHIFT_GROUPS, ids=str)
def test_kernel_shift_groups_match_plain(cuda_device, geom, acc):
    """Winners, peaks and rows equal the plain version's whatever the
    number of shifts per group G (chosen at launch from the shared
    memory), however the last group falls, whether the image is staged
    in shared memory or read through the cache, and whether a ring pair
    lies inside the box (unclamped) or crosses its edge (clamped): on a
    centred stack every ring sampling is counted unclamped, on the edge
    stack some and not all."""
    nx, rings, xr, k, mirror, mode = geom
    cfg = AlignConfig(img_dim=nx, ring_num=rings, shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr, mirror=mirror,
                      mode=mode)
    plan = fs.kernel_plan(rings, mirror, k, cfg.n_shifts, nx, nx)
    assert 1 <= plan["group"] <= min(4, cfg.n_shifts)
    # a 90 px image is staged in shared memory; a 160 px one at K=1 only
    # (at K > 1 it is read through the cache for G > 1); a 256 px one does
    # not fit
    assert plan["image_in_smem"] == (nx == 90 or (nx == 160 and k == 1))
    if rings == 100:
        assert plan["group"] == 1
    if nx == 160 and k > 1:
        assert plan["group"] >= 2
    tmpl = asymmetric_templates(k, nx)
    n = 48
    imgs = scattered_stack(tmpl, n, max_shift=1, noise=0.1, seed=6,
                           device=cuda_device, mirror=mirror)[0].contiguous()
    params = (_params(n, cuda_device, seed=5) if acc == "centred"
              else _edge_params(n, cuda_device, cfg))
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    interior = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    got = fs.fused_search(imgs, rfw, params, cfg, out_interior=interior)
    _check(got, fs.search_plain(imgs, rfw, params, cfg))
    if not mirror:
        assert int(got.best_mirror.max()) == 0
    full = n * cfg.n_shifts * rings
    if acc == "centred":
        assert int(interior.sum()) == full
    else:
        assert 0 < int(interior.sum()) < full


@pytest.mark.cuda
def test_kernel_fractional_shift_step(cuda_device):
    cfg = AlignConfig(img_dim=64, ring_num=20, shift_step=0.5,
                      shift_rng_x=1.0, shift_rng_y=1.5)
    tmpl = asymmetric_templates(3, 64)
    imgs = scattered_stack(tmpl, 32, max_shift=1, noise=0.1, seed=6,
                           device=cuda_device)[0].contiguous()
    params = _params(32, cuda_device, seed=3)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    _check(fs.fused_search(imgs, rfw, params, cfg),
           fs.search_plain(imgs, rfw, params, cfg))


@pytest.mark.cuda
def test_kernel_ties_take_lowest_priority(cuda_device):
    """Identical refs tie exactly; a constant particle ties every
    mirror, shift and angle: the lowest priority index wins."""
    cfg = AlignConfig(img_dim=64, ring_num=24, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    a, b = asymmetric_templates(2, 64)
    refs = torch.as_tensor(np.stack([a, a, b]), device=cuda_device)
    imgs = torch.as_tensor(np.stack([a, np.ones_like(a), b]),
                           device=cuda_device)
    params = AlignParams.zeros(3, cuda_device)
    rfw = search.prepare_ref_spectra(refs, cfg)
    got = fs.fused_search(imgs, rfw, params, cfg)
    want = fs.search_plain(imgs, rfw, params, cfg)
    _check(got, want)
    assert int(got.best_ref[0]) == 0
    assert [int(getattr(got, f)[1]) for f in
            ("best_sidx", "best_mirror", "best_aidx")] == [0, 0, 0]


@pytest.mark.cuda
def test_kernel_pure_noise_mostly_agrees(cuda_device):
    """On pure noise near-ties may flip: at most 1% of particles, and
    then only between peaks within 1e-5 relative."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    rng = np.random.default_rng(8)
    n = 256
    imgs = torch.as_tensor(rng.standard_normal((n, 90, 90), dtype=np.float32),
                           device=cuda_device)
    refs = torch.as_tensor(rng.standard_normal((8, 90, 90), dtype=np.float32),
                           device=cuda_device)
    params = _params(n, cuda_device)
    rfw = search.prepare_ref_spectra(refs, cfg)
    got = fs.fused_search(imgs, rfw, params, cfg)
    want = fs.search_plain(imgs, rfw, params, cfg)
    _check(got, want, winners_equal=False)
    same = torch.ones(n, dtype=torch.bool, device=cuda_device)
    for f in WINNERS:
        same &= getattr(got, f) == getattr(want, f)
    assert int((~same).sum()) <= 0.01 * n
    rel = (got.best_val - want.best_val).abs() / want.best_val.abs()
    assert bool((rel[~same] <= 1e-5).all())


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    imgs = torch.zeros((2, 64, 64), device=cuda_device)
    rfw = torch.zeros((1, 20, 129), dtype=torch.complex64,
                      device=cuda_device)
    params = AlignParams.zeros(2, cuda_device)
    cfg = AlignConfig(img_dim=64, ring_num=20)
    # a geometry outside kernel_gate raises through its rule
    with pytest.raises(ValueError, match="256"):
        fs.fused_search(imgs, rfw, params,
                        AlignConfig(img_dim=64, ring_num=20, ring_len=128))
    with pytest.raises(ValueError, match="shape"):
        fs.fused_search(imgs, rfw, params, cfg,
                        angle_mask=torch.zeros(128, device=cuda_device))
    with pytest.raises(ValueError, match="no angle bin"):
        fs.fused_search(imgs, rfw, params, cfg, angle_mask=torch.full(
            (256,), -3.0e38, device=cuda_device))
    with pytest.raises(TypeError):
        fs.fused_search(imgs.double(), rfw, params, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_search(imgs.transpose(1, 2), rfw, params, cfg)
    with pytest.raises(ValueError, match="shape"):
        fs.fused_search(imgs, rfw[:, :10].contiguous(), params, cfg)


def _random_cfg(rng):
    """A random geometry of the kind tests/test_fuzz_engines.py sweeps
    (odd boxes, asymmetric xr/yr, overshooting fractional steps, small
    ring counts), restricted to what the kernel takes: 256-angle full
    rings with the mirror channel."""
    img_dim = int(rng.choice([48, 56, 64, 75, 90]))
    ring_num = int(rng.integers(8, min(24, img_dim // 2 - 4)))
    xr = float(rng.choice([1.0, 2.0, 3.0]))
    return AlignConfig(img_dim=img_dim, ring_num=ring_num,
                       shift_step=float(rng.choice([0.5, 0.75, 1.0, 2.0])),
                       shift_rng_x=xr,
                       shift_rng_y=float(rng.choice([0.0, 1.0, xr])))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_kernel_matches_plain_random_geometry(cuda_device, seed):
    """Winners equal the plain version's, except between peaks within
    1e-5 relative (f32 rounding of two DFT orders)."""
    rng = np.random.default_rng(9000 + seed)
    cfg = _random_cfg(rng)
    tmpl = asymmetric_templates(3, cfg.img_dim)
    imgs = scattered_stack(tmpl, 16, max_shift=1, noise=0.3, seed=seed,
                           device=cuda_device)[0].contiguous()
    params = _params(16, cuda_device, seed=seed)
    rfw = search.prepare_ref_spectra(
        torch.as_tensor(tmpl, device=cuda_device), cfg)
    got = fs.fused_search(imgs, rfw, params, cfg)
    want = fs.search_plain(imgs, rfw, params, cfg)
    _check(got, want, winners_equal=False)
    same = torch.ones(16, dtype=torch.bool, device=cuda_device)
    for f in WINNERS:
        same &= getattr(got, f) == getattr(want, f)
    rel = (got.best_val - want.best_val).abs() / want.best_val.abs()
    assert bool((rel[~same] <= 1e-5).all()), (cfg, rel[~same])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 1])
@pytest.mark.parametrize("stage", sorted(fs.STAGES))
def test_kernel_ablation_stage_runs(cuda_device, stage, k):
    """Each ablation stage launches, at K=8 and at K=1 (the
    reference-free shape), returns the production shapes and moves its
    own counter only: no search counter, no other stage's."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    tmpl = asymmetric_templates(k, 90)
    imgs = scattered_stack(tmpl, 32, max_shift=1, noise=0.1, seed=3,
                           device=cuda_device)[0].contiguous()
    params = _params(32, cuda_device)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    searches = dict(fs.fused_search.launches)
    stages = dict(fs.fused_search_stage.launches)
    got = fs.fused_search_stage(imgs, rfw, params, cfg, stage)
    torch.cuda.synchronize()
    assert fs.fused_search.launches == searches
    stages[stage] += 1
    assert fs.fused_search_stage.launches == stages
    assert got.best_val.shape == (32,) and got.best_row.shape == (32, 256)
    for f in WINNERS:
        assert getattr(got, f).shape == (32,)
        assert getattr(got, f).dtype == torch.int32
    nomirror = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0,
                           shift_rng_x=3.0, shift_rng_y=3.0, mirror=False)
    with pytest.raises(ValueError, match="mirrored"):
        fs.fused_search_stage(imgs, rfw, params, nomirror, stage)


# (img_dim, rings, xr, refs, mode): the rib80s shapes at K=8 (G=3) and
# K=1 (G=4), half rings, 160 px through the cache (G=2) and 256 px (G=1)
SAMPLE_GEOMETRIES = [(90, 36, 3.0, 8, "F"), (90, 36, 3.0, 1, "F"),
                     (90, 36, 3.0, 8, "H"), (160, 48, 2.0, 4, "F"),
                     (256, 100, 1.0, 2, "F")]


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ["centred", "edge"])
@pytest.mark.parametrize("geom", SAMPLE_GEOMETRIES, ids=str)
def test_kernel_samples_are_polar_resample_bit_for_bit(cuda_device, geom,
                                                       acc):
    """The samples themselves: the sample_only stage leaves in each
    particle's row the largest sample of every thread, floored at 0, so
    the row's largest entry is max(0, the particle's largest sample),
    which must equal bit for bit the largest of ops/polar.py::
    polar_resample over the same shifts.  On noisy images that sample is
    interpolated (no pixel holds it) for most particles.  The edge stack
    runs both paths in one launch, the unclamped and the clamped; the
    centred one the unclamped path alone."""
    from cryo_ralib_tpu_torch.ops.polar import polar_resample

    nx, rings, xr, k, mode = geom
    cfg = AlignConfig(img_dim=nx, ring_num=rings, shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr, mode=mode)
    tmpl = asymmetric_templates(k, nx)
    n = 64
    imgs = scattered_stack(tmpl, n, max_shift=1, noise=1.0, seed=11,
                           device=cuda_device)[0].contiguous()
    params = (_params(n, cuda_device, seed=4) if acc == "centred"
              else _edge_params(n, cuda_device, cfg, seed=12))
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    interior = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    got = fs.fused_search_stage(imgs, rfw, params, cfg, "sample_only",
                                out_interior=interior)
    grid = torch.as_tensor(cfg.shifts, dtype=torch.float32,
                           device=cuda_device)
    polar = polar_resample(
        imgs, torch.as_tensor(cfg.polar_coords, device=cuda_device),
        params.shift_x[:, None] + grid[None, :, 0],
        params.shift_y[:, None] + grid[None, :, 1])      # (N, S, R, L)
    largest = polar.reshape(n, -1).amax(1)
    want = largest.clamp_min(0.0)
    assert torch.equal(got.best_row.amax(1).view(torch.int32),
                       want.view(torch.int32))
    on_pixel = (imgs.reshape(n, -1) == largest[:, None]).any(1)
    assert int(on_pixel.sum()) <= n // 4
    full = n * cfg.n_shifts * rings
    if acc == "centred":
        assert int(interior.sum()) == full
    else:
        assert 0 < int(interior.sum()) < full


@pytest.mark.cuda
def test_kernel_empty_stack_counts_no_launch(cuda_device):
    """An empty stack launches no kernel: the search and every ablation
    stage return empty outputs and leave every launch counter as it
    was."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    tmpl = asymmetric_templates(8, 90)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    imgs = torch.zeros((0, 90, 90), device=cuda_device)
    params = AlignParams.zeros(0, cuda_device)
    mask = torch.as_tensor(delta_angle_mask(256, 15.0), device=cuda_device)
    searches = dict(fs.fused_search.launches)
    stages = dict(fs.fused_search_stage.launches)
    outs = [fs.fused_search(imgs, rfw, params, cfg),
            fs.fused_search(imgs, rfw, params, cfg, angle_mask=mask)]
    outs += [fs.fused_search_stage(imgs, rfw, params, cfg, stage)
             for stage in sorted(fs.STAGES)]
    torch.cuda.synchronize()
    assert fs.fused_search.launches == searches
    assert fs.fused_search_stage.launches == stages
    for got in outs:
        assert got.best_val.shape == (0,) and got.best_row.shape == (0, 256)


# ---- the kernel on half rings (mode "H"), on CTF-filtered images, and
# as the rotation stage of SCF

@pytest.mark.cuda
@pytest.mark.parametrize("mirror", [True, False], ids=["mirror", "nomirror"])
@pytest.mark.parametrize("delta", [0.0, 15.0], ids=["unmasked", "dst15"])
@pytest.mark.parametrize("geom", [(90, 36, 3.0, 8), (90, 36, 3.0, 1),
                                  (90, 36, 0.0, 1), (160, 48, 2.0, 4)],
                         ids=str)
def test_kernel_mode_h_matches_plain(cuda_device, geom, delta, mirror):
    """Half rings: the kernel reads its angles from the same tables as the
    plain search, which span pi at mode H, so every variant (K=8, K=1,
    one shift, masked with the 180-degree ``--dst`` mask, no mirror)
    gives the plain version's winners and the mode-H decode."""
    nx, rings, xr, k = geom
    cfg = AlignConfig(img_dim=nx, ring_num=rings, shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr, mirror=mirror, mode="H")
    tmpl = asymmetric_templates(k, nx)
    n = 64
    imgs = scattered_stack(tmpl, n, max_shift=1, noise=0.1, seed=6,
                           device=cuda_device, mirror=mirror)[0].contiguous()
    params = _params(n, cuda_device, seed=8)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    mask = (torch.as_tensor(delta_angle_mask(256, delta, "H"),
                            device=cuda_device) if delta else None)
    key = fs.variant(cfg, mask is not None)
    before = fs.fused_search.launches[key]
    got = fs.fused_search(imgs, rfw, params, cfg, angle_mask=mask)
    assert fs.fused_search.launches[key] == before + 1
    want = fs.search_plain(imgs, rfw, params, cfg, angle_mask=mask)
    allowed = None if mask is None else mask == 0
    _check(got, want, allowed=allowed)
    refine = mask is None
    p_got = decode_params(got, params, cfg, refine=refine)
    p_want = decode_params(want, params, cfg, refine=refine)
    for f in ("shift_x", "shift_y", "mirror", "ref_id"):
        assert torch.equal(getattr(p_got, f), getattr(p_want, f)), f
    d = (p_got.angle - p_want.angle).abs()
    assert float(torch.minimum(d, 360.0 - d).max()) < 1e-3
    # the same stack on full rings picks other bins: the tables matter
    cfg_f = AlignConfig(img_dim=nx, ring_num=rings, shift_step=1.0,
                        shift_rng_x=xr, shift_rng_y=xr, mirror=mirror)
    full = fs.fused_search(imgs, search.prepare_ref_spectra(
        torch.as_tensor(tmpl, device=cuda_device), cfg_f), params, cfg_f)
    assert not torch.equal(full.best_aidx, got.best_aidx)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 1])
def test_kernel_on_ctf_filtered_images_matches_plain(cuda_device, k):
    """The search kernel is unchanged under ``--CTF``: it sees particles
    premultiplied by their CTFs (oscillating, zero-mean spectra)."""
    from cryo_ralib_tpu_torch.ops.ctf_ops import CtfContext

    nx, n = 90, 64
    cfg = AlignConfig(img_dim=nx, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    tmpl = asymmetric_templates(k, nx)
    imgs = scattered_stack(tmpl, n, max_shift=1, noise=0.1, seed=9,
                           device=cuda_device)[0]
    rng = np.random.default_rng(0)
    ctx = CtfContext(nx, dict(dfu=rng.uniform(8000.0, 25000.0, n), apix=1.7,
                              voltage=200.0), device=cuda_device)
    # once for the microscope (particles seen through their CTFs), once
    # for the premultiplication ``--CTF`` does
    filtered = ctx.premultiply(ctx.premultiply(imgs)).contiguous()
    assert filtered.device.type == "cuda"
    assert not torch.allclose(filtered, imgs, atol=1e-2)
    params = _params(n, cuda_device, seed=10)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    got = fs.fused_search(filtered, rfw, params, cfg)
    _check(got, fs.search_plain(filtered, rfw, params, cfg))


@pytest.mark.cuda
def test_scf_align_kernel_matches_plain(cuda_device):
    """SCF's rotation stage is a K=1, S=1, mode-H search on the scf
    images: through the kernel (one launch) and through the plain search
    the alignment agrees (mirrors and integer shifts equal, angles within
    1e-3 degree where the winning bins agree, which they do here)."""
    from cryo_ralib_tpu_torch.ops.scf import scf_align

    nx, n = 90, 128
    cfg = AlignConfig(img_dim=nx, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0, mode="H")
    tmpl = asymmetric_templates(1, nx)
    imgs = scattered_stack(tmpl, n, max_shift=2, noise=0.1, seed=11,
                           device=cuda_device)[0].contiguous()
    ref = torch.as_tensor(tmpl[0], device=cuda_device)
    before = dict(fs.fused_search.launches)
    got, peak = scf_align(imgs, ref, cfg, sampler="kernel")
    assert fs.fused_search.launches["search"] == before["search"] + 1
    want, want_peak = scf_align(imgs, ref, cfg, sampler="plain")
    assert fs.fused_search.launches["search"] == before["search"] + 1
    for f in ("mirror", "shift_x", "shift_y", "ref_id"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    d = (got.angle - want.angle).abs()
    assert float(torch.minimum(d, 360.0 - d).max()) < 1e-3
    assert ((peak - want_peak).abs().max()
            <= 1e-4 * want_peak.abs().max())


@pytest.mark.cuda
def test_steps_without_a_kernel_launch_none(cuda_device):
    """The eman2 rings, and SHC with two references, run the PyTorch
    search on the card (the explicit rule of ``resolve_route``): no
    launch is counted, and forcing the kernel raises.  SHC with one
    reference has the kernel's SHC pick: one launch a step under "auto"
    and "kernel", none under "plain"."""
    from cryo_ralib_tpu_torch.models.steps import align_step, align_step_shc

    nx, n, k = 64, 32, 2
    tmpl = asymmetric_templates(k, nx)
    imgs = scattered_stack(tmpl, n, max_shift=1, noise=0.1, seed=12,
                           device=cuda_device)[0].contiguous()
    refs = torch.as_tensor(tmpl, device=cuda_device)
    params = AlignParams.zeros(n, cuda_device)
    gidx = torch.arange(n, device=cuda_device)
    geom = dict(img_dim=nx, ring_num=24, shift_step=1.0, shift_rng_x=1.0,
                shift_rng_y=1.0)
    fs.reset_launches()
    pm = torch.full((n,), 1.0e-23, device=cuda_device)
    for sampler, launches in (("auto", 1), ("kernel", 2), ("plain", 2)):
        shc = align_step_shc(imgs, refs[:1], params, gidx, None, pm,
                             AlignConfig(**geom), n_classes=1,
                             sampler=sampler)
        assert int(shc.nope) == 0
        assert fs.fused_search.launches["search_shc"] == launches, sampler
    fs.reset_launches()
    shc = align_step_shc(imgs, refs, params, gidx, None, pm,
                         AlignConfig(**geom), n_classes=k)
    assert int(shc.nope) == 0
    assert not any(fs.fused_search.launches.values())
    with pytest.raises(ValueError, match="sampler='kernel'"):
        align_step_shc(imgs, refs, params, gidx, None, pm,
                       AlignConfig(**geom), n_classes=k, sampler="kernel")
    cfg = AlignConfig(**geom)
    with pytest.raises(ValueError, match="one reference"):
        fs.fused_search_shc(imgs, search.prepare_ref_spectra(refs, cfg),
                            params, cfg, pm)
    out = align_step(imgs, refs, params, gidx, None,
                     AlignConfig(ring_scheme="eman2", **geom), n_classes=k)
    assert int(out.counts.sum()) == n
    assert not any(fs.fused_search.launches.values())
    with pytest.raises(ValueError, match="sampler='kernel'"):
        align_step(imgs, refs, params, gidx, None,
                   AlignConfig(ring_scheme="eman2", **geom), n_classes=k,
                   sampler="kernel")


# ---- the SHC pick (``fused_search_shc``, the kernel's PICK_SHC variant)

def _candidate_peaks(imgs, rfw, params, cfg):
    """(N, M*S*K) row peaks of every SHC candidate, in priority order
    (mirror, shift, ref), from the plain search's rows."""
    from cryo_ralib_tpu_torch.ops.ccf import (ccf_rows, ccf_spectra,
                                              ring_spectra)
    from cryo_ralib_tpu_torch.ops.polar import polar_resample

    tables = search.search_tables(cfg, imgs.device)
    peaks = []
    for s0 in range(0, cfg.n_shifts, 8):
        grid = tables.shifts[s0:s0 + 8]
        sx = params.shift_x[:, None] + grid[None, :, 0]
        sy = params.shift_y[:, None] + grid[None, :, 1]
        orig, mirr = ccf_spectra(ring_spectra(polar_resample(
            imgs, tables.polar_coords, sx, sy)), rfw)
        peaks.append(ccf_rows(orig, mirr if cfg.mirror else None,
                              cfg.ring_len).amax(-1))
    return torch.cat(peaks, dim=2).reshape(imgs.shape[0], -1)


def _check_shc(got, found, groups, want, found_w, pm, peaks, cfg, k):
    """The kernel's SHC pick against the plain one: ``found`` and the
    winners equal, but where a candidate up to either pick has its peak
    within 1e-5 (relative) of ``previousmax``; values and rows within 1e-5
    of the row's largest magnitude, angles equal but where the row's two
    highest bins lie within that of each other; ``out_groups`` the count
    that the plain pick implies.  Returns the mask of the particles held
    exactly."""
    torch.cuda.synchronize()
    s, total = cfg.n_shifts, peaks.shape[1]

    def prio(r, f):
        p = (r.best_mirror.long() * s + r.best_sidx.long()) * k + r.best_ref
        return torch.where(f, p, total - 1)

    upto = torch.maximum(prio(got, found), prio(want, found_w))
    near = (peaks - pm[:, None]).abs() <= 1e-5 * pm.abs()[:, None]
    near &= torch.arange(total, device=pm.device)[None] <= upto[:, None]
    ok = ~near.any(1)
    assert float(ok.float().mean()) >= 0.9
    assert torch.equal(found[ok], found_w[ok])
    for f in ("best_ref", "best_sidx", "best_mirror"):
        assert torch.equal(getattr(got, f)[ok], getattr(want, f)[ok]), f
    both = ok & found
    scale = want.best_row.abs().amax(1)
    assert bool(((got.best_val - want.best_val).abs()
                 <= 1e-5 * scale)[both].all())
    assert bool(((got.best_row - want.best_row).abs().amax(1)
                 <= 1e-5 * scale)[both].all())
    top2 = want.best_row.topk(2, dim=1).values
    clear = both & (top2[:, 0] - top2[:, 1] > 1e-5 * scale)
    assert torch.equal(got.best_aidx[clear], want.best_aidx[clear])
    at = want.best_row.gather(1, got.best_aidx.long()[:, None])[:, 0]
    assert bool((at >= want.best_val - 1e-5 * scale)[both].all())
    none = ok & ~found
    assert bool((got.best_val[none] == -3.0e38).all())
    assert not got.best_row[none].any()
    for f in ("best_ref", "best_sidx", "best_mirror", "best_aidx"):
        assert not getattr(got, f)[none].any(), f
    implied = _implied_groups(want, found_w, s, _shc_group(cfg, k))
    assert torch.equal(groups[ok], implied[ok])
    return ok


def _shc_group(cfg, k):
    """The kernel's shifts per group at this geometry."""
    return fs.kernel_plan(cfg.ring_num, cfg.mirror, k, cfg.n_shifts,
                          cfg.img_dim, cfg.img_dim)["group"]


def _implied_groups(result, found, n_shifts, group):
    """(N,) shift groups that the kernel's early stop runs to reach the
    SHC pick ``result``: up to the winner's group where it is unmirrored,
    else all ``ceil(S / group)`` of them."""
    stop = torch.div(result.best_sidx, group, rounding_mode="floor") + 1
    return torch.where(found & (result.best_mirror == 0), stop,
                       -(-n_shifts // group)).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", ["init", "none", "near", "closer"])
@pytest.mark.parametrize("mirror", [True, False], ids=["mirror", "nomirror"])
def test_kernel_shc_matches_plain(cuda_device, mirror, thresholds):
    """``fused_search_shc`` (one PICK_SHC launch) against
    ``rotational_shift_search_shc`` at the headline geometry and K=1 (the
    kernel's SHC pick takes one reference), with and without the mirror
    channel: ``previousmax`` 1e-23 (every particle stops after its first
    shift group), 3e38 (nothing passes:
    the plain version's fields), 0.98 x each particle's exhaustive peak
    (picks across the whole grid) and 0.999 x (where a mirrored particle
    picks a mirrored candidate after every shift group: the ring means
    keep the unmirrored peaks within 2% of the best)."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0, mirror=mirror)
    k, n = 1, 64
    tmpl = asymmetric_templates(k, 90)
    imgs = scattered_stack(tmpl, n, max_shift=2, noise=0.3, seed=13,
                           device=cuda_device, mirror=mirror)[0].contiguous()
    params = _params(n, cuda_device, seed=14)
    rfw = search.prepare_ref_spectra(torch.as_tensor(tmpl,
                                                     device=cuda_device), cfg)
    pm = {"init": lambda: torch.full((n,), search.PREVIOUSMAX_INIT,
                                     device=cuda_device),
          "none": lambda: torch.full((n,), 3.0e38, device=cuda_device),
          "near": lambda: 0.98 * fs.search_plain(imgs, rfw, params,
                                                 cfg).best_val,
          "closer": lambda: 0.999 * fs.search_plain(imgs, rfw, params,
                                                    cfg).best_val
          }[thresholds]()
    key = fs.variant(cfg, False, shc=True)
    before = fs.fused_search.launches[key]
    groups = torch.full((n,), -1, dtype=torch.int32, device=cuda_device)
    got, found = fs.fused_search_shc(imgs, rfw, params, cfg, pm,
                                     out_groups=groups)
    assert fs.fused_search.launches[key] == before + 1
    want, found_w = search.rotational_shift_search_shc(imgs, rfw, params,
                                                       cfg, pm)
    ok = _check_shc(got, found, groups, want, found_w, pm,
                    _candidate_peaks(imgs, rfw, params, cfg), cfg, k)
    full = -(-cfg.n_shifts // _shc_group(cfg, k))
    if thresholds == "init":
        assert bool(found.all()) and bool((groups == 1).all())
    if thresholds == "none":
        assert bool(ok.all()) and not bool(found.any())
        assert bool((groups == full).all())
        for f in search.SearchResult._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    if thresholds in ("near", "closer"):
        assert bool(found.all())
        assert len(set(got.best_sidx.tolist())) >= 4
        assert int(groups.min()) < int(groups.max())
    if thresholds == "closer" and mirror:
        assert bool((got.best_mirror == 1).any())
        assert bool((groups[got.best_mirror == 1] == full).all())


@pytest.mark.cuda
def test_kernel_shc_streamed_matches_resident(cuda_device):
    """SHC through the engine on the card: "auto" launches the SHC pick
    once an iteration on a resident stack and once a batch on a streamed
    one, and both give the same params and ``previousmax`` bit for bit
    (a block searches one particle); the plain engine, which launches
    nothing, leaves nearly every particle at the same mirror and shifts
    (a pick moves only where a candidate's peak sits at its threshold)."""
    cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    tmpl = asymmetric_templates(1, 90)
    n, batch, iters = 96, 40, 3
    imgs = scattered_stack(tmpl, n, max_shift=2, noise=0.3,
                           seed=15)[0].numpy()
    refs = imgs.mean(0)[None]
    out = {}
    for name, kw in (("resident", {}), ("streamed", {"batch_size": batch}),
                     ("plain", {"sampler": "plain"})):
        fs.reset_launches()
        eng = AlignmentEngine(imgs, cfg, n_classes=1, device=cuda_device,
                              random_method="SHC", **kw)
        assert eng.resident == (name != "streamed")
        for _ in range(iters):
            eng.iterate(refs)
        out[name] = (eng.params_np(), eng.previousmax_np(),
                     fs.fused_search.launches["search_shc"])
    assert out["resident"][2] == iters
    assert out["streamed"][2] == iters * -(-n // batch)
    assert out["plain"][2] == 0
    for f in AlignParams._fields:
        assert np.array_equal(getattr(out["resident"][0], f),
                              getattr(out["streamed"][0], f)), f
    assert np.array_equal(out["resident"][1], out["streamed"][1])
    got, want = out["resident"][0], out["plain"][0]
    same = ((got.mirror == want.mirror) & (got.shift_x == want.shift_x)
            & (got.shift_y == want.shift_y))
    assert same.mean() >= 0.9


# ---- the class-sum kernel (``fused_class_sums``, csrc/class_sums.cu)

def _sum_case(n, k, box, dev, seed, mirrors=True, valid=False):
    """Particles, random params (``mirrors`` or none) and an odd-started
    global index on ``dev``; ``valid`` drops about a fifth of them."""
    rng = np.random.default_rng(seed)
    params = params_from_numpy(
        {"angle": rng.uniform(0, 360, n).astype(np.float32),
         "shift_x": rng.uniform(-3, 3, n).astype(np.float32),
         "shift_y": rng.uniform(-3, 3, n).astype(np.float32),
         "mirror": (rng.integers(0, 2, n) if mirrors
                    else np.zeros(n)).astype(np.int32),
         "ref_id": rng.integers(0, k, n).astype(np.int32)}, dev)
    images = torch.as_tensor(
        rng.standard_normal((n, box, box)).astype(np.float32), device=dev)
    gidx = torch.arange(n, device=dev) + 11
    mask = (torch.as_tensor((rng.random(n) > 0.2).astype(np.float32),
                            device=dev) if valid else None)
    return images, params, gidx, mask


def _plain_sums(images, params, k, gidx, mask):
    from cryo_ralib_tpu_torch.ops.classavg import class_sum_oe
    from cryo_ralib_tpu_torch.ops.transform import transform_batch

    return class_sum_oe(transform_batch(images, params), params.ref_id, k,
                        global_index=gidx, valid=mask)


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("mirrors", [True, False],
                         ids=["mirrors", "nomirror"])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("box", [90, 160])
def test_class_sum_kernel_matches_plain(cuda_device, box, k, mirrors, valid):
    """The sums within 1e-12 of the largest magnitude (f64 sums in
    another order), the counts equal, two calls bit for bit; an odd N."""
    from cryo_ralib_tpu_torch.ops.classavg import fused_class_sums

    images, params, gidx, mask = _sum_case(3001, k, box, cuda_device,
                                           seed=box + k, mirrors=mirrors,
                                           valid=valid)
    got, counts = fused_class_sums(images, params, k, gidx, mask)
    want, want_counts = _plain_sums(images, params, k, gidx, mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    assert torch.equal(counts, want_counts)
    again, again_counts = fused_class_sums(images, params, k, gidx, mask)
    assert torch.equal(again, got) and torch.equal(again_counts, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("box", [90, 75, 160])
def test_class_sum_kernel_samples_are_transform_batch_bit_for_bit(
        cuda_device, box, k):
    """One particle a slot: each slot's sum is that particle's transformed
    image, which must equal ``transform_batch``'s on the card exactly."""
    from cryo_ralib_tpu_torch.ops.classavg import fused_class_sums
    from cryo_ralib_tpu_torch.ops.transform import transform_batch

    n = 2 * k
    images, params, _, _ = _sum_case(n, k, box, cuda_device, seed=k)
    params = params._replace(ref_id=torch.arange(
        n, dtype=torch.int32, device=cuda_device) // 2)
    gidx = torch.arange(n, device=cuda_device)
    got, counts = fused_class_sums(images, params, k, gidx)
    want = transform_batch(images, params)
    assert torch.equal(got.reshape(n, box, box).float(), want)
    assert bool((counts == 2).all())


@pytest.mark.cuda
def test_class_sum_kernel_sums_a_ref_share(cuda_device):
    """Under a ``ref`` split each rank sums its ``ref_slice`` share as the
    plain route sums it, and the shares add up to the whole."""
    from types import SimpleNamespace

    from cryo_ralib_tpu_torch.models.steps import _finish_step
    from cryo_ralib_tpu_torch.parallel.mesh import ref_slice

    n, k = 1001, 8
    images, params, gidx, mask = _sum_case(n, k, 90, cuda_device, seed=3,
                                           valid=True)
    peak = torch.zeros(n, device=cuda_device)
    whole = _finish_step(images, params, peak, gidx, mask, k, "kernel")
    total = torch.zeros_like(whole.class_sums)
    for rank in range(3):
        mesh = SimpleNamespace(ref=3, ref_rank=rank)
        a, b = ref_slice(n, mesh)
        out = _finish_step(images, params, peak, gidx, mask, k, "kernel",
                           mesh=mesh)
        want, want_counts = _plain_sums(
            images[a:b], AlignParams(*[f[a:b] for f in params]), k,
            gidx[a:b], mask[a:b])
        assert (out.class_sums - want).abs().max() <= (
            1e-12 * want.abs().max())
        assert torch.equal(out.counts, want_counts)
        total += out.class_sums
    assert (total - whole.class_sums).abs().max() <= (
        1e-12 * whole.class_sums.abs().max())


@pytest.mark.cuda
def test_class_sum_kernel_launches_once_a_step(cuda_device):
    """``launches`` counts one per ``_finish_step`` call that sums
    particles, none for an empty stack (zero sums and counts); a traced
    job's ``step.sums`` spans say ``sums="kernel"``; a launch makes no
    host sync."""
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.steps import _finish_step
    from cryo_ralib_tpu_torch.ops.classavg import fused_class_sums
    from cryo_ralib_tpu_torch.utils import profiling
    from cryo_ralib_tpu_torch.utils.log import RunLogger

    images, params, gidx, _ = _sum_case(301, 4, 90, cuda_device, seed=4)
    before = fused_class_sums.launches
    for _ in range(2):
        _finish_step(images, params, torch.zeros(301, device=cuda_device),
                     gidx, None, 4, "kernel")
    assert fused_class_sums.launches == before + 2
    empty = _finish_step(images[:0], AlignParams(*[f[:0] for f in params]),
                         torch.zeros(0, device=cuda_device), gidx[:0], None,
                         4, "kernel")
    assert fused_class_sums.launches == before + 2
    assert not empty.class_sums.any() and not empty.counts.any()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused_class_sums(images, params, 4, gidx)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    tmpl = asymmetric_templates(2, 48)
    imgs = scattered_stack(tmpl, 64, max_shift=1, seed=6)[0].numpy()
    before = fused_class_sums.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        mref_ali2d(imgs, tmpl, ou=16, xr=1, ts=1, maxit=2,
                   device=cuda_device, log=RunLogger(None, quiet=True))
    spans = [s for s in profiling.last_job() if s.name == "step.sums"]
    assert len(spans) == 2
    assert all(s.attrs["sums"] == "kernel" for s in spans)
    assert fused_class_sums.launches == before + 2
