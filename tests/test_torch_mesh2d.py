"""The port's 2-D ``('dp', 'ref')`` mesh (``parallel/mesh.py::make_mesh_2d``)
on the CPU: the particles split over ``dp``, the references over
``ref``, the ranks of a particle block merging their slices' winners by
the search's own rule (``ops/search.py::merge_ref_slices``).

First the merge alone, in one process: every search of the port split
into reference slices and merged, against the unsplit search.  Then the
rank layout against the JAX package's ``make_mesh_2d``.  Then four gloo
ranks, each a process of its own started here through ``subprocess`` and
joined through a file store in ``tmp_path`` (as
tests/test_torch_distributed.py runs two), at (dp=2, ref=2) and (dp=1,
ref=4), against one process of the port and against the JAX package's
2-D mesh on conftest's 8 virtual CPU devices.  The workers run every case
once (a module fixture), on one intra-op thread each, and import no jax:
each asserts ``"jax" not in sys.modules`` at its end.

Tolerances.  The merge's rule is exact: merged over slices of the same
candidates it gives the unsplit winners bit for bit, ties included.  A
search run on a slice computes its ccf values with another shape (BLAS
blocks a product by its widths), so a slice's values may differ from the
unsplit search's in their last bits: there winners are held equal and
values and rows within 1e-6 of the largest (1e-4 for the template
engine's bf16 products, whose f32 sums follow the product's width).  Against one process: counts,
assignments and mirrors equal, params within 1e-3 (angles on the
circle), class sums within 1e-5 of their largest.  Against JAX:
tests/test_mesh2d.py::_check_equal's rules (counts, ref_id and mirror
equal; angles within 1e-3; class sums within 5e-4 of the largest;
``sx_sum`` within 1e-3).  The template and matmul samplers on ranks are
held to one process as tests/test_torch_distributed.py holds the
template engine: angles and shifts within 1e-2, assignments equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import mref_ali2d_tpu
from cryo_ralib_tpu.models.steps import make_align_step
from cryo_ralib_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from cryo_ralib_tpu.parallel.mesh import shard_stack as jax_shard_stack
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import (make_device_loop,
                                         make_mref_device_loop)
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.models.steps import resolve_route
from cryo_ralib_tpu_torch.ops.ccf import ccf_rows, ccf_spectra, ring_spectra
from cryo_ralib_tpu_torch.ops.fused_search import search_plain
from cryo_ralib_tpu_torch.ops.polar import polar_resample
from cryo_ralib_tpu_torch.ops.search import (SearchResult, _update_best,
                                             empty_result, merge_ref_slices,
                                             prepare_ref_spectra,
                                             rotational_shift_search_mm,
                                             search_tables)
from cryo_ralib_tpu_torch.ops.template_search import template_search
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.parallel import mesh as pm
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack,
                                                  unit_sigma_blobs)
from tests.torch_template_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, OU, XR = 48, 16, 1
GEOM = dict(img_dim=NX, ring_num=OU, ring_len=256, shift_step=1.0,
            shift_rng_x=float(XR), shift_rng_y=float(XR))
MREF = dict(ou=OU, xr=XR, yr=XR, ts=1, maxit=2)
N = 24            # particles; (dp=2) blocks of 12, shares of 6
WORLD = 4
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4)}
JAX_LAYOUTS = {"2x2": (4, 2), "1x4": (2, 4)}   # the same ref split on 8
RANK_TIMEOUT = 150   # seconds, each worker process


# ---- the merge alone, in one process --------------------------------
def _slices(edges):
    return list(zip(edges[:-1], edges[1:]))


_STACK_REDUCE = {"max": lambda t: t.amax(0), "min": lambda t: t.amin(0),
                 "sum": lambda t: t.sum(0)}


def merge_slice_results(parts, n_shifts, n_refs):
    """``merge_ref_slices`` in one process over a list of ``(SearchResult,
    k0)``, one per reference slice: the slices stacked along a first axis
    and reduced along it by the same rule as the all-reduces of a ref
    group."""
    stacked = SearchResult(*[torch.stack(f) for f in
                             zip(*[res for res, _ in parts])])
    k0 = torch.tensor([k for _, k in parts], dtype=torch.int64)[:, None]

    def reduce(t, op):
        return _STACK_REDUCE[op](t)

    return merge_ref_slices(stacked, k0, n_shifts, n_refs, reduce)


SPLITS = {"2x4": [0, 2, 4, 6, 8], "4x2": [0, 4, 8], "3+5": [0, 3, 8],
          "3+empty+5": [0, 3, 3, 8]}


def _search_case(k=8, n=12, seed=3):
    base = asymmetric_templates(k, NX)
    imgs = scattered_stack(base, n, max_shift=1, noise=0.1, seed=seed)[0]
    rng = np.random.default_rng(seed)
    params = AlignParams(
        angle=torch.zeros(n),
        shift_x=torch.as_tensor(rng.uniform(-1, 1, n), dtype=torch.float32),
        shift_y=torch.as_tensor(rng.uniform(-1, 1, n), dtype=torch.float32),
        mirror=torch.zeros(n, dtype=torch.int32),
        ref_id=torch.zeros(n, dtype=torch.int32))
    return AlignConfig(**GEOM), imgs.contiguous(), torch.as_tensor(base), \
        params


def _candidate_rows(imgs, refs, params, cfg):
    """The unsplit search's ccf rows (N, 2, S, K, L), all shifts at
    once."""
    tables = search_tables(cfg, imgs.device)
    grid = tables.shifts
    sx = params.shift_x[:, None] + grid[None, :, 0]
    sy = params.shift_y[:, None] + grid[None, :, 1]
    polar = polar_resample(imgs, tables.polar_coords, sx, sy)
    orig, mirr = ccf_spectra(ring_spectra(polar),
                             prepare_ref_spectra(refs, cfg))
    return ccf_rows(orig, mirr, cfg.ring_len)


def _fold(rows, n_shifts):
    """The plain search's fold of the rows in one chunk."""
    n, _, _, k, ring_len = rows.shape
    return _update_best(empty_result(n, ring_len, rows.device), rows, 0,
                        n_shifts, k)


def _assert_same(got, want):
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("split", list(SPLITS))
def test_merge_of_sliced_candidates_is_the_unsplit_fold(split):
    """The same candidates, folded slice by slice and merged, give the
    unsplit fold bit for bit: val, row, aidx, sidx, ref, mirror."""
    cfg, imgs, refs, params = _search_case()
    rows = _candidate_rows(imgs, refs, params, cfg)
    want = _fold(rows, cfg.n_shifts)
    parts = [(_fold(rows[..., a:b, :], cfg.n_shifts) if b > a else
              empty_result(imgs.shape[0], cfg.ring_len, imgs.device), a)
             for a, b in _slices(SPLITS[split])]
    _assert_same(merge_slice_results(parts, cfg.n_shifts, 8), want)


@pytest.mark.parametrize("split", ["2x4", "4x2", "3+5"])
def test_merge_keeps_the_first_of_tied_references(split):
    """References [A, B, C, D, A, B, C, D]: every candidate of the second
    half ties one of the first, and the lower global priority wins, so
    every winner's reference lies in the first half, as in the unsplit
    search."""
    cfg, imgs, refs, params = _search_case(k=4)
    refs = torch.cat([refs, refs])
    rows = _candidate_rows(imgs, refs, params, cfg)
    want = _fold(rows, cfg.n_shifts)
    assert (want.best_ref < 4).all()
    parts = [(_fold(rows[..., a:b, :], cfg.n_shifts), a)
             for a, b in _slices(SPLITS[split])]
    got = merge_slice_results(parts, cfg.n_shifts, 8)
    _assert_same(got, want)
    assert (got.best_ref < 4).all()
    # the plain search on the slices themselves
    parts = [(_plain(imgs, refs[a:b], params, cfg), a)
             for a, b in _slices(SPLITS[split])]
    got = merge_slice_results(parts, cfg.n_shifts, 8)
    _assert_merged_search(got, _plain(imgs, refs, params, cfg))
    assert (got.best_ref < 4).all()


def _plain(imgs, refs, params, cfg):
    return search_plain(imgs, prepare_ref_spectra(refs, cfg), params, cfg)


def _mm(imgs, refs, params, cfg):
    return rotational_shift_search_mm(imgs, prepare_ref_spectra(refs, cfg),
                                      params, cfg)


def _template(imgs, refs, params, cfg):
    return template_search(imgs, prepare_ref_spectra(refs, cfg), params, cfg)


def _assert_merged_search(got, want, rel=1e-6):
    """Winners equal; values and rows within ``rel`` of the largest (a
    slice's products have other widths)."""
    for name in ("best_aidx", "best_sidx", "best_ref", "best_mirror"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    scale = float(want.best_row.abs().max())
    for name in ("best_val", "best_row"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=rel * scale)


# the template engine sums its bf16 products in f32 in an order that
# follows the product's width: 1e-4 of the largest row value
REL = {"plain": 1e-6, "mm": 1e-6, "template": 1e-4}


SEARCHES = {"plain": _plain, "mm": _mm, "template": _template}


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("name", list(SEARCHES))
def test_merged_slice_searches_match_the_unsplit_search(name, split):
    """Each search run on its reference slices and merged: the unsplit
    search's winners (a slice may be empty)."""
    search = SEARCHES[name]
    cfg, imgs, refs, params = _search_case()
    want = search(imgs, refs, params, cfg)
    parts = [(search(imgs, refs[a:b], params, cfg) if b > a else
              empty_result(imgs.shape[0], cfg.ring_len, imgs.device), a)
             for a, b in _slices(SPLITS[split])]
    _assert_merged_search(merge_slice_results(parts, cfg.n_shifts, 8), want,
                          REL[name])


# ---- the rank layout ------------------------------------------------
@pytest.mark.parametrize("layout", list(JAX_LAYOUTS.values()),
                         ids=list(JAX_LAYOUTS))
def test_rank_layout_is_jax_make_mesh_2d(layout):
    """Rank r's (dp_rank, ref_rank) is device r's position in JAX's
    ``make_mesh_2d(dp, ref).devices`` (devices reshaped row-major)."""
    dp, ref = layout
    devices = jax_make_mesh_2d(dp, ref).devices
    for r, d in enumerate(jax.devices()[:dp * ref]):
        mesh = pm.ParticleMesh(r, dp * ref, torch.device("cpu"), "gloo",
                               ref=ref)
        pos = tuple(int(i) for i in np.argwhere(devices == d)[0])
        assert (mesh.dp_rank, mesh.ref_rank) == pos
        assert (mesh.dp, mesh.ref) == (dp, ref)


def test_blocks_slices_and_shares_of_a_2d_mesh():
    """(dp=2, ref=2) on 21 particles and 8 references: the ranks of a
    ref group hold one particle block, each a contiguous slice of the
    references and a share of the block; the shares tile the stack, the
    slices the references, and a block's owner is its ref_rank 0."""
    n, k = 21, 8
    meshes = [pm.ParticleMesh(r, 4, torch.device("cpu"), "gloo", ref=2)
              for r in range(4)]
    assert [pm.shard_range(n, m) for m in meshes] == [(0, 11), (0, 11),
                                                      (11, 21), (11, 21)]
    assert [pm.ref_slice(k, m) for m in meshes] == [(0, 4), (4, 8)] * 2
    shares = []
    for m in meshes:
        s, e = pm.shard_range(n, m)
        a, b = pm.ref_slice(e - s, m)
        shares += list(range(s + a, s + b))
    assert sorted(shares) == list(range(n))
    assert [pm.block_owner(i, n, meshes[0]) for i in (0, 10, 11, 20)] == \
        [0, 0, 2, 2]
    assert pm.ref_slice(1, meshes[1]) == (1, 1)      # an empty slice
    pm.check_ref_split(8, meshes[0])
    with pytest.raises(ValueError, match="ref=2"):
        pm.check_ref_split(3, meshes[0])
    one = pm.ParticleMesh(1, 4, torch.device("cpu"), "gloo")
    assert (one.dp, one.ref, pm.ref_slice(k, one), pm.ref_slice(5, one)) \
        == (4, 1, (0, k), (0, 5))


def test_make_mesh_2d_needs_the_world_size(monkeypatch):
    """``dp * ref`` must be the process group's size; ``ref=1`` is the
    1-D mesh itself."""
    base = pm.ParticleMesh(0, 4, torch.device("cpu"), "gloo")
    monkeypatch.setattr(pm, "_current", base)
    monkeypatch.setattr(pm.dist, "is_initialized", lambda: True)
    for dp, ref in ((3, 2), (2, 1), (0, 4)):
        with pytest.raises(ValueError, match="dp \\* ref"):
            pm.make_mesh_2d(dp, ref)
    assert pm.make_mesh_2d(4, 1) is base


# ---- four gloo ranks ------------------------------------------------
def _inputs():
    """The cases' inputs, made once from seeds with numpy."""
    base8 = asymmetric_templates(8, NX)
    base32 = unit_sigma_blobs(32, NX).astype(np.float32)
    base4 = asymmetric_templates(4, NX)
    imgs8 = np.asarray(scattered_stack(base8, N, max_shift=1, noise=0.05,
                                       seed=61)[0], np.float32)
    imgs32 = np.asarray(scattered_stack(base32, N, max_shift=1, noise=0.05,
                                        seed=62)[0], np.float32)
    imgs4 = np.asarray(scattered_stack(base4, N, max_shift=1, noise=0.05,
                                       seed=63)[0], np.float32)
    one = asymmetric_templates(1, NX)
    imgs1 = np.asarray(scattered_stack(one, N, max_shift=1, noise=0.3,
                                       seed=64)[0], np.float32)
    rng = np.random.default_rng(65)
    cfg = AlignConfig(**GEOM)
    peak = AlignmentEngine(imgs4, cfg, n_classes=4,
                           device="cpu").iterate(base4).peak
    shc_pm = (peak * rng.choice([0.5, 1.1], N)).astype(np.float32)
    return dict(base8=base8, base32=base32, base4=base4, imgs8=imgs8,
                imgs32=imgs32, imgs4=imgs4, imgs1=imgs1, shc_pm=shc_pm,
                ctf_dfu=rng.uniform(1.5e4, 2.5e4, N))


WORKER = r"""
import os, sys
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
torch.set_num_threads(1)
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import (make_device_loop,
                                         make_mref_device_loop)
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.models.reffree import ali2d_base
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.parallel import make_mesh_2d
from cryo_ralib_tpu_torch.models.engine import plan_batch
from cryo_ralib_tpu_torch.models.steps import resolve_route
from cryo_ralib_tpu_torch.parallel import batching
from cryo_ralib_tpu_torch.parallel.mesh import (
    StackShard, gather_params, initialize_distributed, shard_range,
    shard_stack, shutdown)
from cryo_ralib_tpu_torch.utils.log import RunLogger

GEOM = %(geom)r
MREF = %(mref)r
LAYOUTS = %(layouts)r
initialize_distributed(rank=rank, world_size=world,
                       init_method="file://" + tmp + "/store", device="cpu",
                       timeout=90)
torch.set_num_threads(1)
inp = np.load(os.path.join(tmp, "inputs.npz"))
n = inp["imgs8"].shape[0]
cfg = AlignConfig(**GEOM)
quiet = RunLogger(None, quiet=True)
out = {}

try:
    make_mesh_2d(3, 2)
except ValueError as e:
    out["wrong_size"] = str(e)

for tag, (dp, ref) in LAYOUTS.items():
    mesh = make_mesh_2d(dp, ref)
    out[tag + "_ranks"] = np.array([mesh.dp_rank, mesh.ref_rank])
    s, e = shard_range(n, mesh)
    # one engine step at K=8 and K=32, the stack whole or as a shard
    for k in (8, 32):
        imgs, base = inp["imgs%%d" %% k], inp["base%%d" %% k]
        data = imgs if k == 8 else StackShard(imgs[s:e], s, n)
        eng = AlignmentEngine(data, cfg, n_classes=k, device="cpu",
                              sampler="plain", mesh=mesh)
        it = eng.iterate(base)
        out["%%s_step%%d_sums" %% (tag, k)] = it.class_sums
        out["%%s_step%%d_counts" %% (tag, k)] = it.counts
        out["%%s_step%%d_sx" %% (tag, k)] = np.float64(it.sx_sum)
        out["%%s_step%%d_params" %% (tag, k)] = np.stack(eng.params_np(), 1)
    imgs4, base4 = inp["imgs4"], inp["base4"]
    for name, kw in (("mref", {}), ("mref_streamed", dict(batch_size=5))):
        res = mref_ali2d(imgs4, base4, device="cpu", mesh=mesh, log=quiet,
                         **dict(MREF, **kw))
        out[tag + "_" + name + "_params"] = res.params
        out[tag + "_" + name + "_assign"] = res.assignments
        out[tag + "_" + name + "_refs"] = res.references
    # ranks of a ref group that plan from different free memory, with no
    # batch_size: each would pick its own batch (the block, 4, 2 or 8 by
    # ref_rank), and the group must step through one
    m = e - s
    own_b = (m, 4, 2, 8)[mesh.ref_rank]

    def memory(k):
        # the card's memory at which the planner picks own_b for K=k (the
        # ranks on one device share it)
        route = resolve_route("plain", "cpu", cfg, n_refs=k, mesh=mesh)
        assert route.refs == k // mesh.ref
        fp = batching.step_footprint(own_b, route, cfg, own_b < m).total
        return lambda device=None: ((int(fp / 0.8) + 64)
                                    * mesh.ranks_on_device)

    free = batching.device_memory_bytes
    try:
        batching.device_memory_bytes = memory(4)
        route = resolve_route("plain", "cpu", cfg, n_refs=4, mesh=mesh)
        out[tag + "_plan_own"] = np.int64(batching.plan_batch_size(
            m, route, cfg, device="cpu",
            ranks_on_device=mesh.ranks_on_device))
        out[tag + "_plan"] = np.int64(plan_batch(m, route, cfg, "cpu",
                                                 mesh=mesh))
        res = mref_ali2d(imgs4, base4, device="cpu", mesh=mesh, log=quiet,
                         **MREF)
        out[tag + "_planned_params"] = res.params
        out[tag + "_planned_assign"] = res.assignments
        out[tag + "_planned_refs"] = res.references
        batching.device_memory_bytes = memory(8)
        eng = AlignmentEngine(inp["imgs8"], cfg, n_classes=8, device="cpu",
                              sampler="plain", mesh=mesh)
        it = eng.iterate(inp["base8"])
        out[tag + "_planned_step_batch"] = np.int64(eng.batch)
        out[tag + "_planned_step_sums"] = it.class_sums
        out[tag + "_planned_step_counts"] = it.counts
        out[tag + "_planned_step_params"] = np.stack(eng.params_np(), 1)
    finally:
        batching.device_memory_bytes = free
    # SHC: every rank of a ref group searches all K=4 references
    shc = AlignmentEngine(imgs4, cfg, n_classes=4, device="cpu",
                          random_method="SHC", mesh=mesh)
    shc.set_previousmax(inp["shc_pm"])
    res = shc.iterate(base4)
    out[tag + "_shc_params"] = np.stack(shc.params_np(), 1)
    out[tag + "_shc_pm"] = shc.previousmax_np()
    out[tag + "_shc_nope"] = np.int64(res.nope)
    out[tag + "_shc_counts"] = res.counts
    # the device loops on the rank's block (K=1 leaves a slice empty)
    local, gidx = shard_stack(imgs4, mesh)
    zeros = AlignParams.zeros(local.shape[0])
    valid = torch.ones(local.shape[0])
    cut = np.full(2, 0.25, np.float32)
    lp, avg = make_device_loop(cfg, 2, cut, device="cpu", mesh=mesh)(
        torch.as_tensor(local), torch.as_tensor(imgs4.mean(0)), zeros, gidx,
        valid)
    out[tag + "_loop_params"] = np.stack(gather_params(lp, n, mesh), 1)
    out[tag + "_loop_avg"] = avg.numpy()
    lp, refs = make_mref_device_loop(cfg, 2, 4, cut, device="cpu",
                                     mesh=mesh)(
        torch.as_tensor(local), torch.as_tensor(base4), zeros, gidx, valid)
    out[tag + "_mloop_params"] = np.stack(gather_params(lp, n, mesh), 1)
    out[tag + "_mloop_refs"] = refs.numpy()

mesh = make_mesh_2d(2, 2)
imgs4, base4 = inp["imgs4"], inp["base4"]
for sampler in ("template", "matmul"):
    res = mref_ali2d(imgs4, base4, device="cpu", mesh=mesh, log=quiet,
                     sampler=sampler, **MREF)
    out["mref_" + sampler + "_params"] = res.params
    out["mref_" + sampler + "_assign"] = res.assignments
res = mref_ali2d(imgs4, base4, device="cpu", mesh=mesh, log=quiet, CTF=True,
                 ctf_params=dict(dfu=inp["ctf_dfu"], apix=2.0), **MREF)
out["mref_ctf_params"], out["mref_ctf_assign"] = res.params, res.assignments
out["mref_ctf_refs"] = res.references
res = mref_ali2d(imgs4, base4, device="cpu", mesh=mesh, log=quiet,
                 ring_scheme="eman2", **MREF)
out["mref_eman2_params"] = res.params
out["mref_eman2_assign"] = res.assignments

# the JAX package's refusals
try:
    ali2d_base(inp["imgs1"], device="cpu", mesh=mesh, log=quiet, ou=16,
               xr=1, ts=1, maxit=1)
except ValueError as e:
    out["refuse_reffree"] = str(e)
try:
    mref_ali2d(imgs4, np.concatenate([base4, base4[:2]]), device="cpu",
               mesh=make_mesh_2d(1, 4), log=quiet, **MREF)
except ValueError as e:
    out["refuse_k6"] = str(e)
np.savez(os.path.join(tmp, "out%%d.npz" %% rank), **out)
shutdown()
assert "jax" not in sys.modules, "a worker imported jax"
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every case on four gloo ranks; {rank: outputs} and the
    inputs."""
    tmp = tmp_path_factory.mktemp("ranks2d")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    code = WORKER % dict(geom=GEOM, mref=MREF, layouts=LAYOUTS)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "PYTHONPATH")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(WORLD), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=RANK_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-4000:]
    outs = {r: dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)}
    return outs, inp


def _assert_params(got, want, tol=1e-3):
    """(N, 5) angle, sx, sy, mirror, ref_id, or (N, 4) header tables:
    the integer columns equal, the rest within ``tol`` (angles on the
    circle)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    d = np.abs(got[:, 0] - want[:, 0]) % 360.0
    assert np.minimum(d, 360.0 - d).max() < tol
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=0, atol=tol)


def _assert_sums_close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_layout_and_the_wrong_world_size(ranks):
    outs, _ = ranks
    for r, out in outs.items():
        assert "dp * ref" in str(out["wrong_size"])
        assert tuple(out["2x2_ranks"]) == (r // 2, r % 2)
        assert tuple(out["1x4_ranks"]) == (0, r)


def _one_step(imgs, base):
    eng = AlignmentEngine(imgs, AlignConfig(**GEOM), n_classes=len(base),
                          device="cpu", sampler="plain")
    res = eng.iterate(base)
    return res, np.stack(eng.params_np(), 1)


def _jax_step(imgs, base, layout):
    mesh = jax_make_mesh_2d(*layout)
    imgs_dev, gidx, valid = jax_shard_stack(imgs, mesh)
    step = make_align_step(JaxConfig(**GEOM), len(base), mesh=mesh,
                           sampler="gather", shift_chunk=9, donate=False,
                           dist="gspmd")
    from jax.sharding import NamedSharding, PartitionSpec as P

    refs = jax.device_put(jnp.asarray(base), NamedSharding(mesh, P("ref")))
    out = step(imgs_dev, refs, JaxParams.zeros(int(imgs_dev.shape[0])),
               gidx, valid)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k", [8, 32])
def test_one_step_matches_one_process_and_jax_2d_mesh(ranks, k, layout):
    outs, inp = ranks
    got = outs[0]
    key = f"{layout}_step{k}"
    res, params = _one_step(inp[f"imgs{k}"], inp[f"base{k}"])
    _assert_sums_close(got[key + "_sums"], res.class_sums)
    np.testing.assert_array_equal(got[key + "_counts"], res.counts)
    _assert_params(got[key + "_params"], params, tol=1e-4)
    np.testing.assert_allclose(got[key + "_sx"], res.sx_sum, atol=1e-4)
    for r in range(1, WORLD):
        for field in ("sums", "counts", "params"):
            np.testing.assert_array_equal(outs[r][f"{key}_{field}"],
                                          got[f"{key}_{field}"])

    jx = _jax_step(inp[f"imgs{k}"], inp[f"base{k}"], JAX_LAYOUTS[layout])
    np.testing.assert_array_equal(got[key + "_counts"], jx.counts)
    np.testing.assert_array_equal(got[key + "_params"][:, 4],
                                  jx.params.ref_id[:N])
    np.testing.assert_array_equal(got[key + "_params"][:, 3],
                                  jx.params.mirror[:N])
    np.testing.assert_allclose(got[key + "_params"][:, 0],
                               jx.params.angle[:N], atol=1e-3)
    _assert_sums_close(got[key + "_sums"], jx.class_sums, rel=5e-4)
    np.testing.assert_allclose(got[key + "_sx"], jx.sx_sum, atol=1e-3)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["mref", "mref_streamed"])
def test_mref_matches_one_process(ranks, mode, layout):
    """mref_ali2d (K=4, maxit=2), resident and streamed in batches of 5,
    against one resident process (the streamed batches sum in another
    order)."""
    outs, inp = ranks
    got = outs[0]
    want = mref_ali2d(inp["imgs4"], inp["base4"], device="cpu",
                      log=RunLogger(None, quiet=True), **MREF)
    key = f"{layout}_{mode}"
    np.testing.assert_array_equal(got[key + "_assign"], want.assignments)
    _assert_params(got[key + "_params"], want.params)
    _assert_sums_close(got[key + "_refs"], want.references)
    for r in range(1, WORLD):
        np.testing.assert_array_equal(outs[r][key + "_params"],
                                      got[key + "_params"])


def test_mref_matches_jax_2d_mesh(ranks):
    outs, inp = ranks
    want = mref_ali2d_tpu(inp["imgs4"], inp["base4"].copy(),
                          mesh=jax_make_mesh_2d(4, 2), sampler="gather",
                          shift_chunk=9, log=JaxLogger(None, quiet=True),
                          **MREF)
    for layout in LAYOUTS:
        got = outs[0]
        np.testing.assert_array_equal(got[f"{layout}_mref_assign"],
                                      want.assignments)
        _assert_params(got[f"{layout}_mref_params"], want.params)


@pytest.mark.parametrize("sampler", ["template", "matmul"])
def test_template_and_matmul_on_a_2d_mesh_match_one_process(ranks, sampler):
    """mref_ali2d through the template engine and the matmul sampler on
    (dp=2, ref=2): each rank searches its slice through the bf16
    products; assignments equal, params within 1e-2."""
    outs, inp = ranks
    want = mref_ali2d(inp["imgs4"], inp["base4"], device="cpu",
                      log=RunLogger(None, quiet=True), sampler=sampler,
                      **MREF)
    got = outs[0]
    np.testing.assert_array_equal(got[f"mref_{sampler}_assign"],
                                  want.assignments)
    _assert_params(got[f"mref_{sampler}_params"], want.params, tol=1e-2)


@pytest.mark.parametrize("case", ["ctf", "eman2"])
def test_ctf_and_eman2_on_a_2d_mesh_match_one_process(ranks, case):
    """--CTF (the Wiener ctf^2 sums count each particle once) and the
    eman2 rings on (dp=2, ref=2)."""
    outs, inp = ranks
    kw = (dict(CTF=True, ctf_params=dict(dfu=inp["ctf_dfu"], apix=2.0))
          if case == "ctf" else dict(ring_scheme="eman2"))
    want = mref_ali2d(inp["imgs4"], inp["base4"], device="cpu",
                      log=RunLogger(None, quiet=True), **MREF, **kw)
    got = outs[0]
    np.testing.assert_array_equal(got[f"mref_{case}_assign"],
                                  want.assignments)
    _assert_params(got[f"mref_{case}_params"], want.params)
    if case == "ctf":
        _assert_sums_close(got["mref_ctf_refs"], want.references)


def test_shc_step_on_a_2d_mesh_matches_one_process(ranks):
    """One SHC engine step at K=4 from thresholds 10% off the peaks, on
    (dp=2, ref=2) and (dp=1, ref=4): every rank of a ref group searches
    all the references (as the JAX package's SHC step keeps them
    replicated) and sums its share, ``nope`` included."""
    outs, inp = ranks
    eng = AlignmentEngine(inp["imgs4"], AlignConfig(**GEOM), n_classes=4,
                          device="cpu", random_method="SHC")
    eng.set_previousmax(inp["shc_pm"])
    res = eng.iterate(inp["base4"])
    for layout in LAYOUTS:
        got = outs[0]
        _assert_params(got[f"{layout}_shc_params"],
                       np.stack(eng.params_np(), 1), tol=1e-4)
        np.testing.assert_allclose(got[f"{layout}_shc_pm"],
                                   eng.previousmax_np(), rtol=1e-5)
        assert int(got[f"{layout}_shc_nope"]) == res.nope > 0
        np.testing.assert_array_equal(got[f"{layout}_shc_counts"],
                                      res.counts)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("run", ["mref", "step"])
def test_ranks_that_plan_apart_step_through_one_batch(ranks, run, layout):
    """No batch_size, and each rank of a ref group sees other free memory
    (patched so that its own plan is the block, 4, 2 or 8 by ref_rank):
    the group takes the least plan, so every rank calls each batch's
    merge alike, and mref_ali2d (K=4) and an engine step (K=8) match one
    process."""
    outs, inp = ranks
    dp, ref = LAYOUTS[layout]
    m = N // dp
    least = min((m, 4, 2, 8)[:ref])
    for r, out in outs.items():
        assert int(out[f"{layout}_plan_own"]) == (m, 4, 2, 8)[r % ref]
        assert int(out[f"{layout}_plan"]) == least
        assert int(out[f"{layout}_planned_step_batch"]) == least
    got = outs[0]
    if run == "mref":
        want = mref_ali2d(inp["imgs4"], inp["base4"], device="cpu",
                          log=RunLogger(None, quiet=True), **MREF)
        key = f"{layout}_planned"
        np.testing.assert_array_equal(got[key + "_assign"],
                                      want.assignments)
        _assert_params(got[key + "_params"], want.params)
        _assert_sums_close(got[key + "_refs"], want.references)
    else:
        res, params = _one_step(inp["imgs8"], inp["base8"])
        key = f"{layout}_planned_step"
        _assert_sums_close(got[key + "_sums"], res.class_sums)
        np.testing.assert_array_equal(got[key + "_counts"], res.counts)
        _assert_params(got[key + "_params"], params, tol=1e-4)


@pytest.mark.parametrize("random_method", ["", "SHC", "SCF"])
def test_a_rank_searches_its_slice_or_every_reference(random_method):
    """A route's ``refs``: the standard search takes the rank's slice of
    K under a ``ref`` split; SHC and SCF keep every reference; without a
    split, or with ``ref`` 1, all K."""
    mesh = pm.ParticleMesh(1, 4, torch.device("cpu"), "gloo", ref=4)
    flat = pm.ParticleMesh(1, 4, torch.device("cpu"), "gloo")
    want = 8 if random_method else 2
    cfg = AlignConfig(img_dim=48, ring_num=16, shift_rng_x=1.0,
                      shift_rng_y=1.0)

    def refs(m):
        return resolve_route("auto", "cpu", cfg, random_method, n_refs=8,
                             mesh=m).refs
    assert refs(mesh) == want
    assert refs(flat) == 8
    assert refs(None) == 8


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_device_loops_match_one_process(ranks, layout):
    """Both device loops on the rank's block; the reference-free loop's
    one reference leaves a slice empty on every ref group."""
    outs, inp = ranks
    got = outs[0]
    imgs, base = inp["imgs4"], inp["base4"]
    cfg = AlignConfig(**GEOM)
    cut = np.full(2, 0.25, np.float32)
    zeros = AlignParams.zeros(N)
    gidx, valid = torch.arange(N), torch.ones(N)
    lp, avg = make_device_loop(cfg, 2, cut, device="cpu")(
        torch.as_tensor(imgs), torch.as_tensor(imgs.mean(0)), zeros, gidx,
        valid)
    _assert_params(got[f"{layout}_loop_params"], np.stack(lp, 1))
    _assert_sums_close(got[f"{layout}_loop_avg"], avg.numpy())
    lp, refs = make_mref_device_loop(cfg, 2, 4, cut, device="cpu")(
        torch.as_tensor(imgs), torch.as_tensor(base), zeros, gidx, valid)
    _assert_params(got[f"{layout}_mloop_params"], np.stack(lp, 1))
    _assert_sums_close(got[f"{layout}_mloop_refs"], refs.numpy())


@pytest.mark.parametrize("case", ["refuse_reffree", "refuse_k6"])
def test_references_that_do_not_split_are_refused(ranks, case):
    """As the JAX package's P('ref') placement: ali2d_base's one
    reference on (dp=2, ref=2), and K=6 on (dp=1, ref=4), raise
    ValueError on every rank."""
    for out in ranks[0].values():
        assert "multiple of ref" in str(out[case])
