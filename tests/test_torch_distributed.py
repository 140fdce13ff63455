"""The port's data parallelism (``cryo_ralib_tpu_torch/parallel/mesh.py``)
on the CPU: two gloo ranks, each a process of its own started here
through ``subprocess`` and joined through a file store in ``tmp_path``
(no TCP port, so xdist workers cannot race for one), against the
single-process port and against the JAX package's ``dp`` mesh of
conftest's 8 virtual CPU devices, as tests/test_drivers.py runs it.

The workers run every case once (a module fixture) and import no jax:
each asserts ``"jax" not in sys.modules`` at its end.  Each worker has
a time limit of 120 s and the process group a timeout of 60 s.

Tolerances: class sums within 1e-5 of their largest value (only the
order of the reduction differs); counts, winners, assignments and
mirrors equal; params within 1e-3 (angles on the circle), as
tests/test_drivers.py holds the JAX mesh to one device.
"""

import math
import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.models import ali2d_base_tpu, mref_ali2d_tpu
from cryo_ralib_tpu.models import device_loop as jax_loop
from cryo_ralib_tpu.models.steps import (make_align_step,
                                         make_align_step_shc)
from cryo_ralib_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cryo_ralib_tpu.parallel.mesh import shard_stack as jax_shard_stack
from cryo_ralib_tpu.params import AlignParams as JaxParams
from cryo_ralib_tpu.utils.log import RunLogger as JaxLogger
from cryo_ralib_tpu.utils.synthetic import (asymmetric_templates,
                                            scattered_stack)
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.models.reffree import ali2d_base
from cryo_ralib_tpu_torch.ops.fourvar import fourier_variance
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.parallel.mesh import (ParticleMesh, StackShard,
                                                block_owner, block_range,
                                                shard_range, shard_stack)
from cryo_ralib_tpu_torch.utils.log import RunLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, NX, N, OU, XR = 3, 48, 21, 16, 1   # rank 1 starts at the odd 11
GEOM = dict(img_dim=NX, ring_num=OU, ring_len=256, shift_step=1.0,
            shift_rng_x=float(XR), shift_rng_y=float(XR))
MREF = dict(ou=OU, xr=XR, yr=XR, ts=1, maxit=2)
REFFREE = dict(ou=OU, xr=XR, ts=1, maxit=3)
RESEED_N = 12          # reseed case: rank 1 holds particles 6..11
WORLD = 2
RANK_TIMEOUT = 120     # seconds, each worker process


def _inputs():
    """The cases' inputs, made once from seeds with numpy."""
    base = asymmetric_templates(K, NX)
    imgs = np.asarray(scattered_stack(base, N, max_shift=1, noise=0.05,
                                      seed=43)[0], np.float32)
    one = asymmetric_templates(1, NX)
    imgs1 = np.asarray(scattered_stack(one, N, max_shift=1, noise=0.3,
                                       seed=44)[0], np.float32)
    rng = np.random.default_rng(45)
    params = dict(angle=rng.uniform(0, 360, N).astype(np.float32),
                  shift_x=rng.uniform(-1, 1, N).astype(np.float32),
                  shift_y=rng.uniform(-1, 1, N).astype(np.float32),
                  mirror=rng.integers(0, 2, N).astype(np.int32),
                  ref_id=np.zeros(N, np.int32))
    ctf = dict(dfu=rng.uniform(1.5e4, 2.5e4, N), apix=2.0)
    # a third reference no particle takes: its class vanishes and is
    # reseeded from the particle the driver's rng draws
    refs_vanish = np.concatenate([base[:2], np.zeros_like(base[:1])])
    # SHC thresholds 10% off the standard search's peaks (a threshold
    # equal to a peak would be decided by rounding, tests/test_torch_modes)
    cfg = AlignConfig(**GEOM)
    peak = AlignmentEngine(imgs, cfg, n_classes=K,
                           device="cpu").iterate(base).peak
    shc_pm = (peak * rng.choice([0.5, 1.1], N)).astype(np.float32)
    peak = AlignmentEngine(imgs1, cfg, n_classes=1,
                           device="cpu").iterate(imgs1.mean(0)[None]).peak
    shc_pm1 = (peak * rng.choice([0.5, 1.1], N)).astype(np.float32)
    seed = next(s for s in range(1000, 2000)
                if random.Random(s).randint(0, RESEED_N - 1)
                >= block_range(RESEED_N, WORLD, 1)[0])
    return dict(base=base, imgs=imgs, imgs1=imgs1, refs_vanish=refs_vanish,
                reseed_seed=np.int64(seed), ctf_dfu=ctf["dfu"],
                shc_pm=shc_pm, shc_pm1=shc_pm1,
                **{"p_" + k: v for k, v in params.items()})


WORKER = r"""
import os, sys
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import (make_device_loop,
                                         make_mref_device_loop)
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.models.reffree import ali2d_base
from cryo_ralib_tpu_torch.ops.fourvar import fourier_variance
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.parallel.mesh import (
    StackShard, gather_params, initialize_distributed, shard_range,
    shard_stack, shutdown)
from cryo_ralib_tpu_torch.utils.log import RunLogger

GEOM = %(geom)r
MREF = %(mref)r
REFFREE = %(reffree)r
mesh = initialize_distributed(rank=rank, world_size=world,
                              init_method="file://" + tmp + "/store",
                              device="cpu", timeout=60)
assert mesh.backend == "gloo" and mesh.device.type == "cpu"
inp = np.load(os.path.join(tmp, "inputs.npz"))
base, imgs, imgs1 = inp["base"], inp["imgs"], inp["imgs1"]
n = imgs.shape[0]
cfg = AlignConfig(**GEOM)
quiet = RunLogger(None, quiet=True)
out = {}

def keep(name, res):
    out[name + "_params"] = res.params
    for field in ("assignments", "class_counts", "references", "average",
                  "criteria"):
        if hasattr(res, field):
            out[name + "_" + field] = np.asarray(getattr(res, field))

# one engine iteration, the stack whole or as the rank's StackShard
eng = AlignmentEngine(imgs, cfg, n_classes=len(base), device="cpu",
                      sampler="plain", mesh=mesh)
s, e = shard_range(n, mesh)
assert (eng.start, eng.n_local, eng.n) == (s, e - s, n)
it = eng.iterate(base)
p = eng.params_np()
out.update(step_sums=it.class_sums, step_counts=it.counts,
           step_ref_id=p.ref_id, step_angle=p.angle, step_mirror=p.mirror,
           step_sx=np.float64(it.sx_sum))
eng2 = AlignmentEngine(StackShard(imgs[s:e], s, n), cfg,
                       n_classes=len(base), device="cpu", sampler="plain",
                       mesh=mesh)
out["step_shard_sums"] = eng2.iterate(base).class_sums

# the drivers
keep("mref", mref_ali2d(imgs, base, device="cpu", mesh=mesh, log=quiet,
                        **MREF))
keep("mref_streamed", mref_ali2d(StackShard(imgs[s:e], s, n), base,
                                 device="cpu", mesh=mesh, log=quiet,
                                 batch_size=4, **MREF))
keep("reffree", ali2d_base(imgs1, device="cpu", mesh=mesh, log=quiet,
                           **REFFREE))
for mode, batch in (("resident", None), ("streamed", 4)):
    keep("shc_" + mode, ali2d_base(imgs1, device="cpu", mesh=mesh, log=quiet,
                                   random_method="SHC", batch_size=batch,
                                   **dict(REFFREE, maxit=2)))

# SHC, one step: K references, and K=1
for tag, stack, refs, pm in (("shc_step", imgs, base, "shc_pm"),
                             ("shc_step1", imgs1, imgs1.mean(0)[None],
                              "shc_pm1")):
    shc = AlignmentEngine(stack, cfg, n_classes=len(refs), device="cpu",
                          random_method="SHC", mesh=mesh)
    shc.set_previousmax(inp[pm])
    res = shc.iterate(refs)
    out[tag] = np.stack(shc.params_np(), 1)
    out[tag + "_pm"] = shc.previousmax_np()
    out[tag + "_nope"] = np.int64(res.nope)

# the device loops on the rank's block
local, gidx = shard_stack(imgs, mesh)
zeros = AlignParams.zeros(local.shape[0])
valid = torch.ones(local.shape[0])
cut = np.full(2, 0.25, np.float32)
lp, avg = make_device_loop(cfg, 2, cut, device="cpu", mesh=mesh)(
    torch.as_tensor(local), torch.as_tensor(imgs.mean(0)), zeros, gidx,
    valid)
out["loop_params"] = np.stack(gather_params(lp, n, mesh), 1)
out["loop_avg"] = avg.numpy()
lp, refs = make_mref_device_loop(cfg, 2, len(base), cut, device="cpu",
                                 mesh=mesh)(
    torch.as_tensor(local), torch.as_tensor(base), zeros, gidx, valid)
out["mloop_params"] = np.stack(gather_params(lp, n, mesh), 1)
out["mloop_refs"] = refs.numpy()

# CTF, Fourvar, the reseed
ctf = dict(dfu=inp["ctf_dfu"], apix=2.0)
keep("ctf", mref_ali2d(imgs, base, device="cpu", mesh=mesh, log=quiet,
                       CTF=True, ctf_params=ctf, **MREF))
prm = AlignParams(*[inp["p_" + f][s:e] for f in AlignParams._fields])
var, rvar = fourier_variance(local, prm, mesh=mesh)
out.update(fv_var=var, fv_rvar=rvar)
fv_dir = os.path.join(tmp, "fourvar")
ali2d_base(imgs1, outdir=fv_dir, device="cpu", mesh=mesh, log=quiet,
           **dict(REFFREE, maxit=1))
keep("fourvar", ali2d_base(imgs1, outdir=fv_dir, device="cpu", mesh=mesh,
                           log=quiet, Fourvar=True, resume=True, **REFFREE))
keep("reseed", mref_ali2d(imgs[:%(reseed_n)d], inp["refs_vanish"], device="cpu",
                          mesh=mesh, log=quiet,
                          rand_seed=int(inp["reseed_seed"]), **MREF))
np.savez(os.path.join(tmp, "out%%d.npz" %% rank), **out)
shutdown()
assert "jax" not in sys.modules, "a worker imported jax"
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every case on two gloo ranks; {rank: outputs} and the
    inputs."""
    tmp = tmp_path_factory.mktemp("ranks")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    code = WORKER % dict(geom=GEOM, mref=MREF, reffree=REFFREE,
                         reseed_n=RESEED_N)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "PYTHONPATH")}
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


def _mesh(rank, world):
    return ParticleMesh(rank, world, torch.device("cpu"), "gloo")


def _assert_tables_match(got, want, tol=1e-3):
    """Header tables (alpha, sx, sy, mirror): mirrors equal, the rest
    within ``tol`` (angles on the circle)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    d = np.abs(got[:, 0] - want[:, 0]) % 360.0
    assert np.minimum(d, 360.0 - d).max() < tol
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=0, atol=tol)


def _assert_sums_close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("n,world", [(19, 2), (19, 3), (16, 8), (5, 4),
                                     (3, 4)])
def test_shard_range_is_the_block_rule(n, world):
    """``MPI_start_end``: rank r holds round(n / world * r) ..
    round(n / world * (r + 1)) - 1, halves rounded up; the blocks tile
    the stack, each rank's global indices are its rows, and the owner of
    every particle is the rank whose block holds it."""
    edges = [math.floor(n / world * r + 0.5) for r in range(world + 1)]
    stack = np.arange(n * 4, dtype=np.float32).reshape(n, 2, 2)
    rows = []
    for r in range(world):
        mesh = _mesh(r, world)
        assert shard_range(n, mesh) == (edges[r], edges[r + 1])
        local, gidx = shard_stack(stack, mesh)
        np.testing.assert_array_equal(gidx.numpy(),
                                      np.arange(edges[r], edges[r + 1]))
        np.testing.assert_array_equal(local, stack[edges[r]:edges[r + 1]])
        shard = StackShard(local, edges[r], n)
        assert shard.shape == stack.shape
        assert shard_stack(shard, mesh)[0] is local
        rows += list(gidx.numpy())
        for i in gidx.numpy():
            assert block_owner(int(i), n, mesh) == r
    assert rows == list(range(n))
    assert shard_range(n, None) == (0, n)
    with pytest.raises(ValueError, match="rows"):
        shard_stack(StackShard(stack[:1], 1, n), _mesh(0, world))


@pytest.mark.parametrize("device,per_host,cards,want", [
    ("cuda", 2, 2, "cpu:gloo,cuda:nccl"), ("cuda", 4, 8, "cpu:gloo,cuda:nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 4, 2, "gloo"), ("cpu", 2, 0, "gloo")])
def test_backend_rule(monkeypatch, device, per_host, cards, want):
    """NCCL (and gloo for CPU tensors) where every rank of a host has a
    card of its own; gloo where ranks share a card and on the CPU; a
    rank's card is its local rank modulo the cards."""
    from cryo_ralib_tpu_torch.parallel import mesh as pm

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    dev = pm.rank_device(device, per_host - 1)
    assert dev == (torch.device("cuda", (per_host - 1) % cards)
                   if device == "cuda" else torch.device("cpu"))
    assert pm.choose_backend(dev, per_host) == want


def test_mesh_needs_a_process_group(monkeypatch):
    from cryo_ralib_tpu_torch.parallel import mesh as pm

    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pm.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.rank_device("cuda", 0)
    for key in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="init_method"):
        pm.initialize_distributed(device="cpu")


def test_planner_shares_the_card_among_its_ranks(monkeypatch):
    """Ranks that share a card plan at once and each sees the card free:
    the planner divides what it reads by the ranks on the card."""
    from cryo_ralib_tpu_torch.parallel import batching

    cfg = AlignConfig(img_dim=90, ring_num=36, shift_rng_x=3.0,
                      shift_rng_y=3.0)
    free = 2 * 2**30
    monkeypatch.setattr(batching, "device_memory_bytes",
                        lambda device=None: free)
    n = 10 ** 6
    one = batching.plan_batch_size(n, 8, cfg, device="cuda")
    two = batching.plan_batch_size(n, 8, cfg, device="cuda",
                                   ranks_on_device=2)
    assert one == batching.plan_batch_size(n, 8, cfg, limit_bytes=free)
    assert two == batching.plan_batch_size(n, 8, cfg, limit_bytes=free // 2)
    assert two < one < n


def test_gather_without_a_mesh_is_the_block():
    """One process: the collectives leave their inputs as they are."""
    from cryo_ralib_tpu_torch.parallel import mesh as pm

    p = AlignParams(*[torch.arange(4, dtype=dt) for dt in
                      (torch.float32,) * 3 + (torch.int32,) * 2])
    got = pm.gather_params(p, 4, None)
    for g, f in zip(got, p):
        np.testing.assert_array_equal(g, f.numpy())
        assert g.dtype == f.numpy().dtype
    x = torch.ones(3)
    assert pm.all_reduce_sums(None, x)[0] is x
    assert pm.broadcast_status(3, None) == 3
    refs = np.ones((2, 2), np.float32)
    assert pm.broadcast_refs(refs, None) is refs


def _jax_step(imgs, refs, cfg, n_dev=8):
    mesh = jax_make_mesh(n_dev)
    imgs_dev, gidx, valid = jax_shard_stack(imgs, mesh)
    step = make_align_step(cfg, refs.shape[0], mesh=mesh, sampler="gather",
                           shift_chunk=9, donate=False, dist="gspmd")
    return step(imgs_dev, jnp.asarray(refs),
                JaxParams.zeros(int(imgs_dev.shape[0])), gidx, valid)


def test_one_step_matches_single_process_and_jax_mesh(ranks):
    outs, inp = ranks
    got = outs[0]
    eng = AlignmentEngine(inp["imgs"], AlignConfig(**GEOM), n_classes=K,
                          device="cpu", sampler="plain")
    want = eng.iterate(inp["base"])
    p = eng.params_np()
    _assert_sums_close(got["step_sums"], want.class_sums)
    _assert_sums_close(got["step_shard_sums"], want.class_sums)
    np.testing.assert_array_equal(got["step_counts"], want.counts)
    np.testing.assert_array_equal(got["step_ref_id"], p.ref_id)
    np.testing.assert_array_equal(got["step_mirror"], p.mirror)
    np.testing.assert_allclose(got["step_sx"], want.sx_sum, atol=1e-4)

    jx = _jax_step(inp["imgs"], inp["base"], JaxConfig(**GEOM))
    _assert_sums_close(got["step_sums"], np.asarray(jx.class_sums))
    np.testing.assert_array_equal(got["step_counts"], np.asarray(jx.counts))
    np.testing.assert_array_equal(got["step_ref_id"],
                                  np.asarray(jx.params.ref_id)[:N])
    np.testing.assert_array_equal(got["step_mirror"],
                                  np.asarray(jx.params.mirror)[:N])
    # every rank returns the same
    for key in ("step_sums", "step_counts", "step_ref_id", "mref_params",
                "reffree_params", "loop_avg", "mloop_refs"):
        np.testing.assert_array_equal(outs[1][key], got[key], err_msg=key)


def test_mref_matches_jax_mesh(ranks):
    outs, inp = ranks
    got = outs[0]
    want = mref_ali2d_tpu(inp["imgs"], inp["base"].copy(),
                          mesh=jax_make_mesh(8), sampler="gather",
                          shift_chunk=9, log=JaxLogger(None, quiet=True),
                          **MREF)
    np.testing.assert_array_equal(got["mref_assignments"], want.assignments)
    np.testing.assert_array_equal(got["mref_class_counts"],
                                  want.class_counts)
    _assert_tables_match(got["mref_params"], want.params)


def test_reffree_matches_jax_mesh(ranks):
    outs, inp = ranks
    got = outs[0]
    want = ali2d_base_tpu(inp["imgs1"], mesh=jax_make_mesh(8),
                          sampler="gather", shift_chunk=9,
                          log=JaxLogger(None, quiet=True), **REFFREE)
    _assert_tables_match(got["reffree_params"], want.params)
    np.testing.assert_allclose(got["reffree_criteria"], want.criteria,
                               rtol=1e-4)


def test_streamed_matches_resident_on_two_ranks(ranks):
    """mref_ali2d (a StackShard streamed in batches of 4) and SHC
    ali2d_base streamed, each against the resident run on two ranks:
    the batches sum their classes in another order, so the references of
    the second iteration differ by rounding and the params by up to
    2.2e-4 (held to 1e-3)."""
    got = ranks[0][0]
    for a, b in (("mref_streamed", "mref"), ("shc_streamed", "shc_resident")):
        _assert_tables_match(got[a + "_params"], got[b + "_params"])
    np.testing.assert_array_equal(got["mref_streamed_assignments"],
                                  got["mref_assignments"])


def test_shc_step_matches_jax_mesh_and_single_process(ranks):
    """One SHC step from thresholds 10% off the peaks.  K=3 against JAX
    ``make_align_step_shc`` on a mesh of 4: winners, shifts and ``nope``
    equal, angles within 1e-3, previousmax within 1e-4 relative.  K=1 on
    the noisier one-template stack against the single-process port (the
    first candidate above half a peak is no peak, and there the two
    packages' refined angles differ by up to 1.25e-3 in one process
    already): the same params within 1e-4 and previousmax within 1e-5
    relative."""
    outs, inp = ranks
    got = outs[0]
    mesh = jax_make_mesh(4)
    imgs_dev, gidx, valid = jax_shard_stack(inp["imgs"], mesh)
    n_pad = int(imgs_dev.shape[0])
    pm = jax.device_put(jnp.asarray(np.pad(inp["shc_pm"], (0, n_pad - N))),
                        gidx.sharding)
    step = make_align_step_shc(JaxConfig(**GEOM), n_classes=K, mesh=mesh,
                               sampler="gather", shift_chunk=9)
    out = step(imgs_dev, jnp.asarray(inp["base"]), JaxParams.zeros(n_pad),
               gidx, valid, pm)
    _assert_loop_params(got["shc_step"], _jax_loop_params(out.step.params))
    np.testing.assert_allclose(got["shc_step"][:, 1:3],
                               _jax_loop_params(out.step.params)[:, 1:3],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["shc_step_pm"],
                               np.asarray(out.previousmax)[:N], rtol=1e-4)
    assert int(got["shc_step_nope"]) == int(out.nope) > 0

    eng = AlignmentEngine(inp["imgs1"], AlignConfig(**GEOM), n_classes=1,
                          device="cpu", random_method="SHC")
    eng.set_previousmax(inp["shc_pm1"])
    res = eng.iterate(inp["imgs1"].mean(0)[None])
    want = np.stack(eng.params_np(), 1)
    np.testing.assert_array_equal(got["shc_step1"][:, 3:], want[:, 3:])
    np.testing.assert_allclose(got["shc_step1"][:, :3], want[:, :3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["shc_step1_pm"], eng.previousmax_np(),
                               rtol=1e-5)
    assert int(got["shc_step1_nope"]) == res.nope > 0


def _jax_loop_params(p):
    return np.stack([np.asarray(f)[:N] for f in p], 1)


def _assert_loop_params(got, want):
    """(N, 5) angle, sx, sy, mirror, ref_id."""
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    d = np.abs(got[:, 0] - want[:, 0]) % 360.0
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], atol=1e-3)


def test_device_loops_match_jax_mesh(ranks):
    outs, inp = ranks
    got = outs[0]
    imgs, base = inp["imgs"], inp["base"]
    mesh = jax_make_mesh(8)
    imgs_dev, gidx, valid = jax_shard_stack(imgs, mesh)
    n_pad = int(imgs_dev.shape[0])
    cut = np.full(2, 0.25, np.float32)
    cfg = JaxConfig(**GEOM)
    p, avg = jax_loop.make_device_loop(cfg, 2, cut, mesh=mesh,
                                       sampler="gather", shift_chunk=9)(
        imgs_dev, imgs.mean(0), JaxParams.zeros(n_pad), gidx, valid)
    _assert_loop_params(got["loop_params"], _jax_loop_params(p))
    _assert_sums_close(got["loop_avg"], np.asarray(avg), rel=1e-4)
    p, refs = jax_loop.make_mref_device_loop(
        cfg, 2, K, cut, mesh=mesh, sampler="gather", shift_chunk=9)(
        imgs_dev, base, JaxParams.zeros(n_pad), gidx, valid)
    _assert_loop_params(got["mloop_params"], _jax_loop_params(p))
    _assert_sums_close(got["mloop_refs"], np.asarray(refs), rel=1e-4)


def test_ctf_and_fourvar_match_single_process(ranks):
    outs, inp = ranks
    got = outs[0]
    quiet = RunLogger(None, quiet=True)
    ctf = dict(dfu=inp["ctf_dfu"], apix=2.0)
    want = mref_ali2d(inp["imgs"], inp["base"], device="cpu", log=quiet,
                      CTF=True, ctf_params=ctf, **MREF)
    np.testing.assert_array_equal(got["ctf_assignments"], want.assignments)
    _assert_tables_match(got["ctf_params"], want.params)
    _assert_sums_close(got["ctf_references"], want.references)

    prm = AlignParams(*[inp["p_" + f] for f in AlignParams._fields])
    var, rvar = fourier_variance(inp["imgs"], prm)
    _assert_sums_close(got["fv_var"], var)
    _assert_sums_close(got["fv_rvar"], rvar)


def test_fourvar_driver_matches_single_process(ranks, tmp_path):
    """ali2d_base --Fourvar from a one-iteration start (the first
    iteration's variance divides by a rounding residue, see
    tests/test_torch_fourvar.py)."""
    got = ranks[0][0]
    imgs1 = ranks[1]["imgs1"]
    quiet = RunLogger(None, quiet=True)
    ali2d_base(imgs1, outdir=str(tmp_path), device="cpu", log=quiet,
               **dict(REFFREE, maxit=1))
    want = ali2d_base(imgs1, outdir=str(tmp_path), device="cpu", log=quiet,
                      Fourvar=True, resume=True, **REFFREE)
    _assert_tables_match(got["fourvar_params"], want.params)
    np.testing.assert_allclose(got["fourvar_criteria"], want.criteria,
                               rtol=1e-4)


class _Lines(RunLogger):
    """A logger that keeps its lines."""

    lines: list

    def add(self, msg):
        self.__dict__.setdefault("lines", []).append(msg)


def test_reseed_from_rank_1_matches_single_process(ranks):
    """The third reference takes no particle; the driver draws a
    particle held by rank 1, which sends it: the references and the
    assignments are the single-process run's."""
    outs, inp = ranks
    got = outs[0]
    seed = int(inp["reseed_seed"])
    pick = random.Random(seed).randint(0, RESEED_N - 1)
    assert block_owner(pick, RESEED_N, _mesh(0, WORLD)) == 1
    log = _Lines(None, quiet=True)
    want = mref_ali2d(inp["imgs"][:RESEED_N], inp["refs_vanish"],
                      device="cpu", log=log, rand_seed=seed, **MREF)
    assert "   reseeded vanished classes: [2]" in log.lines
    np.testing.assert_array_equal(got["reseed_assignments"],
                                  want.assignments)
    _assert_sums_close(got["reseed_references"], want.references)
    np.testing.assert_array_equal(outs[1]["reseed_references"],
                                  got["reseed_references"])


CLI = r"""
import sys
from cryo_ralib_tpu_torch.cli import mref
argv = sys.argv[1:]
for outdir, devices in ((argv[2] + "_1", "1"), (argv[2] + "_2", "2")):
    rc = mref.main(argv[:2] + [outdir, "--devices=" + devices,
                               "--ou=16", "--xr=1", "--ts=1", "--maxit=2",
                               "--sampler=gather"], device="cpu")
    assert rc == 0, rc
assert "jax" not in sys.modules
"""


def test_cli_two_ranks_writes_the_single_process_files(tmp_path):
    """``cli.mref --devices=2`` on the CPU (two spawned gloo workers)
    writes the single-process run's final2Dparams.txt and aqm headers
    (members and ave_n equal, images within 1e-5 of their largest)."""
    from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf
    from cryo_ralib_tpu_torch.io.mrc import write_mrc

    inp = _inputs()
    write_mrc(str(tmp_path / "stack.mrcs"), inp["imgs"])
    write_mrc(str(tmp_path / "refs.mrcs"), inp["base"])
    out = str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", CLI, str(tmp_path / "stack.mrcs"),
         str(tmp_path / "refs.mrcs"), out], cwd=REPO, capture_output=True,
        text=True, timeout=RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    one, two = out + "_1", out + "_2"
    assert sorted(os.listdir(one)) == sorted(os.listdir(two))
    _assert_tables_match(np.loadtxt(os.path.join(two, "final2Dparams.txt")),
                         np.loadtxt(os.path.join(one, "final2Dparams.txt")))
    for it in range(2):
        a, ha = read_own_hdf(os.path.join(two, f"aqm{it:03d}.hdf"))
        b, hb = read_own_hdf(os.path.join(one, f"aqm{it:03d}.hdf"))
        assert [h["ave_n"] for h in ha] == [h["ave_n"] for h in hb]
        assert [h["members"] for h in ha] == [h["members"] for h in hb]
        _assert_sums_close(a, b)
    with open(os.path.join(two, "logfile.txt")) as f:
        assert "2 ranks, backend gloo" in f.read()


FAILING = r"""
import sys
import torch
from cryo_ralib_tpu_torch.cli.common import launch
from cryo_ralib_tpu_torch.cli.mref import build_parser
from cryo_ralib_tpu_torch.parallel.mesh import barrier


def run(args, device, mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    barrier(mesh)      # rank 0 waits for a rank that is gone
    return 0


if __name__ == "__main__":
    args = build_parser().parse_args(sys.argv[1:])
    sys.exit(launch(run, args, torch.device("cpu")))
"""


def test_a_failing_rank_fails_the_launcher(tmp_path):
    """``cli.common.launch`` with two spawned ranks, rank 1 raising while
    rank 0 waits in a collective: the others are ended and the launcher
    exits 1 naming the error, well inside the 120 s limit."""
    script = tmp_path / "failing.py"
    script.write_text(FAILING)
    proc = subprocess.run(
        [sys.executable, str(script), "s.mrcs", "r.mrcs",
         str(tmp_path / "out"), "--devices=2"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=RANK_TIMEOUT)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "rank 1 fails" in proc.stderr


DYING = r"""
import os, sys
rank, tmp = int(sys.argv[1]), sys.argv[2]
import torch
from cryo_ralib_tpu_torch.parallel.mesh import (all_reduce_sums,
                                                initialize_distributed)
mesh = initialize_distributed(rank=rank, world_size=2,
                              init_method="file://" + tmp + "/store",
                              device="cpu", timeout=10)
if rank == 1:
    os._exit(0)        # gone without a word
all_reduce_sums(mesh, torch.ones(3))
print("all_reduce returned")
"""


def test_a_dead_rank_fails_the_others_within_the_timeout(tmp_path):
    """Separate processes (as under torchrun): rank 1 dies after joining,
    rank 0's all-reduce raises within the group's 10 s timeout rather
    than hang."""
    procs = [subprocess.Popen([sys.executable, "-c", DYING, str(r),
                               str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        out = procs[0].communicate(timeout=RANK_TIMEOUT)[0]
        procs[1].communicate(timeout=RANK_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert procs[0].returncode != 0, out
    assert "all_reduce returned" not in out

