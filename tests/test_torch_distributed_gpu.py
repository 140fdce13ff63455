"""Two ranks on the card(s): ``mref_ali2d`` and the engine on a
``ParticleMesh`` against one process, through the search kernel.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.
They import no JAX, so on the GPU machine they run with::

    python -m pytest --noconftest -m cuda tests/test_torch_distributed_gpu.py

The two ranks are processes of their own (``subprocess``, 300 s each,
the process group's timeout 120 s), joined through a file store: NCCL
over two cards where at least two are visible, else gloo with both
ranks on ``cuda:0`` (the backend rule of ``parallel/mesh.py``).  At
N=2048, 90 px, K=8, ou=36, xr=yr=3:

* one engine iteration: the winners (class, mirror) equal one
  process's, the angles within 1e-4, the class sums within 1e-5 of their
  largest value (only the reduction order differs), the counts equal;
* ``mref_ali2d``, 2 iterations: exactly one search-kernel launch per
  rank per iteration (each rank's counters), at least 99.9% of the
  assignments equal to one process's and the params within 1e-3 where
  they agree;
* under NCCL, the multireference device loop runs under
  ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); under
  gloo a CUDA tensor is staged through the host, so the check is not
  made there;
* the 2-D mesh (dp=1, ref=2): one engine iteration at K=64, one kernel
  launch per rank on its 32 references, held to one process by the
  first bullet's rules.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.ops.masks import model_circle, normalize_mask
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, OU, XR, K, N, MAXIT = 90, 36, 3.0, 8, 2048, 2
RANK_TIMEOUT = 300

WORKER = r"""
import json, os, sys
rank, tmp = int(sys.argv[1]), sys.argv[2]
import numpy as np
import torch
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import make_mref_device_loop
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.parallel.mesh import (
    StackShard, initialize_distributed, shard_range, shutdown)
from cryo_ralib_tpu_torch.utils.log import RunLogger

mesh = initialize_distributed(rank=rank, world_size=2,
                              init_method="file://" + tmp + "/store",
                              device="cuda", timeout=120)
torch.backends.cuda.matmul.allow_tf32 = False
inp = np.load(os.path.join(tmp, "inputs.npz"))
tmpl = inp["tmpl"]
n = inp["imgs"].shape[0]
s, e = shard_range(n, mesh)
cfg = AlignConfig(img_dim=%(nx)d, ring_num=%(ou)d, shift_step=1.0,
                  shift_rng_x=%(xr)r, shift_rng_y=%(xr)r)
eng = AlignmentEngine(StackShard(inp["norm"][s:e], s, n), cfg,
                      n_classes=len(tmpl), mesh=mesh)
it = eng.iterate(inp["refs"])
p = eng.params_np()
fs.reset_launches()
res = mref_ali2d(StackShard(inp["imgs"][s:e], s, n), tmpl, ou=%(ou)d,
                 xr=%(xr)r, yr=%(xr)r, ts=1, maxit=%(maxit)d, mesh=mesh,
                 log=RunLogger(None, quiet=True))
torch.cuda.synchronize()
launches = dict(fs.fused_search.launches)
nccl = "nccl" in mesh.backend
if nccl:
    dev = mesh.device
    loop = make_mref_device_loop(cfg, 2, len(tmpl), np.full(2, 0.25),
                                 mesh=mesh)
    args = (torch.as_tensor(inp["norm"][s:e], device=dev),
            torch.as_tensor(inp["refs"], device=dev),
            AlignParams.zeros(e - s, dev), torch.arange(s, e, device=dev),
            torch.ones(e - s, device=dev))
    loop(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
np.savez(os.path.join(tmp, "out%%d.npz" %% rank), sums=it.class_sums,
         counts=it.counts, ref_id=p.ref_id, mirror=p.mirror, angle=p.angle,
         params=res.params, assign=res.assignments)
with open(os.path.join(tmp, "rank%%d.json" %% rank), "w") as f:
    json.dump({"backend": mesh.backend, "device": str(mesh.device),
               "launches": launches, "sync_checked": nccl}, f)
shutdown()
assert "jax" not in sys.modules
"""


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _run_ranks(tmp):
    code = WORKER % dict(nx=NX, ou=OU, xr=XR, maxit=MAXIT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-4000:]


def test_two_ranks_match_one_process(cuda_device, tmp_path):
    dev = cuda_device
    tmpl = asymmetric_templates(K, NX)
    imgs = scattered_stack(tmpl, N, max_shift=2, noise=1.0, seed=7)[0]
    mask = torch.as_tensor(model_circle(OU, NX))
    norm = normalize_mask(imgs, mask, no_sigma=False)
    refs = normalize_mask(torch.as_tensor(tmpl), mask, no_sigma=True)
    np.savez(tmp_path / "inputs.npz", tmpl=tmpl, imgs=imgs.numpy(),
             norm=norm.numpy(), refs=refs.numpy())
    _run_ranks(tmp_path)

    cfg = AlignConfig(img_dim=NX, ring_num=OU, shift_step=1.0,
                      shift_rng_x=XR, shift_rng_y=XR)
    eng = AlignmentEngine(norm.to(dev), cfg, n_classes=K, device=dev)
    want = eng.iterate(refs.numpy())
    wp = eng.params_np()
    res = mref_ali2d(imgs.to(dev), tmpl, ou=OU, xr=XR, yr=XR, ts=1,
                     maxit=MAXIT, device=dev, log=RunLogger(None, quiet=True))
    n_dev = torch.cuda.device_count()
    for r in range(2):
        got = dict(np.load(tmp_path / f"out{r}.npz"))
        info = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert info["backend"] == ("cpu:gloo,cuda:nccl" if n_dev >= 2
                                   else "gloo")
        assert info["device"] == f"cuda:{r % n_dev}"
        assert info["sync_checked"] == (n_dev >= 2)
        assert info["launches"]["search"] == MAXIT, info
        np.testing.assert_array_equal(got["ref_id"], wp.ref_id)
        np.testing.assert_array_equal(got["mirror"], wp.mirror)
        d = np.abs(got["angle"] - wp.angle)
        assert np.minimum(d, 360.0 - d).max() < 1e-4
        np.testing.assert_array_equal(got["counts"], want.counts)
        np.testing.assert_allclose(got["sums"], want.class_sums, rtol=0,
                                   atol=1e-5 * np.abs(want.class_sums).max())
        same = got["assign"] == res.assignments
        assert same.mean() >= 0.999, same.mean()
        a, b = got["params"][same], res.params[same]
        d = np.abs(a[:, 0] - b[:, 0])
        assert np.minimum(d, 360.0 - d).max() < 1e-3
        np.testing.assert_array_equal(a[:, 3], b[:, 3])
        assert np.abs(a[:, 1:3] - b[:, 1:3]).max() < 1e-3


WORKER_2D = r"""
import json, os, sys
rank, tmp = int(sys.argv[1]), sys.argv[2]
import numpy as np
import torch
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.parallel import make_mesh_2d
from cryo_ralib_tpu_torch.parallel.mesh import (initialize_distributed,
                                                ref_slice, shutdown)

initialize_distributed(rank=rank, world_size=2,
                       init_method="file://" + tmp + "/store", device="cuda",
                       timeout=120)
mesh = make_mesh_2d(1, 2)
torch.backends.cuda.matmul.allow_tf32 = False
inp = np.load(os.path.join(tmp, "inputs.npz"))
cfg = AlignConfig(img_dim=%(nx)d, ring_num=%(ou)d, shift_step=1.0,
                  shift_rng_x=%(xr)r, shift_rng_y=%(xr)r)
eng = AlignmentEngine(inp["norm"], cfg, n_classes=len(inp["refs"]),
                      mesh=mesh)
fs.reset_launches()
it = eng.iterate(inp["refs"])
torch.cuda.synchronize()
launches = {"%%s K=%%d" %% key: n
            for key, n in fs.fused_search.launches_by_k.items()}
p = eng.params_np()
np.savez(os.path.join(tmp, "out2d%%d.npz" %% rank), sums=it.class_sums,
         counts=it.counts, ref_id=p.ref_id, mirror=p.mirror, angle=p.angle)
with open(os.path.join(tmp, "rank2d%%d.json" %% rank), "w") as f:
    json.dump({"launches": launches, "slice": ref_slice(len(inp["refs"]),
                                                         mesh)}, f)
shutdown()
assert "jax" not in sys.modules
"""


def test_ref_split_over_two_ranks_matches_one_process(cuda_device, tmp_path):
    """The 2-D mesh (dp=1, ref=2) on the card(s): one engine iteration at
    K=64, each rank launching the search kernel once on its 32
    references; the ranks' merged winners (class, mirror) equal one
    process's, the angles within 1e-4, the counts equal and the class
    sums within 1e-5 of their largest (each rank sums half the
    particles)."""
    from cryo_ralib_tpu_torch.utils.synthetic import unit_sigma_blobs

    k = 64
    tmpl = unit_sigma_blobs(k, NX).astype(np.float32)
    imgs = scattered_stack(tmpl, N, max_shift=2, noise=1.0, seed=9)[0]
    mask = torch.as_tensor(model_circle(OU, NX))
    norm = normalize_mask(imgs, mask, no_sigma=False)
    refs = normalize_mask(torch.as_tensor(tmpl), mask, no_sigma=True)
    np.savez(tmp_path / "inputs.npz", norm=norm.numpy(), refs=refs.numpy())
    code = WORKER_2D % dict(nx=NX, ou=OU, xr=XR)
    env = {key: v for key, v in os.environ.items()
           if key not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                          "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-4000:]

    cfg = AlignConfig(img_dim=NX, ring_num=OU, shift_step=1.0,
                      shift_rng_x=XR, shift_rng_y=XR)
    eng = AlignmentEngine(norm.to(cuda_device), cfg, n_classes=k,
                          device=cuda_device)
    want = eng.iterate(refs.numpy())
    wp = eng.params_np()
    for r in range(2):
        got = dict(np.load(tmp_path / f"out2d{r}.npz"))
        info = json.loads((tmp_path / f"rank2d{r}.json").read_text())
        assert info["slice"] == [32 * r, 32 * (r + 1)]
        assert info["launches"] == {"search K=32": 1}, info
        np.testing.assert_array_equal(got["ref_id"], wp.ref_id)
        np.testing.assert_array_equal(got["mirror"], wp.mirror)
        d = np.abs(got["angle"] - wp.angle)
        assert np.minimum(d, 360.0 - d).max() < 1e-4
        np.testing.assert_array_equal(got["counts"], want.counts)
        np.testing.assert_allclose(got["sums"], want.class_sums, rtol=0,
                                   atol=1e-5 * np.abs(want.class_sums).max())
