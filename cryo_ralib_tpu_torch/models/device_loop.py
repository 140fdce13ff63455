"""Device-resident alignment loops (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/device_loop.py``: the whole
multi-iteration loop runs on the device with no host round trip.  Per
iteration the reference(s) are tangent-filtered at a scheduled cutoff
(``filt_tanl_dyn``; the schedule stands in for the drivers' host FSC
fit), every particle is searched against them and the even/odd class
sums rebuild them: each iteration is one ``align_step``.  JAX compiles
the loop into one ``lax.fori_loop``; here it is a Python loop that only
queues device work: its body reads
nothing back to the host (no ``.item()``, no ``.cpu()``, no tensor made
from host memory, no shape that depends on the data), so the card never
waits for the host.  The tables an iteration reads are copied to the
device when the loop is built.

The search is the hand-written CUDA kernel on a CUDA device
(``sampler="auto"`` or ``"kernel"``; mode "H" included) and its plain
PyTorch version with ``"plain"`` or on the CPU; a ``cfg`` with
``ring_scheme="eman2"`` runs the eman2 PyTorch search on either device;
the class sums are the bilinear ``transform_batch`` + ``class_sum_oe``,
the JAX loops' ``gather`` branch.
In the multireference loop a class with fewer than 4 members keeps its
previous reference, where ``mref_ali2d`` reseeds it from a random
particle: the host RNG has no place in the loop.

Under a ``mesh`` (``parallel/mesh.py``) each rank runs the loop on its
block of particles with their global indices, and every iteration
all-reduces its sums (one float32 buffer: the class sums, and in the
multireference loop the counts) before the average or the references
are rebuilt, so every rank carries the same references.  Under NCCL
the all-reduce is queued on the device like the rest of the body, and
the loop still makes no host sync; under gloo a CUDA tensor is staged
through the host, which waits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AlignConfig
from ..params import AlignParams
from ..parallel.mesh import all_reduce_sums, gather_params, shard_stack
from ..ops.eman_search import eman_tables
from ..ops.filters import device_freq_grid, filt_tanl_dyn
from ..ops.fused_search import kernel_tables
from ..ops.search import search_tables
from .engine import resolve_device
from .steps import align_step, resolve_sampler


def _schedule(values, n_iter: int, default: float, device) -> torch.Tensor:
    arr = (np.full(n_iter, default, np.float32) if values is None
           else np.asarray(values, np.float32))
    if arr.shape != (n_iter,):
        raise ValueError(f"schedule of shape {arr.shape}, expected "
                         f"({n_iter},)")
    return torch.as_tensor(arr, device=device)


def _build(cfg: AlignConfig, n_iter: int, cutoffs, falloffs, device,
           sampler: str, n_refs: int = 1, mesh=None):
    """Device (the mesh's where there is one), sampler and the (n_iter,)
    cutoff / falloff schedules on the device, with the search's tables
    copied there."""
    device = resolve_device(device if mesh is None else mesh.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sampler = resolve_sampler(sampler, device, cfg, n_refs=n_refs)
    search_tables(cfg, device)
    device_freq_grid(cfg.img_dim, cfg.img_dim, device)
    if cfg.ring_scheme == "eman2":
        eman_tables(cfg, device)
    elif sampler == "kernel" and device.type == "cuda":
        kernel_tables(cfg, device)
    return (device, sampler, _schedule(cutoffs, n_iter, 0.0, device),
            _schedule(falloffs, n_iter, 0.1, device))


def _reduce(mesh, sums, counts=None):
    """The class sums (and counts) summed over the ranks, in one float32
    all-reduce (counts below 2**24 are exact in float32)."""
    if mesh is None:
        return sums, counts
    if counts is None:
        return all_reduce_sums(mesh, sums)[0], None
    k = counts.shape[0]
    buf = torch.cat([sums.reshape(-1), counts.to(sums.dtype)])
    all_reduce_sums(mesh, buf)
    return buf[:-k].reshape(sums.shape), buf[-k:].to(counts.dtype)


def make_device_loop(cfg: AlignConfig, n_iter: int, cutoffs, falloffs=None,
                     device="cuda", sampler: str = "auto", mesh=None):
    """Build the ``n_iter``-iteration reference-free loop.

    Args:
      cutoffs: per-iteration tangent-filter cutoffs, length ``n_iter``
        (<= 0 leaves that iteration's average unfiltered).
      falloffs: per-iteration falloffs (default 0.1).
      device: where the loop runs, the GPU unless ``device="cpu"``.
      sampler: "auto" (the kernel on CUDA, plain on the CPU), "kernel" or
        "plain".
      mesh: a ``ParticleMesh``: the loop runs on ``mesh.device`` on the
        rank's block, and the sums are all-reduced every iteration.

    Returns ``run(images, avg0, params, gidx, valid) -> (params, avg)``:
    images (N, H, W), avg0 (H, W), params ``AlignParams``, gidx (N,)
    global particle ids, valid (N,) 0/1 float mask, all on ``device``
    (under a mesh, the rank's block of each; the average is the whole
    stack's, on every rank).
    """
    device, sampler, cut, fall = _build(cfg, n_iter, cutoffs, falloffs,
                                        device, sampler, mesh=mesh)

    def run(images, avg0, params: AlignParams, gidx, valid):
        avg = torch.as_tensor(avg0, dtype=torch.float32, device=device)
        n_total = _reduce(mesh, valid.sum())[0]
        for i in range(n_iter):
            out = align_step(images, filt_tanl_dyn(avg, cut[i], fall[i])[None],
                             params, gidx, valid, cfg, n_classes=1,
                             update_ref=False, sampler=sampler)
            params = out.params
            sums = _reduce(mesh, out.class_sums)[0]
            avg = (sums[0, 0] + sums[0, 1]) / n_total
        return params, avg

    return run


def make_mref_device_loop(cfg: AlignConfig, n_iter: int, n_classes: int,
                          cutoffs, falloffs=None, device="cuda",
                          sampler: str = "auto", mesh=None):
    """Multireference ``make_device_loop``: K references stay on the
    device and are rebuilt from the class sums every iteration (under a
    ``mesh``, the sums and counts all-reduced first).

    Returns ``run(images, refs0, params, gidx, valid) -> (params, refs)``.
    """
    device, sampler, cut, fall = _build(cfg, n_iter, cutoffs, falloffs,
                                        device, sampler, n_classes, mesh)

    def run(images, refs0, params: AlignParams, gidx, valid):
        refs = torch.as_tensor(refs0, dtype=torch.float32, device=device)
        for i in range(n_iter):
            out = align_step(images, filt_tanl_dyn(refs, cut[i], fall[i]),
                             params, gidx, valid, cfg, n_classes=n_classes,
                             sampler=sampler)
            params = out.params
            sums, counts = _reduce(mesh, out.class_sums, out.counts)
            new_refs = ((sums[:, 0] + sums[:, 1])
                        / counts.clamp(min=1).float()[:, None, None])
            refs = torch.where((counts < 4)[:, None, None], refs, new_refs)
        return params, refs

    return run


def ref_free_alignment_2d(images, n_iter: int = 10, ou: int = -1,
                          xr: float = 2.0, yr: float = -1.0, ts: float = 1.0,
                          cutoff: float = 0.25, falloff: float = 0.1,
                          device="cuda", sampler: str = "auto", mesh=None):
    """Run the reference-free loop on a stack (N, H, W; numpy or tensor),
    as the CUDA standalone harness does: iteration 0 starts from the
    float32 mean of the stack, and a fixed tanh cutoff stands in for the
    host FSC fit.  Every particle valid; under a ``mesh`` each rank runs
    its block (``images`` the whole stack or a ``StackShard``) and the
    params come back gathered.

    Returns (``AlignParams`` of numpy arrays, final average as numpy).
    """
    device = resolve_device(device if mesh is None else mesh.device)
    n, _ny, nx = images.shape
    local, gidx = shard_stack(images, mesh)
    last_ring = int(ou) if int(ou) != -1 else nx // 2 - 2
    if yr is None or yr < 0:
        yr = xr
    cfg = AlignConfig(img_dim=nx, ring_num=last_ring, ring_len=256,
                      shift_step=float(ts), shift_rng_x=float(xr),
                      shift_rng_y=float(yr))
    imgs = torch.as_tensor(local, dtype=torch.float32,
                           device=device).contiguous()
    loop = make_device_loop(cfg, n_iter, np.full(n_iter, cutoff),
                            np.full(n_iter, falloff), device=device,
                            sampler=sampler, mesh=mesh)
    m = imgs.shape[0]
    avg0 = (imgs.mean(0) if mesh is None
            else _reduce(mesh, imgs.sum(0))[0] / n)
    params, avg = loop(imgs, avg0, AlignParams.zeros(m, device),
                       gidx.to(device), torch.ones(m, device=device))
    if mesh is not None:
        return gather_params(params, n, mesh), avg.cpu().numpy()
    return (AlignParams(*[f.cpu().numpy() for f in params]),
            avg.cpu().numpy())
