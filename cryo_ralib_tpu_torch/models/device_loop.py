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
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AlignConfig
from ..params import AlignParams
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
           sampler: str, n_refs: int = 1):
    """Device, sampler and the (n_iter,) cutoff / falloff schedules on
    the device, with the search's tables copied there."""
    device = resolve_device(device)
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


def make_device_loop(cfg: AlignConfig, n_iter: int, cutoffs, falloffs=None,
                     device="cuda", sampler: str = "auto"):
    """Build the ``n_iter``-iteration reference-free loop.

    Args:
      cutoffs: per-iteration tangent-filter cutoffs, length ``n_iter``
        (<= 0 leaves that iteration's average unfiltered).
      falloffs: per-iteration falloffs (default 0.1).
      device: where the loop runs, the GPU unless ``device="cpu"``.
      sampler: "auto" (the kernel on CUDA, plain on the CPU), "kernel" or
        "plain".

    Returns ``run(images, avg0, params, gidx, valid) -> (params, avg)``:
    images (N, H, W), avg0 (H, W), params ``AlignParams``, gidx (N,)
    global particle ids, valid (N,) 0/1 float mask, all on ``device``.
    """
    device, sampler, cut, fall = _build(cfg, n_iter, cutoffs, falloffs,
                                        device, sampler)

    def run(images, avg0, params: AlignParams, gidx, valid):
        avg = torch.as_tensor(avg0, dtype=torch.float32, device=device)
        n_total = valid.sum()
        for i in range(n_iter):
            out = align_step(images, filt_tanl_dyn(avg, cut[i], fall[i])[None],
                             params, gidx, valid, cfg, n_classes=1,
                             update_ref=False, sampler=sampler)
            params = out.params
            avg = (out.class_sums[0, 0] + out.class_sums[0, 1]) / n_total
        return params, avg

    return run


def make_mref_device_loop(cfg: AlignConfig, n_iter: int, n_classes: int,
                          cutoffs, falloffs=None, device="cuda",
                          sampler: str = "auto"):
    """Multireference ``make_device_loop``: K references stay on the
    device and are rebuilt from the class sums every iteration.

    Returns ``run(images, refs0, params, gidx, valid) -> (params, refs)``.
    """
    device, sampler, cut, fall = _build(cfg, n_iter, cutoffs, falloffs,
                                        device, sampler, n_classes)

    def run(images, refs0, params: AlignParams, gidx, valid):
        refs = torch.as_tensor(refs0, dtype=torch.float32, device=device)
        for i in range(n_iter):
            out = align_step(images, filt_tanl_dyn(refs, cut[i], fall[i]),
                             params, gidx, valid, cfg, n_classes=n_classes,
                             sampler=sampler)
            params, sums, counts = out.params, out.class_sums, out.counts
            new_refs = ((sums[:, 0] + sums[:, 1])
                        / counts.clamp(min=1).float()[:, None, None])
            refs = torch.where((counts < 4)[:, None, None], refs, new_refs)
        return params, refs

    return run


def ref_free_alignment_2d(images, n_iter: int = 10, ou: int = -1,
                          xr: float = 2.0, yr: float = -1.0, ts: float = 1.0,
                          cutoff: float = 0.25, falloff: float = 0.1,
                          device="cuda", sampler: str = "auto"):
    """Run the reference-free loop on a stack (N, H, W; numpy or tensor),
    as the CUDA standalone harness does: iteration 0 starts from the
    float32 mean of the stack, and a fixed tanh cutoff stands in for the
    host FSC fit.  One device, every particle valid.

    Returns (``AlignParams`` of numpy arrays, final average as numpy).
    """
    device = resolve_device(device)
    n, _ny, nx = images.shape
    last_ring = int(ou) if int(ou) != -1 else nx // 2 - 2
    if yr is None or yr < 0:
        yr = xr
    cfg = AlignConfig(img_dim=nx, ring_num=last_ring, ring_len=256,
                      shift_step=float(ts), shift_rng_x=float(xr),
                      shift_rng_y=float(yr))
    imgs = torch.as_tensor(images, dtype=torch.float32,
                           device=device).contiguous()
    loop = make_device_loop(cfg, n_iter, np.full(n_iter, cutoff),
                            np.full(n_iter, falloff), device=device,
                            sampler=sampler)
    params, avg = loop(imgs, imgs.mean(0), AlignParams.zeros(n, device),
                       torch.arange(n, device=device),
                       torch.ones(n, device=device))
    return (AlignParams(*[f.cpu().numpy() for f in params]),
            avg.cpu().numpy())
