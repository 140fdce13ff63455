"""Alignment execution engine: resident or streamed particle stacks
(PyTorch).

Counterpart of ``cryo_ralib_tpu/models/engine.py::AlignmentEngine``.
Each iteration runs ``align_step`` (or ``align_step_shc`` /
``align_step_scf`` under a ``random_method``) in one of two modes, which
give the same results:

* **resident**: the stack fits the device (``parallel/batching.py``):
  it is moved there once, the AlignParams (and SHC's ``previousmax``)
  stay there across iterations, one step per iteration;
* **streaming**: a larger stack stays in pinned host memory with its
  params; every iteration sends consecutive batches through the same
  step, with their global indices (so the even/odd split is the
  resident one).  Batch i+1 is uploaded on a second CUDA stream while
  batch i computes, into one of two device buffers whose reuse is
  ordered by events; the class sums, counts and centering sums add up
  on the device, the params and peaks go back to the host with
  ``non_blocking`` copies, and the host waits once per iteration.  The
  last batch is simply shorter (nothing is recompiled).

Under a ``mesh`` (``parallel/mesh.py::ParticleMesh``) the engine holds
only the rank's block of particles, resident or streamed, with their
global indices; ``iterate`` all-reduces the class sums (one float32
buffer) and the counts, centering sums and SHC's ``nope`` (another
float64 buffer) once per iteration, and ``params_np`` / ``previousmax_np``
gather every rank's block to the whole stack.  On a 2-D mesh
(``make_mesh_2d``) the ranks of a ref group hold the same block, each
step searches the rank's slice of the references and merges the
winners over the group (``models/steps.py``), each rank sums its share
of the block, and the gathers run over the dp group; the references
must split evenly over ``ref`` (``ValueError`` otherwise, as JAX's
``P("ref")`` placement refuses them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import AlignConfig
from ..params import AlignParams, params_from_numpy
from ..ops.search import PREVIOUSMAX_INIT, delta_angle_mask
from ..parallel.batching import plan_batch_size
from ..parallel.mesh import (all_reduce_sums, check_ref_split,
                             gather_params, gather_rows, ref_group_min,
                             shard_range, shard_stack)
from ..utils.profiling import span
from .steps import (Route, align_step, align_step_scf, align_step_shc,
                    resolve_route)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises
    rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} needs CUDA, which is not available here; "
            "pass device='cpu' to run on the CPU")
    return dev


def plan_batch(n: int, route: Route, cfg: AlignConfig, device,
               batch_size: int | None = None, log=None, mesh=None) -> int:
    """The engine's batch for a stack (or a rank's block) of ``n``:
    ``batch_size`` where given, else the planner's for the job's
    ``route`` (``resolve_route``: its search over the references that
    the rank searches), with the card's memory shared by the ranks of
    ``mesh`` that share it; a batch of ``n`` or more means resident.
    Under a ``ref`` split the ranks of a ref group take the least of
    their plans: each plans from the memory its card has free, and they
    must step through the same batches, since each batch's merge is a
    collective of the group.  ``log`` (a callable) gets the plan."""
    if batch_size is None:
        own = plan_batch_size(n, route, cfg, device=device, log=log,
                              ranks_on_device=1 if mesh is None
                              else mesh.ranks_on_device)
        batch_size = ref_group_min(own, mesh)
        if log is not None and batch_size != own:
            log(f"batch plan: batches of {batch_size}, the least plan of "
                "the ref group")
    return max(1, min(int(batch_size), n))


def host_stack(data, pin: bool) -> torch.Tensor:
    """(N, H, W) float32 contiguous CPU tensor of ``data`` (numpy or a
    tensor anywhere), in pinned memory where ``pin``; a tensor that is
    already so is used as it is."""
    t = (data.detach() if torch.is_tensor(data)
         else torch.from_numpy(np.ascontiguousarray(data, np.float32)))
    if (t.device.type == "cpu" and t.dtype == torch.float32
            and t.is_contiguous() and (t.is_pinned() or not pin)):
        return t
    out = torch.empty(tuple(t.shape), dtype=torch.float32, pin_memory=pin)
    out.copy_(t)
    return out


# Particles per block of the drivers' preprocessing (CTF premultiplication,
# normalisation, the first even/odd sums); even, so that every block
# starts at an even index
PREP_BLOCK = 2048


def prepare_stack(images, device, resident: bool, fn) -> torch.Tensor:
    """The stack as the engine takes it, preprocessed by blocks:
    ``fn(x, start)`` maps the block of particles ``start ..`` (uploaded to
    ``device``) to its preprocessed values, which go into a new tensor on
    ``device`` when ``resident``, else into a pinned host tensor (on a
    CUDA device).  Both modes run the same blocks, so they give the same
    values."""
    n, h, w = images.shape
    device = torch.device(device)
    out = (torch.empty((n, h, w), dtype=torch.float32, device=device)
           if resident else
           torch.empty((n, h, w), dtype=torch.float32,
                       pin_memory=device.type == "cuda"))
    for s in range(0, n, PREP_BLOCK):
        x = torch.as_tensor(images[s:s + PREP_BLOCK], dtype=torch.float32,
                            device=device)
        out[s:s + PREP_BLOCK] = fn(x, s)
    return out


@dataclass
class IterationResult:
    class_sums: np.ndarray   # (K, 2, H, W)
    counts: np.ndarray       # (K,)
    peak: np.ndarray         # (N,); the rank's block under a mesh
    sx_sum: float            # mirror-aware sum of header x-shifts
    sy_sum: float            # sum of header y-shifts
    nope: int = 0            # SHC only: particles with no improving candidate


class AlignmentEngine:
    """Per-iteration executor owning the stack, batching and params.

    ``data`` is an (N, H, W) float32 array or tensor.  ``sampler``, a
    name resolved once or the job's ``Route``, is every step's
    ``.route``.  ``batch_size`` None asks the planner (``plan_batch``); a
    batch at or above N keeps the stack resident on ``device``, a smaller
    one streams it from pinned host memory (``.batch``, ``.resident``).
    ``delta`` (``--dst``)
    is the discrete-angle step that ``iterate(discrete=True)`` searches;
    its angle mask is built once, on the device.  ``random_method`` is
    "" (the standard search), "SHC" or "SCF"; ``delta`` is defined for
    the standard search only.

    ``mesh`` (a ``ParticleMesh``) runs the engine as one rank of a
    data-parallel group on ``mesh.device``: ``data`` is the whole stack
    or a ``StackShard`` of the rank's block, the engine keeps the block
    (``.start``, ``.n_local``; ``.n`` is the whole stack), and
    ``batch_size`` is a batch of the block.  On a 2-D mesh each rank
    searches its slice of the ``n_classes`` references, which must be a
    multiple of ``mesh.ref`` (``ValueError`` otherwise)."""

    def __init__(self, data, cfg: AlignConfig, n_classes: int,
                 device="cuda", sampler: str | Route = "auto",
                 update_ref: bool = True, delta: float = 0.0,
                 random_method: str = "", batch_size: int | None = None,
                 mesh=None):
        check_ref_split(n_classes, mesh)
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        self.n = int(data.shape[0])
        data, gidx = shard_stack(data, mesh)
        self.start = int(shard_range(self.n, mesh)[0])
        self.n_local = int(data.shape[0])
        self.cfg = cfg
        self.n_classes = n_classes
        self.update_ref = update_ref
        self.delta = float(delta)
        self.random_method = random_method
        if random_method not in ("", "SHC", "SCF"):
            raise ValueError(f"unsupported random_method {random_method!r} "
                             "(only '', 'SHC' and 'SCF')")
        if self.delta and random_method:
            raise ValueError("delta (--dst) is only defined for the "
                             "standard search, not random_method=%r"
                             % random_method)
        if random_method and cfg.ring_scheme != "cuda":
            raise ValueError(f"random_method={random_method!r} runs the "
                             "standard ring scheme only (ring_scheme='cuda')")
        # fail at construction where the first iteration would
        self.route = (sampler if isinstance(sampler, Route) else
                      resolve_route(sampler, self.device, cfg, random_method,
                                    n_classes, mesh))
        # the tables and the template engine's splat spectra, once per
        # engine, as the JAX engine hoists them out of its step
        self._sf = self.route.warm(cfg, self.device)
        self._iterations = 0
        self._angle_mask = None
        m = self.n_local
        self.batch = plan_batch(m, self.route, cfg, self.device, batch_size,
                                mesh=mesh)
        self.resident = self.batch >= m
        shc = random_method == "SHC"
        if self.resident:
            self._imgs = torch.as_tensor(data, dtype=torch.float32,
                                         device=self.device).contiguous()
            self._gidx = gidx.to(self.device)
            self.params = AlignParams.zeros(m, self.device)
            self._prevmax = (torch.full((m,), PREVIOUSMAX_INIT,
                                        dtype=torch.float32,
                                        device=self.device)
                             if shc else None)
            return
        pin = self.device.type == "cuda"
        self._host = host_stack(data, pin)
        self.params = AlignParams(*[
            torch.zeros(m, dtype=dt, pin_memory=pin)
            for dt in (torch.float32,) * 3 + (torch.int32,) * 2])
        self._prevmax = (torch.full((m,), PREVIOUSMAX_INIT,
                                    dtype=torch.float32, pin_memory=pin)
                         if shc else None)
        self._buffers = None

    # -- params access ---------------------------------------------------
    def params_np(self) -> AlignParams:
        """Current per-particle params of the whole stack as host numpy
        arrays (copies; under a mesh every rank's block, gathered)."""
        if self.mesh is not None:
            return gather_params(self.params, self.n, self.mesh)
        return AlignParams(*[f.cpu().numpy().copy() for f in self.params])

    def _block(self, values):
        """The rank's rows of a whole-stack array."""
        values = np.asarray(values)
        if values.shape[0] != self.n:
            raise ValueError(f"{values.shape[0]} values for a stack of "
                             f"{self.n}")
        return values[self.start:self.start + self.n_local]

    def set_params(self, params: AlignParams):
        """Restore per-particle params from host arrays of the whole stack
        (checkpoint resume); a rank keeps its block."""
        params = AlignParams(*[self._block(f) for f in params])
        if self.resident:
            self.params = params_from_numpy(params._asdict(), self.device)
            return
        for dst, src in zip(self.params, params_from_numpy(params._asdict())):
            dst.copy_(src)

    def set_ref_id(self, ref_id):
        """Preset every particle's class (``pre_align_init`` presets
        ref_id)."""
        rid = torch.as_tensor(self._block(np.asarray(ref_id, np.int32)))
        if self.resident:
            self.params = self.params._replace(ref_id=rid.to(self.device))
        else:
            self.params.ref_id.copy_(rid)

    # -- previousmax access (SHC) ----------------------------------------
    def previousmax_np(self) -> np.ndarray:
        """SHC: each particle's best ccf so far, as a host array of the
        whole stack (gathered under a mesh)."""
        if self.random_method != "SHC":
            raise ValueError("previousmax exists under random_method='SHC'")
        if self.mesh is not None:
            return gather_rows(self._prevmax, self.n, self.mesh).numpy()
        return self._prevmax.cpu().numpy().copy()

    def set_previousmax(self, pm):
        """SHC: restore ``previousmax`` from host values (checkpoint
        resume)."""
        if self.random_method != "SHC":
            raise ValueError("previousmax exists under random_method='SHC'")
        pm = torch.as_tensor(self._block(np.asarray(pm, np.float32)))
        if self.resident:
            self._prevmax = pm.to(self.device)
        else:
            self._prevmax.copy_(pm)

    # -- one iteration ---------------------------------------------------
    def _mask(self, discrete: bool):
        if not discrete:
            return None
        if not self.delta:
            raise ValueError("iterate(discrete=True) requires the engine "
                             "to be built with delta != 0 (--dst)")
        if self._angle_mask is None:
            self._angle_mask = torch.as_tensor(
                delta_angle_mask(self.cfg.ring_len, self.delta,
                                 self.cfg.mode), device=self.device)
        return self._angle_mask

    def _step(self, imgs, refs, params, gidx, prevmax, mask):
        """One step on a batch: (StepOutput, new previousmax, nope)."""
        kw = dict(n_classes=self.n_classes, sampler=self.route,
                  mesh=self.mesh)
        if self.random_method == "SCF":
            return (align_step_scf(imgs, refs, params, gidx, None, self.cfg,
                                   **kw), None, None)
        if self.random_method == "SHC":
            shc = align_step_shc(imgs, refs, params, gidx, None, prevmax,
                                 self.cfg, sf=self._sf, **kw)
            return shc.step, shc.previousmax, shc.nope
        return (align_step(imgs, refs, params, gidx, None, self.cfg,
                           update_ref=self.update_ref, angle_mask=mask,
                           sf=self._sf, **kw), None, None)

    def iterate(self, refs: np.ndarray,
                discrete: bool = False) -> IterationResult:
        """One alignment pass against (K, H, W) references.
        ``discrete=True`` restricts the rotation search to multiples of
        the engine's ``delta``."""
        self._iterations += 1
        with span("engine.iterate", iteration=self._iterations):
            mask = self._mask(discrete)
            refs_t = torch.as_tensor(np.asarray(refs, np.float32),
                                     device=self.device)
            if not self.resident:
                return self._iterate_streamed(refs_t, mask)
            with span("engine.step", start=0, end=self.n_local):
                out, prevmax, nope = self._step(
                    self._imgs, refs_t, self.params, self._gidx,
                    self._prevmax, mask)
            self.params = out.params
            if prevmax is not None:
                self._prevmax = prevmax
            return self._result(out.class_sums, out.counts, out.sx_sum,
                                out.sy_sum, nope, out.peak)

    def _result(self, sums, counts, sx, sy, nope, peak) -> IterationResult:
        """The iteration's result on the host, the sums all-reduced over
        the mesh: one float64 buffer of class sums (``ops/classavg.py``:
        the same sums for any split of the stack, rounded to float32 once
        they are whole) and one of the counts, the centering sums and
        ``nope``; ``peak`` (the rank's, not reduced) is read to the host
        here too, from the device or from pinned memory."""
        with span("engine.reduce"):
            scalars = torch.cat([
                counts.to(torch.float64),
                torch.stack([torch.as_tensor(v, device=counts.device).to(
                    torch.float64).reshape(()) for v in
                    (sx, sy, 0 if nope is None else nope)])])
            all_reduce_sums(self.mesh, sums, scalars)
            scalars = scalars.cpu().numpy()
            k = self.n_classes
            return IterationResult(
                class_sums=sums.float().cpu().numpy(),
                counts=np.rint(scalars[:k]).astype(np.int64),
                peak=(peak.numpy().copy() if peak.is_pinned()
                      else peak.cpu().numpy()),
                sx_sum=float(scalars[k]), sy_sum=float(scalars[k + 1]),
                nope=int(round(scalars[k + 2])))

    def _device_buffers(self):
        """Two sets of (images, params, previousmax, free event) of one
        batch on the device, made once, and the copy stream."""
        if self._buffers is None:
            b, dev = self.batch, self.device
            _, h, w = self._host.shape
            self._buffers = [(
                torch.empty((b, h, w), dtype=torch.float32, device=dev),
                AlignParams(*[torch.empty(b, dtype=f.dtype, device=dev)
                              for f in self.params]),
                None if self._prevmax is None else
                torch.empty(b, dtype=torch.float32, device=dev),
                torch.cuda.Event()) for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(dev)
        return self._buffers

    def _batches(self):
        """Yield (start, end, images, params, previousmax, free) of each
        batch on the device.  On a CUDA device batch i+1 is uploaded on
        the copy stream while the caller queues batch i; the caller
        records ``free`` on its stream once everything that reads the
        batch's buffers is queued, and the upload into them waits for
        it.  On the CPU the batches are slices of the host arrays."""
        spans = [(s, min(s + self.batch, self.n_local))
                 for s in range(0, self.n_local, self.batch)]
        pm = self._prevmax
        if self.device.type != "cuda":
            for s, e in spans:
                yield (s, e, self._host[s:e],
                       AlignParams(*[f[s:e].clone() for f in self.params]),
                       None if pm is None else pm[s:e].clone(), None)
            return
        bufs = self._device_buffers()
        copy = self._copy_stream
        compute = torch.cuda.current_stream(self.device)
        ready = [torch.cuda.Event() for _ in bufs]

        def upload(i):
            (s, e), (imgs, prm, pmb, free) = spans[i], bufs[i % 2]
            m = e - s
            with torch.cuda.stream(copy):
                copy.wait_event(free)
                imgs[:m].copy_(self._host[s:e], non_blocking=True)
                for dst, src in zip(prm, self.params):
                    dst[:m].copy_(src[s:e], non_blocking=True)
                if pmb is not None:
                    pmb[:m].copy_(pm[s:e], non_blocking=True)
                ready[i % 2].record(copy)

        upload(0)
        for i, (s, e) in enumerate(spans):
            if i + 1 < len(spans):
                upload(i + 1)
            compute.wait_event(ready[i % 2])
            imgs, prm, pmb, free = bufs[i % 2]
            m = e - s
            yield (s, e, imgs[:m], AlignParams(*[f[:m] for f in prm]),
                   None if pmb is None else pmb[:m], free)

    def _iterate_streamed(self, refs_t, mask) -> IterationResult:
        dev, k = self.device, self.n_classes
        _, h, w = self._host.shape
        cuda = dev.type == "cuda"
        sums = torch.zeros((k, 2, h, w), dtype=torch.float64, device=dev)
        counts = torch.zeros(k, dtype=torch.int64, device=dev)
        sx = torch.zeros((), dtype=torch.float64, device=dev)
        sy = torch.zeros((), dtype=torch.float64, device=dev)
        nope = torch.zeros((), dtype=torch.int64, device=dev)
        peak = torch.empty(self.n_local, dtype=torch.float32,
                           pin_memory=cuda)
        stream = torch.cuda.current_stream(dev) if cuda else None
        for s, e, imgs, prm, pmb, free in self._batches():
            with span("engine.step", start=s, end=e):
                gidx = torch.arange(self.start + s, self.start + e,
                                    device=dev)
                out, pm_new, nope_b = self._step(imgs, refs_t, prm, gidx,
                                                 pmb, mask)
                sums += out.class_sums
                counts += out.counts
                sx += out.sx_sum
                sy += out.sy_sum
                for dst, src in zip(self.params, out.params):
                    dst[s:e].copy_(src, non_blocking=True)
                peak[s:e].copy_(out.peak, non_blocking=True)
                if pm_new is not None:
                    self._prevmax[s:e].copy_(pm_new, non_blocking=True)
                    nope += nope_b
                if free is not None:
                    free.record(stream)
        if cuda:
            stream.synchronize()
        return self._result(sums, counts, sx, sy, nope, peak)
