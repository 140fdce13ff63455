"""One alignment iteration (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/steps.py``: ``align_step`` (search
every particle against every reference, decode the winners, transform
and sum the classes even/odd; an ``angle_mask`` (``--dst``) restricts
the angle argmax and turns off the parabolic refinement),
``align_step_shc`` (stochastic hill climbing) and ``align_step_scf``
(self-correlation alignment), and ``raw_sum_step`` (the even/odd sums
of the raw stack).

Which search runs, how the classes are summed and the kernel's launch
plan are one ``Route``: ``resolve_route`` decides it once per job from
the sampler's name, the device and the geometry, before any launch (the
rule of what the kernel runs is ``ops/fused_search.py::kernel_gate``),
and the steps, the engine, the device loops, the batch planner
(``parallel/batching.py``) and the spans read it; a step given a name
resolves it once per call.  Nothing falls back from a kernel that fails
to build or launch to the plain search.

The end of every step (``_finish_step``) transforms and class-sums the
particles by the route's ``sums``: "shear" under "template" and
"matmul", the JAX package's ``class_sum_transform_mm`` (the FFT shear),
as the JAX steps sum for them; else the bilinear ``transform_batch`` +
``class_sum_oe`` of the JAX ``gather`` step, the port's semantic
target, in one launch of the class-sum kernel (``csrc/class_sums.cu``)
on a CUDA device ("kernel") or by its plain version ("plain").  The JAX
``fused`` step, which "kernel" stands for, sums by the FFT shear
instead: the one place where a port's sampler sums otherwise than its
JAX counterpart.

Under a 2-D mesh (``mesh=`` a ``ParticleMesh`` with ``ref > 1``,
``parallel/mesh.py::make_mesh_2d``) a step searches the rank's slice of
the references (``ref_slice``) on its particle block, through whichever
search the sampler names, merges the winners over the ref group by the
search's own rule (``ops/search.py::merge_ref_slices``) before
``decode_params``, and transforms and sums only its share of the
particles (``ref_slice``): the caller's all-reduce then counts each
particle once.  The SHC and SCF steps search every reference on every
rank of the group and sum its share alike.  Every rank of the group
returns the same params and peaks.  Without a ``ref`` split the steps
run as they did, bit for bit.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..config import AlignConfig
from ..params import AlignParams, gpu_params_to_align2d
from ..ops.classavg import (class_sum_oe, class_sum_transform_mm,
                            class_sums_plain, fused_class_sums)
from ..ops.eman_search import (eman_mm_tables, eman_tables,
                               prepare_ref_spectra_eman,
                               rotational_shift_search_eman)
from ..ops.fused_search import (KernelPlan, fused_search, fused_search_shc,
                                kernel_gate, kernel_tables, launch_plan,
                                search_plain)
from ..ops.polar_mm import polar_tables as polar_mm_tables, product_route
from ..ops.scf import scf_align, zero_shift_cfg
from ..ops.search import (decode_params, empty_result, merge_ref_slices,
                          prepare_ref_spectra,
                          rotational_shift_search_mm,
                          rotational_shift_search_shc,
                          rotational_shift_search_shc_mm, search_tables)
from ..ops.template_search import (splat_spectra_groups, template_search,
                                   template_search_shc, template_supported)
from ..ops.transform import dft_tables, shear_pad
from ..parallel.mesh import ref_reduce, ref_slice
from ..utils.profiling import span

_log = logging.getLogger(__name__)


class StepOutput(NamedTuple):
    params: AlignParams
    class_sums: torch.Tensor   # (K, 2, H, W)
    counts: torch.Tensor       # (K,) int32
    peak: torch.Tensor         # (N,) best ccf value (diagnostic)
    sx_sum: torch.Tensor       # () mirror-aware sum of header x-shifts
    sy_sum: torch.Tensor       # () sum of header y-shifts


def _header_shift_sums(params: AlignParams, valid):
    """Decoded header shifts summed in f64 (the same sums for any split
    of the stack, as the class sums), x with the mirror-aware sign."""
    sx, sy = gpu_params_to_align2d(params.angle, params.shift_x,
                                   params.shift_y)
    sx, sy = sx.double(), sy.double()
    sgn = torch.where(params.mirror == 1, -1.0, 1.0).double()
    if valid is not None:
        sgn = sgn * valid
        sy = sy * valid
    return (sx * sgn).sum(), sy.sum()


class _RefPart(NamedTuple):
    """A step's share of the references under a ``ref`` split."""

    k0: int                 # the slice's first reference
    refs: torch.Tensor      # (k1 - k0, H, W): the rank's slice
    n_refs: int             # the references of the whole search
    reduce: object          # reduce(t, op) over the ref group, or None


def _ref_part(refs, mesh) -> _RefPart:
    """The rank's slice of ``refs`` and its merge's reduction (None where
    the references are not split)."""
    k = refs.shape[0]
    if mesh is None or mesh.ref == 1:
        return _RefPart(0, refs, k, None)
    k0, k1 = ref_slice(k, mesh)
    return _RefPart(k0, refs[k0:k1], k,
                   lambda t, op: ref_reduce(mesh, t, op))


@dataclass(frozen=True)
class Route:
    """What every step of a job runs, decided once (``resolve_route``)."""

    search: str     # "kernel", "plain", "template" or "matmul"
    sums: str       # "kernel" (the class-sum kernel), "plain" or "shear"
    refs: int       # the references a rank searches (its ``ref`` slice)
    method: str = ""                 # the random_method
    plan: KernelPlan | None = None   # the kernel's, where it launches

    def warm(self, cfg: AlignConfig, device):
        """Copy the tables that the route's steps read to ``device`` once
        (each table's function caches it); returns the template engine's
        splat spectra, every step's ``sf=`` (None for the other searches)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        search_tables(cfg, device)
        if cfg.ring_scheme == "eman2":
            eman_tables(cfg, device)
        elif self.plan is not None:
            kernel_tables(cfg, device)
        if self.sums == "shear":
            dft_tables(shear_pad(cfg.img_dim), device)
            product_route(device)
        if self.search == "matmul":
            (eman_mm_tables if cfg.ring_scheme == "eman2"
             else polar_mm_tables)(cfg, device)
        return (splat_spectra_groups(cfg, device)
                if self.search == "template" else None)


def resolve_route(sampler: str, device, cfg: AlignConfig,
                  random_method: str = "", n_refs: int = 1, mesh=None,
                  smem_limit: int | None = None,
                  per_particle_ref: bool = False) -> Route:
    """The route of a job's steps on ``device``: the search that
    ``sampler`` names, its class sums ("template" and "matmul" sum by
    the FFT shear), the references a rank searches of ``n_refs`` under
    ``mesh`` and the kernel's launch plan.  Nothing is built or launched.

    "auto" is the kernel on a CUDA device and plain on the CPU, the
    standard search and the SHC pick alike, except where there is no
    kernel: the eman2 rings, SHC with more than one reference (the
    kernel's SHC pick is built for one), ``per_particle_ref`` and, on a
    CUDA device, a geometry outside ``kernel_gate`` (``smem_limit``
    defaults to the device's; SCF's rotation stage is one reference at
    zero shift) run plain, which is logged; "kernel" there raises
    ``ValueError`` naming the rule.  "template" and "matmul" are taken
    only as asked, on either device: "template" raises ``ValueError``
    under SCF, for ``per_particle_ref`` and outside
    ``template_supported``, as the JAX package's steps raise; "matmul"
    has no gate, as the JAX package's.
    """
    k0, k1 = (0, n_refs) if random_method else ref_slice(n_refs, mesh)
    refs = max(1, k1 - k0)
    # SCF's rotation stage is a standard search of one reference at zero
    # shift
    gate_cfg, gate_refs = ((zero_shift_cfg(cfg), 1) if random_method == "SCF"
                           else (cfg, refs))
    search = _search_of(sampler, device, gate_cfg, random_method, gate_refs,
                        smem_limit, per_particle_ref)
    cuda = torch.device(device).type == "cuda"
    sums = ("shear" if search in ("template", "matmul")
            else "kernel" if cuda else "plain")
    plan = (launch_plan(gate_cfg, gate_refs, cfg.img_dim, cfg.img_dim,
                        smem_limit, device)
            if search == "kernel" and cuda else None)
    return Route(search, sums, refs, random_method, plan)


def _search_of(sampler: str, device, cfg: AlignConfig, random_method: str,
               n_refs: int, smem_limit: int | None,
               per_particle_ref: bool) -> str:
    """``resolve_route``'s search, on ``n_refs`` references of ``cfg``."""
    if sampler not in ("auto", "kernel", "plain", "template", "matmul"):
        raise ValueError(f"sampler must be 'auto', 'kernel', 'plain', "
                         f"'template' or 'matmul', not {sampler!r}")
    if sampler == "matmul":
        return "matmul"
    if sampler == "template":
        if random_method == "SCF":
            raise ValueError("sampler='template' has no SCF variant (as in "
                             "the JAX package) — use sampler='auto'")
        if per_particle_ref:
            raise ValueError("sampler='template' searches every reference "
                             "(no per_particle_ref)")
        if not template_supported(cfg, n_refs):
            raise ValueError(
                "sampler='template' on a configuration outside the template "
                "engine's geometry gate (ops.template_search."
                "template_supported) — use sampler='auto'")
        return "template"
    no_kernel = None
    if per_particle_ref:
        no_kernel = ("per_particle_ref (the kernel searches every "
                     "reference)")
    elif cfg.ring_scheme == "eman2":
        no_kernel = ("ring_scheme='eman2' (the kernel takes uniform "
                     "256-sample rings)")
    elif random_method == "SHC" and n_refs != 1:
        no_kernel = (f"random_method='SHC' with {n_refs} references (the "
                     "kernel's SHC pick is built for one)")
    elif (sampler != "plain"
          and (sampler == "kernel" or torch.device(device).type == "cuda")):
        gate = kernel_gate(cfg, n_refs, cfg.img_dim, cfg.img_dim,
                           smem_limit, device)
        if gate is not None:
            no_kernel = "the kernel's gate: " + gate
    if no_kernel is not None:
        if sampler == "kernel":
            raise ValueError(f"sampler='kernel' does not support {no_kernel}"
                             " — use sampler='auto' or 'plain'")
        if sampler == "auto" and torch.device(device).type == "cuda":
            _log.info("search engine: plain, not the kernel: %s", no_kernel)
        return "plain"
    if sampler == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "plain"
    return sampler


def _as_route(sampler, images, cfg: AlignConfig, method: str, n_refs: int,
              mesh) -> Route:
    """``sampler`` where it is a ``Route``, else resolved for ``images``."""
    return (sampler if isinstance(sampler, Route) else resolve_route(
        sampler, images.device, cfg, method, n_refs, mesh))


def _search_size(images, cfg: AlignConfig, route: Route, k: int) -> dict:
    """The ``step.search`` span's size counters: the box, the rings, the
    shifts and mirror channels searched, and ``ref_groups``, the kernel's
    (0 where another search runs or the rank searches no reference)."""
    return dict(box=images.shape[-1], rings=cfg.ring_num,
                shifts=cfg.n_shifts, mirrors=2 if cfg.mirror else 1,
                ref_groups=route.plan.ref_groups if route.plan and k else 0)


def align_step(images, refs, params: AlignParams, global_index, valid,
               cfg: AlignConfig, *, n_classes: int, update_ref: bool = True,
               sampler: str | Route = "auto", fast: bool = True,
               angle_mask=None, sf=None, mesh=None) -> StepOutput:
    """One alignment iteration over a resident stack.

    Args:
      images: (N, H, W) preprocessed particles.
      refs:   (K, H, W) current references (same device).
      params: AlignParams carried across iterations (shifts accumulate).
      global_index: (N,) global particle ids (even/odd parity).
      valid:  (N,) 0/1 padding mask, or None.
      cfg:    AlignConfig.
      n_classes: K.
      update_ref: False keeps every particle's ref_id.
      sampler: "kernel" = the CUDA search kernel (CUDA tensors only),
        "plain" = its PyTorch version, "template" = the template engine,
        "matmul" = the matmul sampler, "auto" = kernel on CUDA, plain on
        the CPU (``resolve_route``, once per call); or the job's
        ``Route``, used as it is.
      fast: bf16 products with f32 sums in the matmul sampler and in the
        FFT-shear class sums (the JAX package's ``fast``).
      angle_mask: optional (L,) float32 additive angle mask on the
        device of ``images`` (``delta_angle_mask``).
      sf: the template engine's splat spectra
        (``ops/template_search.py::splat_spectra_groups``), built once by
        callers that step repeatedly; None builds them here.  Read by the
        template engine only.
      mesh:   a ``ParticleMesh``; under a ``ref`` split the rank searches
        its slice of ``refs``, the ref group merges the winners, and the
        sums cover the rank's share of the particles (module docstring).
        Without a mesh, or with ``ref`` 1, it changes nothing.

    ``cfg.ring_scheme == "eman2"`` runs the variable-length Numrinit
    rings of ``ops/eman_search.py`` (the PyTorch search on either
    device, its matmul sampler, or the template engine);
    ``cfg.mode == "H"`` searches half
    rings, through the kernel on a CUDA tensor like mode "F".

    Where the ``step.search`` span records and the kernel runs, it sets
    ``interior_rings``, the ring samplings (one ring at one shift) that
    took the kernel's unclamped path (a device sum, read when the span's
    ``attrs`` are read), and ``rings_full``, N x shifts x rings.
    """
    route = _as_route(sampler, images, cfg, "", refs.shape[0], mesh)
    part = _ref_part(refs, mesh)
    k = part.refs.shape[0]
    with span("step.search", images.device, sampler=route.search,
              N=images.shape[0], K=k,
              **_search_size(images, cfg, route, k)) as sp:
        interior = _interior_counter(sp, route, images, k)
        result = _search(images, part.refs, params, cfg, route.search, fast,
                         angle_mask, sf, interior)
        _count_interior(sp, interior, cfg)
    if part.reduce is not None:
        result = merge_ref_slices(result, part.k0, cfg.n_shifts,
                                  part.n_refs, part.reduce)
    new_params = decode_params(result, params, cfg, update_ref=update_ref,
                               refine=angle_mask is None)
    return _finish_step(images, new_params, result.best_val, global_index,
                        valid, n_classes, route.sums, fast, mesh)


def _interior_counter(sp, route: Route, images, k: int):
    """(N,) int32 zeros for the kernel's count of unclamped ring
    samplings where the span records and the kernel searches ``k`` > 0
    references; else None."""
    if not (sp.recording and route.plan is not None and k):
        return None
    return torch.zeros(images.shape[0], dtype=torch.int32,
                       device=images.device)


def _count_interior(sp, interior, cfg: AlignConfig, shifts=None):
    """The span's ``interior_rings`` (the device sum of ``interior``, once
    the search has filled it) and ``rings_full``, the ring samplings of
    the search: N x shifts x rings, or where ``shifts`` (N,) holds each
    particle's shifts searched (SHC's early stop), their sum x rings;
    nothing where ``interior`` is None."""
    if interior is not None:
        searched = (interior.shape[0] * cfg.n_shifts if shifts is None
                    else shifts.sum())
        sp.set(interior_rings=interior.sum(),
               rings_full=searched * cfg.ring_num)


def _search(images, refs, params: AlignParams, cfg: AlignConfig,
            sampler: str, fast: bool, angle_mask, sf, out_interior=None):
    """The resolved ``sampler``'s search of every particle against
    ``refs``; an empty slice of the references (fewer references than
    ``ref`` ranks) searches nothing and loses every merge.
    ``out_interior``: the kernel's count (``fused_search``'s)."""
    if refs.shape[0] == 0:
        return empty_result(images.shape[0], cfg.ring_len, images.device)
    if cfg.ring_scheme == "eman2":
        ref_fw = prepare_ref_spectra_eman(refs, cfg)
        if sampler != "template":
            return rotational_shift_search_eman(
                images, ref_fw, params, cfg, angle_mask=angle_mask,
                sampler="matmul" if sampler == "matmul" else "plain",
                fast=fast)
    else:
        ref_fw = prepare_ref_spectra(refs, cfg)
    if sampler == "template":
        return template_search(images, ref_fw, params, cfg, sf=sf,
                               angle_mask=angle_mask)
    if sampler == "matmul":
        return rotational_shift_search_mm(images, ref_fw, params, cfg,
                                          fast=fast, angle_mask=angle_mask)
    if sampler == "kernel":
        return fused_search(images, ref_fw, params, cfg,
                            angle_mask=angle_mask, out_interior=out_interior)
    return search_plain(images, ref_fw, params, cfg, angle_mask=angle_mask)


def _finish_step(images, new_params: AlignParams, peak, global_index, valid,
                 n_classes: int, sums: str, fast: bool = True,
                 mesh=None) -> StepOutput:
    """Transform by the new params, sum the classes even/odd, and the
    centering sums: the end of every kind of step, by the route's
    ``sums``: "shear" (``class_sum_transform_mm``, bf16 DFTs with
    ``fast``), "kernel" (``fused_class_sums``) or "plain"
    (``class_sums_plain``).  The ``step.sums`` span says ``shear``, and
    ``sums="kernel"`` where the kernel ran, else ``"plain"``.  Under a
    ``ref`` split (``mesh``) only the rank's share of the particles
    (``ref_slice``) is transformed and summed; the params and peaks stay
    whole."""
    shear = sums == "shear"
    with span("step.sums", images.device, shear=shear,
              sums="kernel" if sums == "kernel" else "plain"):
        n = images.shape[0]
        if global_index is None:
            global_index = torch.arange(n, device=images.device)
        if valid is not None:
            peak = torch.where(valid > 0, peak, 0.0)
        a, b = ref_slice(n, mesh)
        if (a, b) != (0, n):
            sl = slice(a, b)
            images, global_index = images[sl], global_index[sl]
            valid = None if valid is None else valid[sl]
            summed = AlignParams(*[f[sl] for f in new_params])
        else:
            summed = new_params
        if shear:
            class_sums, counts = class_sum_transform_mm(
                images, summed, n_classes, global_index=global_index,
                valid=valid, fast=fast)
        else:
            class_sums, counts = (
                fused_class_sums if sums == "kernel" else class_sums_plain)(
                    images, summed, n_classes, global_index, valid)
        return _step_output(new_params, summed, class_sums, counts, peak,
                            valid)


def _step_output(new_params: AlignParams, summed: AlignParams, sums, counts,
                 peak, valid) -> StepOutput:
    """The step's output with the centering sums of the ``summed``
    particles (all of them but under a ``ref`` split; ``valid`` is
    theirs)."""
    sx_sum, sy_sum = _header_shift_sums(summed, valid)
    return StepOutput(new_params, sums, counts, peak, sx_sum, sy_sum)


def raw_sum_step(images, global_index, valid, *, n_classes: int = 1):
    """Even/odd sums (K, 2, H, W) of the raw, untransformed stack, every
    particle in class 0: iteration 0 of the reference-free loop
    (``statistics.sum_oe``)."""
    ref_id = torch.zeros(images.shape[0], dtype=torch.int32,
                         device=images.device)
    sums, _ = class_sum_oe(images, ref_id, n_classes,
                           global_index=global_index, valid=valid)
    return sums


class ShcStepOutput(NamedTuple):
    step: StepOutput
    previousmax: torch.Tensor  # (N,) each particle's best ccf so far
    nope: torch.Tensor         # () int count of particles that kept theirs


def align_step_shc(images, refs, params: AlignParams, global_index, valid,
                   previousmax, cfg: AlignConfig, *, n_classes: int,
                   sampler: str | Route = "auto", fast: bool = True,
                   sf=None, mesh=None) -> ShcStepOutput:
    """One SHC (stochastic hill climbing) iteration,
    ``random_method="SHC"``: each particle takes the first candidate
    above its ``previousmax`` rather than the global argmax; a particle
    with none keeps its params and its ``previousmax`` and counts in
    ``nope``.  The search is ``fused_search_shc`` under "kernel" (the
    kernel's SHC pick on a CUDA tensor, the plain one on the CPU),
    ``rotational_shift_search_shc`` under "plain" (``resolve_route``;
    ``sampler`` as in ``align_step``),
    ``template_search_shc`` with ``sampler="template"`` (``sf`` as in
    ``align_step``), or ``rotational_shift_search_shc_mm`` with
    ``sampler="matmul"`` (``fast`` as in ``align_step``), each called by
    its name in this module, where a caller may wrap it.  ``mesh`` as in
    ``align_step``, but every rank of a ref group searches all the
    references, as the JAX package's SHC step keeps them replicated, and
    sums its share of the particles (``nope`` too).

    Where the ``step.search`` span records and the kernel runs (a CUDA
    device), it sets two attributes on the span: ``shc_groups``, the
    shift groups its blocks ran (a device sum, read when the span's
    ``attrs`` are read), and ``shc_groups_full``, the groups of a search
    that ran them all (of the route's plan); and ``interior_rings`` and
    ``rings_full`` as ``align_step`` does, over the shift groups run.
    """
    if cfg.ring_scheme != "cuda":
        raise ValueError("random_method='SHC' runs the standard ring "
                         "scheme only (ring_scheme='cuda')")
    route = _as_route(sampler, images, cfg, "SHC", refs.shape[0], mesh)
    n = images.shape[0]
    with span("step.search", images.device, sampler=route.search, N=n,
              K=refs.shape[0],
              **_search_size(images, cfg, route, refs.shape[0])) as sp:
        ref_fw = prepare_ref_spectra(refs, cfg)
        if route.search == "template":
            result, found = template_search_shc(images, ref_fw, params, cfg,
                                                previousmax, sf=sf)
        elif route.search == "matmul":
            result, found = rotational_shift_search_shc_mm(
                images, ref_fw, params, cfg, previousmax, fast=fast)
        elif route.search == "kernel":
            count = sp.recording and route.plan is not None
            groups = (torch.empty(n, dtype=torch.int32, device=images.device)
                      if count else None)
            interior = _interior_counter(sp, route, images, refs.shape[0])
            result, found = fused_search_shc(
                images, ref_fw, params, cfg, previousmax, out_groups=groups,
                out_interior=interior)
            if count:
                _count_interior(sp, interior, cfg, (
                    groups * route.plan.group).clamp_max(cfg.n_shifts))
                sp.set(shc_groups=groups.sum(), shc_groups_full=n * -(
                    -cfg.n_shifts // route.plan.group))
        else:
            result, found = rotational_shift_search_shc(
                images, ref_fw, params, cfg, previousmax)
    decoded = decode_params(result, params, cfg, update_ref=True)
    new_params = AlignParams(*[torch.where(found, new, old)
                               for new, old in zip(decoded, params)])
    new_prevmax = torch.where(found, result.best_val, previousmax)
    step = _finish_step(images, new_params, new_prevmax, global_index, valid,
                        n_classes, route.sums, fast, mesh)
    missed = ~found if valid is None else (~found) & (valid > 0)
    a, b = ref_slice(missed.shape[0], mesh)
    return ShcStepOutput(step, new_prevmax, missed[a:b].sum())


def align_step_scf(images, refs, params: AlignParams, global_index, valid,
                   cfg: AlignConfig, *, n_classes: int,
                   sampler: str | Route = "auto", fast: bool = True,
                   mesh=None) -> StepOutput:
    """One SCF (self-correlation) iteration, ``random_method="SCF"``:
    rotation from the shift-invariant scf ring spectra, translation from
    one cross-correlation map per 180-degree candidate
    (``ops/scf.py::scf_align``).  SCF aligns absolutely: ``params`` is not
    composed in.  The rotation stage is a standard K=1 search at zero
    shift, so on a CUDA tensor it launches the kernel;
    ``sampler="matmul"`` runs both stages and the class sums as the JAX
    package's matmul step (``fast`` as in ``align_step``);
    ``sampler="template"`` raises ``ValueError``, as in the JAX package
    (``sampler`` as in ``align_step``).
    SCF searches ``refs[0]`` alone, so under a ``ref`` split (``mesh``)
    every rank of a ref group aligns its block whole and sums its share.
    """
    if cfg.ring_scheme != "cuda":
        raise ValueError("random_method='SCF' runs the standard ring "
                         "scheme only (ring_scheme='cuda')")
    route = _as_route(sampler, images, cfg, "SCF", refs.shape[0], mesh)
    with span("step.search", images.device, sampler=route.search,
              N=images.shape[0], K=1,
              **_search_size(images, zero_shift_cfg(cfg), route, 1)):
        new_params, peak = scf_align(images, refs[0], cfg,
                                     sampler=route.search, fast=fast)
    return _finish_step(images, new_params, peak, global_index, valid,
                        n_classes, route.sums, fast, mesh)
