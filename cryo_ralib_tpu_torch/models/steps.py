"""One alignment iteration (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/steps.py``: ``align_step`` (search
every particle against every reference, decode the winners, transform
and sum the classes even/odd; an ``angle_mask`` (``--dst``) restricts
the angle argmax and turns off the parabolic refinement),
``align_step_shc`` (stochastic hill climbing) and ``align_step_scf``
(self-correlation alignment), and ``raw_sum_step`` (the even/odd sums
of the raw stack).

Which search runs (``resolve_sampler``): the hand-written CUDA kernel
takes the standard search and the SHC pick (``fused_search_shc``, the
kernel's ``PICK_SHC`` variant, for which the JAX package has no Pallas
kernel; one reference) on uniform 256-sample rings, full or half (mode
"F" or "H").  The eman2 ring scheme has no kernel and runs the PyTorch
search on either device under "auto", and so do SHC with more than one
reference, the per-particle-reference search
(``per_particle_ref``) and a geometry outside the kernel's gate
(``ops/fused_search.py::kernel_gate``: other ring lengths, a block
larger than the device's shared memory, the int32 priority bound), as
the JAX package's "auto" leaves the Pallas kernel there.  Asking for the
kernel there raises ``ValueError``; the rule is decided from the
geometry before any launch, and nothing falls back from a kernel that
fails to build or launch to the plain search.
``sampler="template"`` runs the template engine
(``ops/template_search.py``: the search as bf16 matrix products) for the
standard and the eman2 rings and for SHC, where ``template_supported``
admits the geometry, and raises ``ValueError`` elsewhere (SCF has no
template variant, as in JAX); ``sampler="matmul"`` runs the matmul
sampler (the polar samples as tent products, ``ops/polar_mm.py``) in
every mode.  "auto" never picks either.

The end of every step (``_finish_step``) transforms and class-sums the
particles.  Under "template" and "matmul" it is the JAX package's
``class_sum_transform_mm`` (the FFT shear, bf16 DFTs with ``fast``, the
sums taken on the spectra, in blocks of ``shear_block`` particles), as
the JAX steps sum for those samplers.  Under "kernel" and "plain" it is
the bilinear ``transform_batch`` + ``class_sum_oe``, the JAX package's
``gather`` step, which is the port's semantic target, through
``ops/classavg.py::fused_class_sums``: on a CUDA tensor one launch of
the class-sum kernel (``csrc/class_sums.cu``, the same samples and the
f64 sums in a fixed order, the transformed images never written), on
the CPU its plain version, by blocks of ``transform_block`` particles;
the JAX ``fused`` step, which "kernel" stands for, sums by the FFT shear
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
from typing import NamedTuple

import torch

from ..config import AlignConfig
from ..params import AlignParams, gpu_params_to_align2d
from ..ops.classavg import (class_sum_oe, class_sum_transform_mm,
                            fused_class_sums)
from ..ops.eman_search import (prepare_ref_spectra_eman,
                               rotational_shift_search_eman)
from ..ops.fused_search import (fused_search, fused_search_shc, kernel_gate,
                                kernel_plan, search_plain)
from ..ops.scf import scf_align, zero_shift_cfg
from ..ops.search import (decode_params, empty_result, merge_ref_slices,
                          prepare_ref_spectra,
                          rotational_shift_search_mm,
                          rotational_shift_search_shc,
                          rotational_shift_search_shc_mm)
from ..ops.template_search import (template_search, template_search_shc,
                                   template_supported)
from ..parallel.mesh import ref_reduce, ref_slice
from ..utils.profiling import span

_log = logging.getLogger(__name__)

# the samplers whose steps sum their classes by the FFT shear
SHEAR_SUMS = ("template", "matmul")


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


def searched_refs(n_refs: int, mesh, random_method: str = "") -> int:
    """The references that a rank searches of ``n_refs``: its slice under
    a ``ref`` split for the standard search, all of them for SHC and SCF,
    which keep them whole on every rank (as the JAX package's SHC step
    keeps them replicated)."""
    if mesh is None or random_method:
        return n_refs
    return max(1, n_refs // mesh.ref)


def resolve_sampler(sampler: str, device, cfg: AlignConfig | None = None,
                    random_method: str = "", n_refs: int = 1,
                    smem_limit: int | None = None,
                    per_particle_ref: bool = False) -> str:
    """The search a step runs: "kernel" (the CUDA kernel), "plain" (the
    PyTorch search), "template" (the template engine) or "matmul" (the
    matmul sampler).

    "auto" is the kernel for CUDA tensors and plain for CPU tensors, the
    standard search and the SHC pick (``random_method="SHC"``) alike,
    except where there is no kernel: the eman2 ring scheme
    (``cfg.ring_scheme == "eman2"``), SHC with ``n_refs`` other than one
    (the kernel's SHC pick is built for the reference-free driver's one
    reference), the per-particle-reference search
    (``per_particle_ref``) and, on a CUDA device, a geometry
    outside ``kernel_gate`` (``n_refs`` references of ``cfg``'s box;
    ``smem_limit`` defaults to the device's) run plain, which is logged.
    "kernel" asked for there raises ``ValueError`` naming the rule.
    "template" is taken only as asked, on either device, and raises
    ``ValueError`` under SCF, for ``per_particle_ref`` and outside
    ``template_supported`` (``n_refs`` references), as the JAX package's
    steps raise.  "matmul" is taken only as asked, in every mode and on
    either device (the JAX package's matmul sampler has no gate).
    """
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
        if cfg is not None and not template_supported(cfg, n_refs):
            raise ValueError(
                "sampler='template' on a configuration outside the template "
                "engine's geometry gate (ops.template_search."
                "template_supported) — use sampler='auto'")
        return "template"
    no_kernel = None
    if per_particle_ref:
        no_kernel = ("per_particle_ref (the kernel searches every "
                     "reference)")
    elif cfg is not None and cfg.ring_scheme == "eman2":
        no_kernel = ("ring_scheme='eman2' (the kernel takes uniform "
                     "256-sample rings)")
    elif random_method == "SHC" and n_refs != 1:
        no_kernel = (f"random_method='SHC' with {n_refs} references (the "
                     "kernel's SHC pick is built for one)")
    elif (cfg is not None and sampler != "plain"
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


def _search_size(images, cfg: AlignConfig, sampler: str, k: int) -> dict:
    """The ``step.search`` span's size counters: the box, the rings, the
    shifts and mirror channels searched, and ``ref_groups``, the groups
    of 8 references (one of one at K=1) that each of the kernel's blocks
    loops over, 0 where another search runs."""
    kernel = sampler == "kernel" and images.is_cuda
    return dict(box=images.shape[-1], rings=cfg.ring_num,
                shifts=cfg.n_shifts, mirrors=2 if cfg.mirror else 1,
                ref_groups=-(-k // 8) if kernel else 0)


def align_step(images, refs, params: AlignParams, global_index, valid,
               cfg: AlignConfig, *, n_classes: int, update_ref: bool = True,
               sampler: str = "auto", fast: bool = True, angle_mask=None,
               sf=None, mesh=None) -> StepOutput:
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
        the CPU.
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
    """
    part = _ref_part(refs, mesh)
    sampler = resolve_sampler(sampler, images.device, cfg,
                              n_refs=max(1, part.refs.shape[0]))
    k = part.refs.shape[0]
    with span("step.search", images.device, sampler=sampler,
              N=images.shape[0], K=k,
              **_search_size(images, cfg, sampler, k)):
        result = _search(images, part.refs, params, cfg, sampler, fast,
                         angle_mask, sf)
    if part.reduce is not None:
        result = merge_ref_slices(result, part.k0, cfg.n_shifts,
                                  part.n_refs, part.reduce)
    new_params = decode_params(result, params, cfg, update_ref=update_ref,
                               refine=angle_mask is None)
    return _finish_step(images, new_params, result.best_val, global_index,
                        valid, n_classes, sampler in SHEAR_SUMS, fast, mesh)


def _search(images, refs, params: AlignParams, cfg: AlignConfig,
            sampler: str, fast: bool, angle_mask, sf):
    """The resolved ``sampler``'s search of every particle against
    ``refs``; an empty slice of the references (fewer references than
    ``ref`` ranks) searches nothing and loses every merge."""
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
    search = fused_search if sampler == "kernel" else search_plain
    return search(images, ref_fw, params, cfg, angle_mask=angle_mask)


def _finish_step(images, new_params: AlignParams, peak, global_index, valid,
                 n_classes: int, shear: bool = False,
                 fast: bool = True, mesh=None) -> StepOutput:
    """Transform by the new params, sum the classes even/odd, and the
    centering sums: the end of every kind of step.  ``shear`` sums by the
    FFT shear (``class_sum_transform_mm``, bf16 DFTs with ``fast``, in
    blocks of particles whose sums add up on the device), else by the
    bilinear transform (``fused_class_sums``: one launch of the class-sum
    kernel on a CUDA tensor, its plain version on the CPU).  The
    ``step.sums`` span says which ran: ``sums="kernel"`` or ``"plain"``.
    Under a ``ref`` split (``mesh``) only the rank's share of the
    particles (``ref_slice``) is transformed and summed; the params and
    peaks stay whole."""
    route = "kernel" if images.is_cuda and not shear else "plain"
    with span("step.sums", images.device, shear=shear, sums=route):
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
            sums, counts = class_sum_transform_mm(
                images, summed, n_classes, global_index=global_index,
                valid=valid, fast=fast)
        else:
            sums, counts = fused_class_sums(
                images, summed, n_classes, global_index=global_index,
                valid=valid)
        return _step_output(new_params, summed, sums, counts, peak, valid)


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
                   sampler: str = "auto", fast: bool = True,
                   sf=None, mesh=None) -> ShcStepOutput:
    """One SHC (stochastic hill climbing) iteration,
    ``random_method="SHC"``: each particle takes the first candidate
    above its ``previousmax`` rather than the global argmax; a particle
    with none keeps its params and its ``previousmax`` and counts in
    ``nope``.  The search is ``fused_search_shc`` under "kernel" (the
    kernel's SHC pick on a CUDA tensor, the plain one on the CPU),
    ``rotational_shift_search_shc`` under "plain" (``resolve_sampler``),
    ``template_search_shc`` with ``sampler="template"`` (``sf`` as in
    ``align_step``), or ``rotational_shift_search_shc_mm`` with
    ``sampler="matmul"`` (``fast`` as in ``align_step``), each called by
    its name in this module, where a caller may wrap it.  ``mesh`` as in
    ``align_step``, but every rank of a ref group searches all the
    references, as the JAX package's SHC step keeps them replicated, and
    sums its share of the particles (``nope`` too).

    Where the ``step.search`` span records and the kernel runs (a CUDA
    tensor), it sets two attributes on the span: ``shc_groups``, the
    shift groups its blocks ran (a device sum, read when the span's
    ``attrs`` are read), and ``shc_groups_full``, the groups of a search
    that ran them all.
    """
    if cfg.ring_scheme != "cuda":
        raise ValueError("random_method='SHC' runs the standard ring "
                         "scheme only (ring_scheme='cuda')")
    sampler = resolve_sampler(sampler, images.device, cfg,
                              random_method="SHC", n_refs=refs.shape[0])
    n = images.shape[0]
    with span("step.search", images.device, sampler=sampler, N=n,
              K=refs.shape[0],
              **_search_size(images, cfg, sampler, refs.shape[0])) as sp:
        ref_fw = prepare_ref_spectra(refs, cfg)
        if sampler == "template":
            result, found = template_search_shc(images, ref_fw, params, cfg,
                                                previousmax, sf=sf)
        elif sampler == "matmul":
            result, found = rotational_shift_search_shc_mm(
                images, ref_fw, params, cfg, previousmax, fast=fast)
        elif sampler == "kernel":
            count = sp.recording and images.is_cuda
            groups = (torch.empty(n, dtype=torch.int32, device=images.device)
                      if count else None)
            result, found = fused_search_shc(images, ref_fw, params, cfg,
                                             previousmax, out_groups=groups)
            if count:
                with torch.cuda.device(images.device):
                    group = kernel_plan(cfg.ring_num, cfg.mirror,
                                        refs.shape[0], cfg.n_shifts,
                                        *images.shape[1:])["group"]
                sp.set(shc_groups=groups.sum(),
                       shc_groups_full=n * -(-cfg.n_shifts // group))
        else:
            result, found = rotational_shift_search_shc(
                images, ref_fw, params, cfg, previousmax)
    decoded = decode_params(result, params, cfg, update_ref=True)
    new_params = AlignParams(*[torch.where(found, new, old)
                               for new, old in zip(decoded, params)])
    new_prevmax = torch.where(found, result.best_val, previousmax)
    step = _finish_step(images, new_params, new_prevmax, global_index, valid,
                        n_classes, sampler in SHEAR_SUMS, fast, mesh)
    missed = ~found if valid is None else (~found) & (valid > 0)
    a, b = ref_slice(missed.shape[0], mesh)
    return ShcStepOutput(step, new_prevmax, missed[a:b].sum())


def align_step_scf(images, refs, params: AlignParams, global_index, valid,
                   cfg: AlignConfig, *, n_classes: int,
                   sampler: str = "auto", fast: bool = True,
                   mesh=None) -> StepOutput:
    """One SCF (self-correlation) iteration, ``random_method="SCF"``:
    rotation from the shift-invariant scf ring spectra, translation from
    one cross-correlation map per 180-degree candidate
    (``ops/scf.py::scf_align``).  SCF aligns absolutely: ``params`` is not
    composed in.  The rotation stage is a standard K=1 search at zero
    shift, so on a CUDA tensor it launches the kernel;
    ``sampler="matmul"`` runs both stages and the class sums as the JAX
    package's matmul step (``fast`` as in ``align_step``);
    ``sampler="template"`` raises ``ValueError``, as in the JAX package.
    SCF searches ``refs[0]`` alone, so under a ``ref`` split (``mesh``)
    every rank of a ref group aligns its block whole and sums its share.
    """
    if cfg.ring_scheme != "cuda":
        raise ValueError("random_method='SCF' runs the standard ring "
                         "scheme only (ring_scheme='cuda')")
    rot_cfg = zero_shift_cfg(cfg)
    sampler = resolve_sampler(sampler, images.device, rot_cfg,
                              random_method="SCF")
    with span("step.search", images.device, sampler=sampler,
              N=images.shape[0], K=1,
              **_search_size(images, rot_cfg, sampler, 1)):
        new_params, peak = scf_align(images, refs[0], cfg, sampler=sampler,
                                     fast=fast)
    return _finish_step(images, new_params, peak, global_index, valid,
                        n_classes, sampler in SHEAR_SUMS, fast, mesh)
