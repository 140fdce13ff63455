"""One alignment iteration (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/steps.py::align_step`` on the
standard path: search every particle against every reference (kernel or
plain), decode the winners, transform and sum the classes even/odd.  An
``angle_mask`` (``--dst``) restricts the angle argmax and turns off the
parabolic refinement.  SHC, SCF, the eman2 ring scheme and mode H are
not ported yet and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import AlignConfig
from ..params import AlignParams, gpu_params_to_align2d
from ..ops.classavg import class_sum_oe
from ..ops.fused_search import fused_search, search_plain
from ..ops.search import decode_params, prepare_ref_spectra
from ..ops.transform import transform_batch


class StepOutput(NamedTuple):
    params: AlignParams
    class_sums: torch.Tensor   # (K, 2, H, W)
    counts: torch.Tensor       # (K,) int32
    peak: torch.Tensor         # (N,) best ccf value (diagnostic)
    sx_sum: torch.Tensor       # () mirror-aware sum of header x-shifts
    sy_sum: torch.Tensor       # () sum of header y-shifts


def _header_shift_sums(params: AlignParams, valid):
    """Decoded header shifts summed, x with the mirror-aware sign."""
    sx, sy = gpu_params_to_align2d(params.angle, params.shift_x,
                                   params.shift_y)
    sgn = torch.where(params.mirror == 1, -1.0, 1.0)
    if valid is not None:
        sgn = sgn * valid
        sy = sy * valid
    return (sx * sgn).sum(), sy.sum()


def resolve_sampler(sampler: str, device) -> str:
    """"auto" -> "kernel" for CUDA tensors, "plain" for CPU tensors."""
    if sampler == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "plain"
    if sampler not in ("kernel", "plain"):
        raise ValueError(f"sampler must be 'auto', 'kernel' or 'plain', "
                         f"not {sampler!r}")
    return sampler


def align_step(images, refs, params: AlignParams, global_index, valid,
               cfg: AlignConfig, *, n_classes: int, update_ref: bool = True,
               sampler: str = "auto", angle_mask=None) -> StepOutput:
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
        "plain" = its PyTorch version, "auto" = kernel on CUDA, plain on
        the CPU.
      angle_mask: optional (L,) float32 additive angle mask on the
        device of ``images`` (``delta_angle_mask``).
    """
    if cfg.ring_scheme != "cuda":
        raise NotImplementedError("ring_scheme='eman2' is not ported yet")
    if cfg.mode != "F":
        raise NotImplementedError("mode 'H' (half rings) is not ported yet")
    sampler = resolve_sampler(sampler, images.device)
    ref_fw = prepare_ref_spectra(refs, cfg)
    if sampler == "kernel":
        result = fused_search(images, ref_fw, params, cfg,
                              angle_mask=angle_mask)
    else:
        result = search_plain(images, ref_fw, params, cfg,
                              angle_mask=angle_mask)
    new_params = decode_params(result, params, cfg, update_ref=update_ref,
                               refine=angle_mask is None)
    transformed = transform_batch(images, new_params)
    sums, counts = class_sum_oe(transformed, new_params.ref_id, n_classes,
                                global_index=global_index, valid=valid)
    sx_sum, sy_sum = _header_shift_sums(new_params, valid)
    peak = (torch.where(valid > 0, result.best_val, 0.0)
            if valid is not None else result.best_val)
    return StepOutput(new_params, sums, counts, peak, sx_sum, sy_sum)
