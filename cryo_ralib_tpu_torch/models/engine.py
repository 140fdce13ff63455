"""Alignment execution engine, resident mode (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/engine.py::AlignmentEngine`` for a
stack that fits in device memory: the stack and the AlignParams stay on
the device across iterations and each iteration runs one ``align_step``
(or ``align_step_shc`` / ``align_step_scf`` under a ``random_method``;
SHC keeps each particle's ``previousmax`` on the device too).
Streaming stacks larger than the device is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import AlignConfig
from ..params import AlignParams, params_from_numpy
from ..ops.search import PREVIOUSMAX_INIT, delta_angle_mask
from .steps import (align_step, align_step_scf, align_step_shc,
                    resolve_sampler)

# Device memory one particle needs per iteration beyond its own image,
# in image-sized f32 buffers: a bound on the bilinear transform's
# coordinate, int64 index and weight temporaries (the kernel's search
# needs none).  Measured peak at 16384 x 90 px on an H100: 15.4 GiB,
# ~31 stack sizes.
_TRANSFORM_BUFFERS = 32


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises
    rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} needs CUDA, which is not available here; "
            "pass device='cpu' to run on the CPU")
    return dev


@dataclass
class IterationResult:
    class_sums: np.ndarray   # (K, 2, H, W)
    counts: np.ndarray       # (K,)
    peak: np.ndarray         # (N,)
    sx_sum: float            # mirror-aware sum of header x-shifts
    sy_sum: float            # sum of header y-shifts
    nope: int = 0            # SHC only: particles with no improving candidate


class AlignmentEngine:
    """Per-iteration executor owning the device stack and params.

    ``data`` is an (N, H, W) float32 tensor; it is moved to ``device``
    once (a no-op when it is already there).  ``delta`` (``--dst``) is
    the discrete-angle step that ``iterate(discrete=True)`` searches;
    its angle mask is built once, on the device.  ``random_method`` is
    "" (the standard search), "SHC" or "SCF"; ``delta`` is defined for
    the standard search only."""

    def __init__(self, data, cfg: AlignConfig, n_classes: int,
                 device="cuda", sampler: str = "auto",
                 update_ref: bool = True, delta: float = 0.0,
                 random_method: str = ""):
        self.device = resolve_device(device)
        self.n = int(data.shape[0])
        self.cfg = cfg
        self.n_classes = n_classes
        self.sampler = sampler
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
        # fail at construction where the first iteration would
        resolve_sampler(sampler, self.device, cfg, random_method)
        if random_method and cfg.ring_scheme != "cuda":
            raise ValueError(f"random_method={random_method!r} runs the "
                             "standard ring scheme only (ring_scheme='cuda')")
        self._angle_mask = None
        if self.device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(self.device)
            need = data.numel() * 4 * (1 + _TRANSFORM_BUFFERS)
            if need > free:
                raise MemoryError(
                    f"stack of {self.n} particles needs ~{need / 2**30:.1f} "
                    f"GiB on {self.device}, {free / 2**30:.1f} GiB free; "
                    "streaming larger stacks is not ported yet")
        self._imgs = torch.as_tensor(data, dtype=torch.float32,
                                     device=self.device).contiguous()
        self._gidx = torch.arange(self.n, device=self.device)
        self.params = AlignParams.zeros(self.n, self.device)
        if random_method == "SHC":
            self._prevmax = torch.full((self.n,), PREVIOUSMAX_INIT,
                                       dtype=torch.float32,
                                       device=self.device)

    def previousmax_np(self) -> np.ndarray:
        """SHC: each particle's best ccf so far, as a host array."""
        if self.random_method != "SHC":
            raise ValueError("previousmax exists under random_method='SHC'")
        return self._prevmax.cpu().numpy()

    def set_previousmax(self, pm):
        """SHC: restore ``previousmax`` from host values (checkpoint
        resume)."""
        if self.random_method != "SHC":
            raise ValueError("previousmax exists under random_method='SHC'")
        self._prevmax = torch.as_tensor(np.asarray(pm, np.float32),
                                        device=self.device)

    def params_np(self) -> AlignParams:
        """Current per-particle params as host numpy arrays."""
        return AlignParams(*[f.cpu().numpy() for f in self.params])

    def set_params(self, params: AlignParams):
        """Restore per-particle params from host arrays (checkpoint
        resume)."""
        self.params = params_from_numpy(params._asdict(), self.device)

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

    def iterate(self, refs: np.ndarray,
                discrete: bool = False) -> IterationResult:
        """One alignment pass against (K, H, W) references.
        ``discrete=True`` restricts the rotation search to multiples of
        the engine's ``delta``."""
        mask = self._mask(discrete)
        refs_t = torch.as_tensor(np.asarray(refs, np.float32),
                                 device=self.device)
        nope = 0
        if self.random_method == "SHC":
            shc = align_step_shc(self._imgs, refs_t, self.params, self._gidx,
                                 None, self._prevmax, self.cfg,
                                 n_classes=self.n_classes,
                                 sampler=self.sampler)
            out, self._prevmax, nope = shc.step, shc.previousmax, int(shc.nope)
        elif self.random_method == "SCF":
            out = align_step_scf(self._imgs, refs_t, self.params, self._gidx,
                                 None, self.cfg, n_classes=self.n_classes,
                                 sampler=self.sampler)
        else:
            out = align_step(self._imgs, refs_t, self.params, self._gidx,
                             None, self.cfg, n_classes=self.n_classes,
                             update_ref=self.update_ref, sampler=self.sampler,
                             angle_mask=mask)
        self.params = out.params
        return IterationResult(
            class_sums=out.class_sums.cpu().numpy(),
            counts=out.counts.cpu().numpy().astype(np.int64),
            peak=out.peak.cpu().numpy(),
            sx_sum=float(out.sx_sum), sy_sum=float(out.sy_sum), nope=nope)
