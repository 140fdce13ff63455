"""Alignment execution engine, resident mode (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/engine.py::AlignmentEngine`` for a
stack that fits in device memory: the stack and the AlignParams stay on
the device across iterations and each iteration runs one ``align_step``.
Streaming stacks larger than the device is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import AlignConfig
from ..params import AlignParams
from .steps import align_step

# Device memory one particle needs per iteration beyond its own image,
# in image-sized f32 buffers: a bound on the bilinear transform's
# coordinate, int64 index and weight temporaries (the kernel's search
# needs none).  Measured peak at 16384 x 90 px on an H100: 15.4 GiB,
# ~31 stack sizes.
_TRANSFORM_BUFFERS = 32


@dataclass
class IterationResult:
    class_sums: np.ndarray   # (K, 2, H, W)
    counts: np.ndarray       # (K,)
    peak: np.ndarray         # (N,)


class AlignmentEngine:
    """Per-iteration executor owning the device stack and params.

    ``data`` is an (N, H, W) float32 tensor; it is moved to ``device``
    once (a no-op when it is already there)."""

    def __init__(self, data, cfg: AlignConfig, n_classes: int,
                 device="cpu", sampler: str = "auto"):
        self.device = torch.device(device)
        self.n = int(data.shape[0])
        self.cfg = cfg
        self.n_classes = n_classes
        self.sampler = sampler
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

    def params_np(self) -> AlignParams:
        """Current per-particle params as host numpy arrays."""
        return AlignParams(*[f.cpu().numpy() for f in self.params])

    def iterate(self, refs: np.ndarray) -> IterationResult:
        """One alignment pass against (K, H, W) references."""
        refs_t = torch.as_tensor(np.asarray(refs, np.float32),
                                 device=self.device)
        out = align_step(self._imgs, refs_t, self.params, self._gidx, None,
                         self.cfg, n_classes=self.n_classes,
                         sampler=self.sampler)
        self.params = out.params
        return IterationResult(
            class_sums=out.class_sums.cpu().numpy(),
            counts=out.counts.cpu().numpy().astype(np.int64),
            peak=out.peak.cpu().numpy())
