"""Device-memory model of one alignment step and the batch planner.

Counterpart of ``cryo_ralib_tpu/parallel/batching.py`` (the reference's
``pre_align_size_check`` and its power-of-two batch search): the
footprint is a closed-form function of (batch, K, config, search) over
what the port allocates, and ``plan_batch_size`` picks the largest
power-of-two batch that fits the device's memory; a stack that fits
whole stays resident, a larger one streams through the same step in
batches (``models/engine.py``).

What one step allocates, per batch of B particles of H x W pixels:

* the images: B x H x W f32, twice when streaming (the batch being
  searched and the next one being uploaded);
* the search's outputs and the params: the kernel's (B, 256) winning
  rows and five scalars per particle, the params in and out, the peaks
  and the centering sums' temporaries (``PER_PARTICLE_BYTES``);
* the transform block of ``_finish_step``: ``transform_block`` particles
  at ``TRANSFORM_BYTES_PER_PIXEL`` each pixel, the same for any batch
  larger than the block;
* the class sums: the (K, 2, H, W) accumulator and one block's sums,
  and the engine's iteration accumulator when streaming;
* the references and the cached polar, shift and kernel tables;
* the search's transient, which is over before the transform starts: the
  kernel's decode (a few (B, 7) gathers); for the PyTorch search (SHC,
  the eman2 rings, "auto" outside the kernel's gate) its polar samples
  at ~100 B each (``ops/search.py::PLAIN_SAMPLE_BUDGET``); for SCF the
  scf images (one stack size) besides the rotation search.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.fused_search import RING_LEN
from ..ops.search import PLAIN_SAMPLE_BUDGET, plain_shift_chunk
from ..ops.transform import TRANSFORM_BYTES_PER_PIXEL, transform_block

F32 = 4
# kernel outputs (value, 256-angle row, four int32 indices), params in and
# out (5 fields each), the peak and the centering sums' temporaries
PER_PARTICLE_BYTES = (F32 * (1 + RING_LEN + 4) + 2 * 5 * F32 + F32
                      + 8 * F32)
# decode_params: the (B, 7) int64 columns and f32 values and ~10 vectors
DECODE_BYTES = 7 * 8 + 7 * F32 + 10 * F32
# a PyTorch search keeps coordinates, int64 indices and corner values of
# every polar sample of a pass alive (ops/search.py)
PLAIN_BYTES_PER_SAMPLE = 100


def device_memory_bytes(device=None) -> int | None:
    """Device memory a plan may use on ``device``: what CUDA reports free
    plus what PyTorch's caching allocator holds without using it (a
    freed block stays reserved, and "free" alone would understate the
    budget after a run).  None for a device that is not a CUDA device."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(free + cached)


@dataclass(frozen=True)
class StepFootprint:
    """Device bytes of one step on a batch, by what holds them."""

    images: int
    outputs: int
    transform: int
    class_sums: int
    tables: int
    search: int

    @property
    def total(self) -> int:
        # the search's transient is over before the transform block runs
        return (self.images + self.outputs + self.class_sums + self.tables
                + max(self.search, self.transform))


def step_footprint(batch: int, n_refs: int, cfg, sampler: str = "kernel",
                   random_method: str = "",
                   streamed: bool = False) -> StepFootprint:
    """The device memory of one ``align_step`` (``align_step_shc`` /
    ``align_step_scf`` under ``random_method``) on ``batch`` particles
    against ``n_refs`` references; ``sampler`` is the search that runs
    ("kernel" or "plain", ``resolve_sampler``); ``streamed`` charges the
    second image buffer and the engine's accumulator."""
    h = w = cfg.img_dim
    img = h * w * F32
    q = cfg.ring_num * cfg.ring_len
    bufs = 2 if streamed else 1
    images = bufs * batch * img
    outputs = batch * PER_PARTICLE_BYTES + (bufs - 1) * batch * 5 * F32
    block = min(transform_block(h, w), batch)
    transform = block * h * w * TRANSFORM_BYTES_PER_PIXEL
    class_sums = (2 + int(streamed)) * n_refs * 2 * img
    # refs, their polar samples and spectra, and the cached tables
    tables = (n_refs * (img + q * F32 + 2 * cfg.ring_num * 129 * 8)
              + q * 2 * F32 + cfg.n_shifts * 2 * F32 + RING_LEN * 2 * 8
              + cfg.ring_num * 8)
    if sampler == "plain" or random_method == "SHC":
        if cfg.ring_scheme == "eman2":
            samples = min(PLAIN_SAMPLE_BUDGET, batch * q)
        else:
            samples = plain_shift_chunk(batch, cfg) * batch * q
        search = PLAIN_BYTES_PER_SAMPLE * samples
    else:
        search = batch * DECODE_BYTES
    if random_method == "SCF":
        # the scf images; stage 2's maps are per transform block
        search += batch * img
        transform += block * img * 8
    return StepFootprint(images, outputs, transform, class_sums, tables,
                         search)


def plan_batch_size(n: int, n_refs: int, cfg, limit_bytes: int | None = None,
                    occupancy: float = 0.8, device=None,
                    sampler: str = "kernel", random_method: str = "",
                    log=None, ranks_on_device: int = 1) -> int:
    """The stack whole (``n``) where its resident footprint fits
    ``occupancy * limit``, else the largest power-of-two batch whose
    streamed footprint fits (at least 1).

    ``limit_bytes`` defaults to ``device_memory_bytes(device)`` divided
    by ``ranks_on_device``: under a mesh ``n`` is the rank's block, and
    the ranks that share a card plan at the same time, each seeing the
    whole card free.  On a device that is not a CUDA device, with no
    ``limit_bytes``, the stack is resident.  ``occupancy`` 0.8 leaves a
    fifth of the card (16 GB of an H100's 80) to what the model does not
    count: the caching allocator's rounding and split blocks, and the
    cuFFT plans' and cuBLAS's workspaces.  ``log`` (a callable, e.g.
    ``print``) gets the plan and its footprint.
    """
    if limit_bytes is None:
        limit_bytes = device_memory_bytes(device)
        if limit_bytes is None:
            return n
        limit_bytes //= max(1, int(ranks_on_device))
    budget = int(limit_bytes * occupancy)

    def fits(b, streamed):
        return step_footprint(b, n_refs, cfg, sampler, random_method,
                              streamed).total <= budget

    if fits(n, False):
        batch, streamed = n, False
    else:
        batch, streamed = 1, True
        while batch * 2 < n and fits(batch * 2, True):
            batch *= 2
    if log is not None:
        fp = step_footprint(batch, n_refs, cfg, sampler, random_method,
                            streamed)
        mode = (f"streamed in batches of {batch}" if streamed
                else "resident")
        log(f"batch plan: {n} particles {mode} (budget {budget / 2**30:.2f}"
            f" GiB, {occupancy:g} of {limit_bytes / 2**30:.2f} GiB; "
            f"footprint {fp.total / 2**30:.2f} GiB: "
            + ", ".join(f"{name} {getattr(fp, name) / 2**20:.1f} MiB"
                        for name in ("images", "outputs", "transform",
                                     "class_sums", "tables", "search"))
            + ")")
    return batch
