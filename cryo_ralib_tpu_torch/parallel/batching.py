"""Device-memory model of one alignment step and the batch planner.

Counterpart of ``cryo_ralib_tpu/parallel/batching.py`` (the reference's
``pre_align_size_check`` and its power-of-two batch search): the
footprint is a closed-form function of (batch, route, config) over what
the port allocates, the route (``models/steps.py::resolve_route``)
giving the search, the class sums, the references searched and the
``random_method``; and ``plan_batch_size`` picks the largest
power-of-two batch that fits the device's memory; a stack that fits
whole stays resident, a larger one streams through the same step in
batches (``models/engine.py``).

What one step allocates, per batch of B particles of H x W pixels:

* the images: B x H x W f32, twice when streaming (the batch being
  searched and the next one being uploaded);
* the search's outputs and the params: the kernel's (B, 256) winning
  rows and five scalars per particle, the params in and out, the peaks
  and the centering sums' temporaries (``PER_PARTICLE_BYTES``);
* the class sums' transform: for the route's "plain" sums
  ``transform_block`` particles at ``TRANSFORM_BYTES_PER_PIXEL`` each
  pixel, the same for any batch larger than the block, charged for its
  "kernel" sums too (the class-sum kernel takes about an eighth of a
  byte a pixel of the batch), so that every batch plan stays as it was;
  for its "shear" sums (``class_sum_transform_mm``) ``shear_block``
  particles at ``SHEAR_BYTES_PER_PIXEL`` each padded pixel and the
  (4K, P, F) spectral slot sums;
* the class sums: the (K, 2, H, W) accumulator and one block's sums,
  and the engine's iteration accumulator when streaming;
* the references and the cached polar, shift and kernel tables;
* the search's transient, which is over before the transform starts: the
  kernel's decode (a few (B, 7) gathers), the SHC pick's too; for the
  PyTorch search ("plain": the eman2 rings, the CPU, "auto" outside the
  kernel's gate) its polar samples at ~100 B each
  (``ops/search.py::PLAIN_SAMPLE_BUDGET``); for SCF the
  scf images (one stack size) besides the rotation search; for the
  template engine (``template_search_bytes``) its bf16 window, its
  template blocks and the largest of its window's translate, its
  template build and one column chunk's product and fold.  Its splat
  spectra stay on the device between steps and count with the tables;
  for the matmul sampler one dy group of a block of particles
  (``ops/search.py::mm_search_bytes``, blocks of ``mm_block``), the
  block's translate and the outputs of every block.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.eman_search import eman_groups
from ..ops.fused_search import RING_LEN
from ..ops.search import (PLAIN_SAMPLE_BUDGET, mm_block, mm_search_bytes,
                          plain_shift_chunk)
from ..ops.template_search import (WINDOW_BLOCK, _col_chunk, _padded,
                                   _splat_spectra_bytes,
                                   _template_blocks_bytes, template_geometry)
from ..ops.transform import (SHEAR_BYTES_PER_PIXEL,
                             TRANSFORM_BYTES_PER_PIXEL, shear_block,
                             shear_pad, transform_block)

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


def template_search_bytes(batch: int, n_refs: int, cfg) -> int:
    """Device bytes of one streamed ``template_search`` on ``batch``
    particles, the hoisted splat spectra aside: the (B, Wp) bf16 window
    and the padded template blocks, plus the largest of three phases
    that do not overlap:

    * the window's translate, on a block of ``WINDOW_BLOCK`` particles:
      two f32 tent stacks (width x H), the image rounded through bf16
      (6 B a pixel), the mid product and its rounding (width x W,
      10 B), the window in f32;
    * the template build: per channel and ref the complex angle spectra
      (F bins) and three f32 copies of the L angle templates (the
      inverse FFT, its flip and the transposed stack), each Wpx pixels;
    * a column chunk: its bf16 columns, the (B, chunk) f32 scores and
      the f32 columns where the route takes f32 operands, the f32
      window, and five (B, L) f32 rows of the fold.
    """
    _, width, _ = template_geometry(cfg)
    h = w = cfg.img_dim
    wpx = width * width
    wp = _padded(wpx)
    n_chan = 2 if cfg.mirror else 1
    ring_len = cfg.ring_len
    blk = min(batch, WINDOW_BLOCK)
    translate = blk * (2 * width * h * F32 + h * w * 6 + width * w * 10
                       + wpx * F32)
    build = n_chan * n_refs * wpx * ((ring_len // 2 + 1) * 8
                                     + 3 * ring_len * F32)
    chunk = _col_chunk(n_chan * cfg.n_shifts * n_refs * ring_len, ring_len)
    scan = (chunk * wp * (2 + F32) + batch * chunk * F32
            + 5 * batch * ring_len * F32)
    return (batch * wp * 2 + _template_blocks_bytes(cfg, n_refs)
            + max(translate, build, scan))


def matmul_search_bytes(batch: int, n_refs: int, cfg) -> int:
    """Device bytes of one ``rotational_shift_search_mm`` (or the eman2
    matmul search) on ``batch`` particles: one dy group of a block
    (``mm_search_bytes``), the block's translate (its two tent stacks,
    the mid product and the result, f32) and the (batch, L) rows and
    five scalars of every block's result, twice (the blocks and their
    concatenation)."""
    h = w = cfg.img_dim
    q = (sum(c.shape[0] * c.shape[1] for _l, _i, c in eman_groups(cfg))
         if cfg.ring_scheme == "eman2" else None)
    blk = mm_block(batch, n_refs, cfg, q)
    return (mm_search_bytes(blk, n_refs, cfg, q)
            + blk * (h * h + w * w + 2 * h * w) * F32
            + 2 * batch * (cfg.ring_len + 5) * F32)


def shear_sum_bytes(batch: int, n_refs: int, h: int) -> int:
    """Device bytes of ``class_sum_transform_mm`` on ``batch`` particles:
    one block's FFT-shear temporaries and the (4K, P, F) complex slot
    sums with their inverse DFT."""
    pad = shear_pad(h)
    blk = min(shear_block(h), batch)
    return (blk * SHEAR_BYTES_PER_PIXEL * pad * pad
            + 2 * 4 * n_refs * pad * (pad // 2 + 1) * 2 * F32)


def step_footprint(batch: int, route, cfg,
                   streamed: bool = False) -> StepFootprint:
    """The device memory of one step of ``route`` (``align_step``, or
    ``align_step_shc`` / ``align_step_scf`` under its ``method``) on
    ``batch`` particles against its ``refs`` references, with its
    ``search`` and ``sums``; ``streamed`` charges the second image
    buffer and the engine's accumulator."""
    n_refs = route.refs
    h = w = cfg.img_dim
    img = h * w * F32
    q = cfg.ring_num * cfg.ring_len
    bufs = 2 if streamed else 1
    images = bufs * batch * img
    outputs = batch * PER_PARTICLE_BYTES + (bufs - 1) * batch * 5 * F32
    block = min(transform_block(h, w), batch)
    if route.sums == "shear":
        transform = shear_sum_bytes(batch, n_refs, h)
    else:
        transform = block * h * w * TRANSFORM_BYTES_PER_PIXEL
    class_sums = (2 + int(streamed)) * n_refs * 2 * img
    # refs, their polar samples and spectra, and the cached tables
    tables = (n_refs * (img + q * F32 + 2 * cfg.ring_num * 129 * 8)
              + q * 2 * F32 + cfg.n_shifts * 2 * F32 + RING_LEN * 2 * 8
              + cfg.ring_num * 8)
    if route.search == "template":
        tables += _splat_spectra_bytes(cfg)
        search = template_search_bytes(batch, n_refs, cfg)
    elif route.search == "matmul":
        # the constant tents: (n_dy, Q, H) and (n_dx, Q, W)
        tables += ((len(cfg.shift_y_vals) + len(cfg.shift_x_vals)) * q * h
                   * F32)
        search = matmul_search_bytes(batch, n_refs, cfg)
    elif route.search == "plain":
        if cfg.ring_scheme == "eman2":
            samples = min(PLAIN_SAMPLE_BUDGET, batch * q)
        else:
            samples = plain_shift_chunk(batch, cfg) * batch * q
        search = PLAIN_BYTES_PER_SAMPLE * samples
    else:
        search = batch * DECODE_BYTES
    if route.method == "SCF":
        # the scf images; stage 2's maps are per transform block
        search += batch * img
        transform += block * img * 8
    return StepFootprint(images, outputs, transform, class_sums, tables,
                         search)


def plan_batch_size(n: int, route, cfg, limit_bytes: int | None = None,
                    occupancy: float = 0.8, device=None, log=None,
                    ranks_on_device: int = 1) -> int:
    """The stack whole (``n``) where the resident footprint of a step of
    ``route`` fits ``occupancy * limit``, else the largest power-of-two
    batch whose streamed footprint fits (at least 1).

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
        return step_footprint(b, route, cfg, streamed).total <= budget

    if fits(n, False):
        batch, streamed = n, False
    else:
        batch, streamed = 1, True
        while batch * 2 < n and fits(batch * 2, True):
            batch *= 2
    if log is not None:
        fp = step_footprint(batch, route, cfg, streamed)
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
