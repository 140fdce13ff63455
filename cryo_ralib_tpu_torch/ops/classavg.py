"""Even/odd class-average accumulation (PyTorch and a CUDA kernel).

Counterpart of ``cryo_ralib_tpu/ops/classavg.py``: per-class sums split by
the parity of each particle's global stack index, plus member counts.
The sums are taken and returned in f64: a sum of f32 images in f64 is
exact but for rounding at 1e-16, so one process, the blocks of a stack,
the batches of a streamed one and the ranks of a mesh (whose all-reduce
adds the f64 sums) give the same sums once rounded to f32, where f32
sums in another order differ in their last bits, and the template
engine's bf16 references turn such bits into angles
(``tests/test_torch_distributed.py``).

Which route runs where:

* ``fused_class_sums`` transforms by the bilinear ``transform_batch`` and
  sums in one, the end of the plain and kernel steps
  (``models/steps.py::_finish_step``).  On a CUDA tensor it launches the
  hand-written kernel ``csrc/class_sums.cu`` (see the note at the top of
  that file), which never writes the transformed images, or raises; on a
  CPU tensor it runs ``class_sums_plain``, its plain PyTorch version:
  ``class_sum_oe(transform_batch(...))`` by blocks of ``transform_block``
  particles.  Nothing falls back from one to the other.
* ``class_sum_oe`` sums images as they are, as a one-hot product over the
  particle axis (deterministic on the GPU, unlike atomics): the plain
  route's sums, and ``models/steps.py::raw_sum_step``'s sums of the raw
  stack.
* ``class_sum_transform_mm`` transforms by the FFT shear and sums in one,
  as the JAX package's ``matmul``, ``fused`` and ``template`` steps do
  (here the ``matmul`` and ``template`` steps), on either device.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import torch

from ..kernels import load_library
from ..params import AlignParams
from .transform import (_flip_edge, _irfft, _warp_spectrum, shear_block,
                        shear_pad, transform_batch, transform_block)

# Particles a block of the kernel sums: one chunk of a slot's run
SUM_CHUNK = 64


def class_sum_oe(images, ref_id, n_classes: int, global_index=None,
                 valid=None):
    """Per-class even/odd image sums and member counts.

    Args:
      images: (N, H, W) transformed (aligned) particles.
      ref_id: (N,) int class assignment.
      n_classes: K.
      global_index: (N,) int global particle indices for the parity;
        defaults to arange(N).
      valid: optional (N,) 0/1 mask excluding padding particles.

    Returns:
      sums:   (K, 2, H, W) float64 — [:, 0] even-parity sum, [:, 1] odd.
      counts: (K,) int32 member counts.
    """
    n, h, w = images.shape
    dev = images.device
    if global_index is None:
        global_index = torch.arange(n, device=dev)
    slot = ref_id.long() * 2 + global_index.long() % 2       # (N,) in [0, 2K)
    onehot = (slot[:, None] == torch.arange(2 * n_classes, device=dev)
              ).to(torch.float64)
    class_onehot = (ref_id.long()[:, None]
                    == torch.arange(n_classes, device=dev)).int()
    if valid is not None:
        onehot = onehot * valid.to(torch.float64)[:, None]
        class_onehot = class_onehot * valid.int()[:, None]
    sums = onehot.T @ images.reshape(n, h * w).to(torch.float64)
    counts = class_onehot.sum(dim=0, dtype=torch.int32)
    return sums.reshape(n_classes, 2, h, w), counts


def class_sum_transform_mm(images, params: AlignParams, n_classes: int,
                           global_index=None, valid=None, fast: bool = True):
    """The FFT-shear transform and the even/odd class sums in one:
    ``class_sum_oe(transform_batch_mm(images, params, fast=fast), ...)``
    up to f32 rounding.

    The warp's last inverse DFT, its crop and the mirror flip are one
    linear map for every particle, so the one-hot sum runs on the pass-4
    spectra (``_warp_spectrum``) over 4K (class, parity, mirror) slots,
    and the inverse DFT and the flip apply once to the (4K, P, F) sums.
    The particles go by blocks of ``shear_block`` (their spectra are 66.6
    KB each at 90 px, P = 128); the slot sums and the inverse DFT are
    f64, as ``class_sum_oe``'s sums (JAX: f32).  Arguments and returns
    as ``class_sum_oe``.
    """
    n, h, w = images.shape
    dev = images.device
    if global_index is None:
        global_index = torch.arange(n, device=dev)
    pad_to = shear_pad(h)
    off = pad_to // 2 - w // 2
    n_f = pad_to // 2 + 1
    slots = torch.arange(4 * n_classes, device=dev)
    classes = torch.arange(n_classes, device=dev)
    acc = torch.zeros((4 * n_classes, pad_to * n_f * 2), dtype=torch.float64,
                      device=dev)
    counts = torch.zeros(n_classes, dtype=torch.int32, device=dev)
    block = shear_block(h)
    for start in range(0, n, block):
        sl = slice(start, start + block)
        part = AlignParams(*[f[sl] for f in params])
        ref_id = part.ref_id.long()
        slot = ((ref_id * 2 + global_index[sl].long() % 2) * 2
                + part.mirror.long())
        onehot = (slot[:, None] == slots).to(torch.float64)
        class_onehot = (ref_id[:, None] == classes).int()
        if valid is not None:
            onehot = onehot * valid[sl].to(torch.float64)[:, None]
            class_onehot = class_onehot * valid[sl].int()[:, None]
        g, _, _ = _warp_spectrum(images[sl], part, pad_to, fast)
        acc += onehot.T @ torch.view_as_real(g).reshape(
            g.shape[0], -1).to(torch.float64)
        counts += class_onehot.sum(dim=0, dtype=torch.int32)
    spec = torch.view_as_complex(acc.view(4 * n_classes, pad_to, n_f, 2))
    cs = _irfft(spec, pad_to, False)[:, off:off + h, off:off + w]
    cs = cs.reshape(n_classes, 2, 2, h, w)
    return cs[:, :, 0] + _flip_edge(cs[:, :, 1], -1), counts


def class_sums_plain(images, params: AlignParams, n_classes: int,
                     global_index=None, valid=None):
    """``fused_class_sums``' plain PyTorch version (any device):
    ``class_sum_oe(transform_batch(...))`` by blocks of ``transform_block``
    particles, whose f64 sums add up, so that the peak does not grow with
    the stack.  Arguments and returns as ``fused_class_sums``."""
    n, h, w = images.shape
    if global_index is None:
        global_index = torch.arange(n, device=images.device)
    block = transform_block(h, w)
    sums = counts = None
    for start in range(0, max(n, 1), block):
        sl = slice(start, start + block)
        part = AlignParams(*[f[sl] for f in params])
        s_b, c_b = class_sum_oe(transform_batch(images[sl], part),
                                part.ref_id, n_classes,
                                global_index=global_index[sl],
                                valid=None if valid is None else valid[sl])
        if sums is None:
            sums, counts = s_b, c_b
        else:
            sums += s_b
            counts += c_b
    return sums, counts


class SumPlan(NamedTuple):
    """The kernel's plan of one call (``sum_plan``), on the device of the
    particles; ``n_blocks`` comes from shapes alone."""

    order: torch.Tensor        # (N,) int32 particles sorted by slot
    slot_start: torch.Tensor   # (2K + 1,) int32 each slot's first position
    chunk_start: torch.Tensor  # (2K + 1,) int32 each slot's first chunk
    counts: torch.Tensor       # (K,) int32 members of each class
    n_blocks: int              # ceil(N / chunk) + 2K, the chunks' bound


def sum_plan(ref_id, global_index, valid, n_classes: int,
             chunk: int = SUM_CHUNK) -> SumPlan:
    """Sort the particles by slot ``ref_id * 2 + global_index % 2``, with
    the particles that ``class_sum_oe`` leaves out (``valid`` 0, a
    ``ref_id`` outside [0, K)) after every slot, and cut each slot's run
    into chunks of ``chunk`` particles, chunk ``c`` of slot ``s`` being
    the plan's chunk ``chunk_start[s] + c``.  A stable sort keeps the
    stack's order inside a slot.  Every op stays on the device and no
    size depends on the data, so the host waits for nothing: a slot of
    ``m`` particles takes ceil(m / chunk) <= m / chunk + 1 chunks, so the
    plan holds at most ceil(N / chunk) + 2K of them, ``n_blocks``."""
    dev = ref_id.device
    n_slots = 2 * n_classes
    ref = ref_id.long()
    keep = (ref >= 0) & (ref < n_classes)
    if valid is not None:
        keep &= valid != 0
    key = torch.where(keep, ref * 2 + global_index.long() % 2, n_slots)
    sorted_key, order = torch.sort(key, stable=True)
    slot_start = torch.searchsorted(
        sorted_key, torch.arange(n_slots + 1, device=dev))
    lens = slot_start.diff()
    chunk_start = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    chunk_start[1:] = torch.cumsum((lens + chunk - 1) // chunk, 0)
    counts = lens.view(n_classes, 2).sum(1, dtype=torch.int32)
    return SumPlan(order.to(torch.int32), slot_start.to(torch.int32),
                   chunk_start, counts,
                   -(-ref_id.shape[0] // chunk) + n_slots)


@lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (or load the cached build of) the class-sum kernel."""
    lib = load_library("class_sums", ["class_sums.cu"])
    ptr = ctypes.c_void_p
    lib.cryo_class_sums_launch.argtypes = (
        [ptr] * 9 + [ctypes.c_int] * 5 + [ptr] * 3)
    lib.cryo_class_sums_launch.restype = ctypes.c_int
    lib.cryo_class_sums_smem.argtypes = [ctypes.c_int] * 2
    lib.cryo_class_sums_smem.restype = ctypes.c_longlong
    lib.cryo_class_sums_error_string.argtypes = [ctypes.c_int]
    lib.cryo_class_sums_error_string.restype = ctypes.c_char_p
    return lib


def fused_class_sums(images, params: AlignParams, n_classes: int,
                     global_index=None, valid=None):
    """Transform every particle by its params (``transform_batch``) and
    sum the classes even/odd (``class_sum_oe``) in one.

    On a CUDA tensor one launch of ``csrc/class_sums.cu`` after its plan
    (``sum_plan``): the samples are ``transform_batch``'s bit for bit, the
    sums ``class_sum_oe``'s to f64 rounding, in an order fixed by the
    inputs, so that two calls give the same bits; a launch adds one to
    ``fused_class_sums.launches`` (an empty stack launches nothing and
    counts nothing).  On a CPU tensor ``class_sums_plain``.

    Args:
      images: (N, H, W) float32 particles, contiguous.
      params: AlignParams with (N,) fields: the transform, and ``ref_id``
        the class of each particle.
      n_classes: K (at least 1).
      global_index: (N,) int global particle indices for the parity;
        defaults to arange(N).
      valid: optional (N,) 0/1 mask excluding padding particles.
    Returns:
      sums:   (K, 2, H, W) float64 — [:, 0] even-parity sum, [:, 1] odd.
      counts: (K,) int32 member counts.
    """
    dev = images.device
    if dev.type == "cpu":
        return class_sums_plain(images, params, n_classes, global_index,
                                valid)
    if dev.type != "cuda":
        raise ValueError(f"no class-sum kernel for device {dev}")
    n, h, w = images.shape
    if n_classes < 1:
        raise ValueError(f"n_classes must be at least 1, not {n_classes}")
    if images.dtype != torch.float32 or not images.is_contiguous():
        raise TypeError("images must be a contiguous float32 tensor")
    if n >= 2 ** 31 or max(h, w) >= 2 ** 16:
        raise ValueError(f"a stack of {n} x {h} x {w} is over the kernel's "
                         "index range")
    for name, field in zip(params._fields, params):
        if field.device != dev or tuple(field.shape) != (n,):
            raise ValueError(f"params.{name} must have shape ({n},) on {dev}")
    if n == 0:
        return (torch.zeros((n_classes, 2, h, w), dtype=torch.float64,
                            device=dev),
                torch.zeros(n_classes, dtype=torch.int32, device=dev))
    if global_index is None:
        global_index = torch.arange(n, device=dev)
    plan = sum_plan(params.ref_id, global_index, valid, n_classes)
    # c and s by transform_batch's own ops, so that the samples are its
    ang = params.angle * (math.pi / 180.0)
    c, s = torch.cos(ang), torch.sin(ang)
    f32 = [t.to(torch.float32).contiguous()
           for t in (c, s, params.shift_x, params.shift_y)]
    mirror = params.mirror.to(torch.int32).contiguous()
    partial = torch.empty((plan.n_blocks, h * w), dtype=torch.float64,
                          device=dev)
    sums = torch.empty((n_classes, 2, h, w), dtype=torch.float64, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cryo_class_sums_launch(
            images.data_ptr(), plan.order.data_ptr(),
            *[t.data_ptr() for t in f32], mirror.data_ptr(),
            plan.slot_start.data_ptr(), plan.chunk_start.data_ptr(),
            2 * n_classes, SUM_CHUNK, plan.n_blocks, h, w,
            partial.data_ptr(), sums.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("class-sum kernel launch failed: "
                           + lib.cryo_class_sums_error_string(rc).decode())
    fused_class_sums.launches += 1
    return sums, plan.counts


fused_class_sums.launches = 0
