"""Even/odd class-average accumulation (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/classavg.py``: per-class sums split by
the parity of each particle's global stack index, as a one-hot product
over the particle axis (deterministic on the GPU, unlike atomics), plus
member counts.  The sums are taken and returned in f64: a sum of f32
images in f64 is exact but for rounding at 1e-16, so one process, the
blocks of a stack, the batches of a streamed one and the ranks of a mesh
(whose all-reduce adds the f64 sums) give the same sums once rounded to
f32, where f32 sums in another order differ in their last bits, and the
template engine's bf16 references turn such bits into angles
(``tests/test_torch_distributed.py``).  ``class_sum_oe`` sums transformed images (the bilinear
``transform_batch`` of the plain and kernel steps);
``class_sum_transform_mm`` transforms by the FFT shear and sums in one,
as the JAX package's ``matmul``, ``fused`` and ``template`` steps do
(here the ``matmul`` and ``template`` steps).
"""

from __future__ import annotations

import torch

from ..params import AlignParams
from .transform import (_flip_edge, _irfft, _warp_spectrum, shear_block,
                        shear_pad)


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
