"""Even/odd class-average accumulation (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/classavg.py::class_sum_oe``: per-class
sums split by the parity of each particle's global stack index, as a
one-hot product over the particle axis (deterministic on the GPU, unlike
atomics), plus member counts.
"""

from __future__ import annotations

import torch


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
      sums:   (K, 2, H, W) float32 — [:, 0] even-parity sum, [:, 1] odd.
      counts: (K,) int32 member counts.
    """
    n, h, w = images.shape
    dev = images.device
    if global_index is None:
        global_index = torch.arange(n, device=dev)
    slot = ref_id.long() * 2 + global_index.long() % 2       # (N,) in [0, 2K)
    onehot = (slot[:, None] == torch.arange(2 * n_classes, device=dev)
              ).to(images.dtype)
    class_onehot = (ref_id.long()[:, None]
                    == torch.arange(n_classes, device=dev)).int()
    if valid is not None:
        onehot = onehot * valid.to(images.dtype)[:, None]
        class_onehot = class_onehot * valid.int()[:, None]
    sums = onehot.T @ images.reshape(n, h * w)
    counts = class_onehot.sum(dim=0, dtype=torch.int32)
    return sums.reshape(n_classes, 2, h, w), counts
