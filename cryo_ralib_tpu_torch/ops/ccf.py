"""Ring-FFT cross-correlation spectra (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/ccf.py``: polar rings are rFFT'd
along the angle axis; the rotational ccf of subject ``s`` and reference
``r`` is ``sum_rings conj(S_i) * R_i`` (ring weights folded into R), and
the mirrored subject's ccf is ``conj(sum_rings S_i * R_i)``.  The JAX
package does its DFTs as matmuls (a TPU workaround); here they are
``torch.fft``.
"""

from __future__ import annotations

import torch


def ring_spectra(polar):
    """rFFT along the angle axis: (..., R, L) -> (..., R, L//2+1) complex64
    (unnormalised forward, as cuFFT R2C)."""
    return torch.fft.rfft(polar, dim=-1)


def weight_ring_spectra(ref_f, ring_weights):
    """Fold ring weights into reference spectra: (K, R, F) * (R,)."""
    return ref_f * ring_weights[None, :, None].to(ref_f.real.dtype)


def ccf_spectra(sbj_f, ref_fw):
    """Weighted rotational ccf spectra of every subject against every ref.

    Args:
      sbj_f:  (N, C, R, F) complex — subject ring spectra, C shifts.
      ref_fw: (K, R, F) complex — weighted reference ring spectra.
    Returns:
      (orig, mirr), each (N, C, K, F) complex:
      orig = sum_r conj(S) * R ; mirr = conj(sum_r S * R).
    """
    orig = torch.einsum("ncrf,krf->nckf", sbj_f.conj().resolve_conj(), ref_fw)
    mirr = torch.einsum("ncrf,krf->nckf", sbj_f, ref_fw).conj().resolve_conj()
    return orig, mirr


def ccf_spectra_per_particle_ref(sbj_f, ref_fw, ref_id):
    """``ccf_spectra`` with each particle against its assigned reference
    only (the reference's ``cu_ccf_mult``, which selects
    ``ref_batch_ptr[aln_param[i].ref_id]``).

    Args:
      sbj_f: (N, C, R, F); ref_fw: (K, R, F); ref_id: (N,) integer.
    Returns:
      (orig, mirr), each (N, C, 1, F) complex: the K axis is kept with
      one entry, so the downstream argmax decodes the same way.
    """
    ref_sel = ref_fw[ref_id.long()]   # (N, R, F)
    orig = torch.einsum("ncrf,nrf->ncf", sbj_f.conj().resolve_conj(),
                        ref_sel)[:, :, None, :]
    mirr = torch.einsum("ncrf,nrf->ncf", sbj_f,
                        ref_sel).conj().resolve_conj()[:, :, None, :]
    return orig, mirr


def ccf_rows(orig_f, mirr_f, ring_len: int):
    """Inverse-FFT ccf spectra to (N, 2, C, K, L) real angle rows ordered
    [orig, mirr] on axis 1, so a flat argmax follows the priority order
    (mirror, shift, ref, angle).  ``mirr_f=None`` gives (N, 1, C, K, L).

    The inverse is normalised by 1/L (cuFFT C2R is not): a positive scale
    that moves no argmax and no parabolic peak offset.
    """
    if mirr_f is None:
        stacked = orig_f[:, None]
    else:
        stacked = torch.stack([orig_f, mirr_f], dim=1)
    return torch.fft.irfft(stacked, n=ring_len, dim=-1)
