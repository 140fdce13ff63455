"""SCF (self-correlation) alignment, ``random_method="SCF"`` (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/scf.py``.  Rotation is found on the
*self-correlation function* of each image, which does not move with a
translation, so it decouples from the shift search; the translation then
comes from one 2-D cross-correlation per rotation candidate.  The JAX
package does its transforms as matmul DFTs (a TPU workaround); here they
are ``torch.fft.rfft2`` / ``irfft2``.  The ``matmul`` sampler runs both
stages as the JAX package's does: the rotation search through
``rotational_shift_search_mm`` and the inverse-transformed references
through the FFT shear (``transform_batch_mm``), bf16 with ``fast``.

* scf: ``irfft2(|rfft2(img)|)``, rolled so that the (always largest) DC
  peak sits at the centre.
* rotation: the standard search at a zero-shift config (S=1, K=1, half
  rings) on the scf images, so the decode conventions (mode-H bin step,
  mirror + 180) are the main search's.  On a CUDA tensor this is one
  launch of the hand-written kernel, on the CPU the plain search.
* translation: the scf is centrosymmetric, which leaves a 180-degree
  ambiguity, so each particle scores two candidate angles.  The
  *reference* is inverse-transformed once per candidate and the whole
  shift window comes out of one cross-correlation map:

      score(s) = sum_z invref(z) * img(z + s),
      invref   = transform(ref, angle if mirror else -angle, mirror).

  Shifts are integers; the first maximum in the order
  [candidate][sy][sx] wins.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import AlignConfig
from ..params import AlignParams
from .fused_search import fused_search, search_plain
from .search import (SearchResult, decode_params, prepare_ref_spectra,
                     rotational_shift_search_mm)
from .transform import transform_batch, transform_batch_mm, transform_block


def scf_batch(images):
    """Centred self-correlation of a real image batch (N, H, W): the
    inverse transform of the Fourier amplitude, rolled by half the box."""
    h, w = images.shape[-2:]
    s = torch.fft.irfft2(torch.fft.rfft2(images).abs(), s=(h, w))
    return torch.roll(s, (h // 2, w // 2), dims=(-2, -1))


def zero_shift_cfg(cfg: AlignConfig) -> AlignConfig:
    return dataclasses.replace(cfg, shift_rng_x=0.0, shift_rng_y=0.0)


def scf_align(images, ref, cfg: AlignConfig, sampler: str = "plain",
              fast: bool = True):
    """SCF alignment of a batch against one reference.

    Args:
      images: (N, H, W) particles.  ref: (H, W) current average.
      cfg: AlignConfig with mode="H" (``ali2d_base`` forces it); its
        shift ranges give the integer translation window.
      sampler: the rotation stage's search, "kernel" (CUDA tensors),
        "plain" or "matmul" (which also inverse-transforms the reference
        by the FFT shear).
      fast: the matmul sampler's bf16 products (JAX's ``fast``).
    Returns:
      (AlignParams, peak (N,)): ref_id 0, shifts clamped to
      ``cfg.shift_limit`` like the standard decode.
    """
    if cfg.mode != "H":
        raise ValueError("SCF requires mode='H' half rings")
    n, h, w = images.shape
    dev = images.device
    cfg0 = zero_shift_cfg(cfg)
    zeros = AlignParams.zeros(n, dev)

    # ---- stage 1: rotation (+ mirror) from the scf ring spectra; the
    # scf images are made by blocks, the search is one call
    block = transform_block(h, w)
    sci = torch.empty_like(images)
    for start in range(0, n, block):
        sci[start:start + block] = scf_batch(images[start:start + block])
    ref_fw = prepare_ref_spectra(scf_batch(ref[None]), cfg0)
    if sampler == "matmul":
        res = rotational_shift_search_mm(sci, ref_fw, zeros, cfg0, fast=fast)
    else:
        search = fused_search if sampler == "kernel" else search_plain
        res = search(sci, ref_fw, zeros, cfg0)
    del sci
    dec = decode_params(res, zeros, cfg0, update_ref=False)
    ang = dec.angle % 360.0
    mirror = dec.mirror

    # ---- stage 2: translation, one ccf map per 180-degree candidate,
    # by blocks of ``transform_block`` particles (the inverse-transformed
    # references take the transform's temporaries)
    xr = int(round(cfg.shift_rng_x))
    yr = int(round(cfg.shift_rng_y))
    wy, wx = 2 * yr + 1, 2 * xr + 1
    zeros_f = torch.zeros(n, dtype=torch.float32, device=dev)
    cands = [(ang + 180.0 * k) % 360.0 for k in range(2)]
    wins = torch.empty((n, 2, wy, wx), dtype=torch.float32, device=dev)
    for start in range(0, n, block):
        sl = slice(start, start + block)
        m = images[sl].shape[0]
        img_f = torch.fft.rfft2(images[sl])
        for k, cand in enumerate(cands):
            c = cand[sl]
            mir = mirror[sl]
            inv = AlignParams(torch.where(mir == 1, c, -c), zeros_f[sl],
                              zeros_f[sl], mir, zeros.ref_id[sl])
            ref_b = ref[None].expand(m, h, w)
            invref = (transform_batch_mm(ref_b, inv, fast=fast)
                      if sampler == "matmul" else transform_batch(ref_b, inv))
            # score(s) = sum_z invref(z) img(z + s) = irfft2(conj(IR) * I)(s)
            cc = torch.fft.irfft2(torch.fft.rfft2(invref).conj() * img_f,
                                  s=(h, w))
            # entry s lives at (s mod h): one roll puts the window
            # [-yr..yr] x [-xr..xr] at the top-left corner
            wins[sl, k] = torch.roll(cc, (yr, xr), dims=(-2, -1))[:, :wy, :wx]

    flat = wins.reshape(n, -1)                         # [cand][sy][sx]
    peak, idx = torch.max(flat, dim=1)                 # first maximum
    xi = idx % wx
    rest = idx // wx
    yi = rest % wy
    ci = rest // wy

    limit = cfg.shift_limit
    params = AlignParams(
        angle=torch.where(ci == 1, cands[1], cands[0]).float(),
        shift_x=(xi - xr).float().clamp(-limit, limit),
        shift_y=(yi - yr).float().clamp(-limit, limit),
        mirror=mirror, ref_id=zeros.ref_id)
    return params, peak


def scf_search_result(params: AlignParams, peak, ring_len: int):
    """SCF output as a SearchResult-shaped record (diagnostics)."""
    n = params.angle.shape[0]
    dev = params.angle.device
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
    return SearchResult(
        best_val=peak,
        best_row=torch.zeros((n, ring_len), dtype=torch.float32, device=dev),
        best_aidx=zeros_i, best_sidx=zeros_i, best_ref=params.ref_id,
        best_mirror=params.mirror)
