"""EMAN2-convention search: variable-length Numrinit rings + ringwe
(PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/eman_search.py``, the engine of
``AlignConfig(ring_scheme="eman2")``: rings of ``Numrinit(first_ring,
last_ring, rstep)`` with ``ringwe`` weights in place of the uniform
256-sample rings.  Both of the JAX package's samplers: "plain" (its
"gather": bilinear reads with the accumulated shift folded into the
centre) and "matmul" (the stack translated by its accumulated shifts,
then constant tent products per ring group, ``ops/polar_mm.py``).

Rings are grouped by their (power-of-two) length, a Numrinit plan having
only ~log2(maxrin) distinct lengths, and each group runs the standard
pipeline at its own length: sample, rFFT at L_g, weighted conjugate
product against the group's reference spectra.  Each ring adds its own
harmonics (bins 0..L_g/2) into one maxrin-bin ccf spectrum
(``Util.Crosrng_ms`` accumulation), which one inverse rFFT turns into the
(mirror, shift, ref, maxrin) rows that the shared running best folds.
``cfg.ring_len`` is maxrin under this scheme, so ``decode_params``
applies unchanged.  There is no hand-written kernel for this scheme (the
kernel takes uniform 256-sample rings, as the TPU kernel does), so it is
the PyTorch search on either device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import AlignConfig
from ..params import AlignParams
from .ccf import ring_spectra
from .polar import polar_resample
from .polar_mm import (build_polar_tables, polar_group_mm,
                       translate_bilinear_mm)
from .search import (PLAIN_SAMPLE_BUDGET, SearchResult, _update_best,
                     by_blocks, empty_result, mm_block)


def eman_groups(cfg: AlignConfig):
    """Rings grouped by length: [(L_g, ring_idx (R_g,), coords
    (R_g, L_g, 2) f32), ...] in ascending L_g order; the ring at radius r
    is sampled at the angles ``2 pi j / L_g`` about the image centre (the
    ``Polar2Dm`` convention)."""
    if cfg.ring_scheme != "eman2":
        raise ValueError("eman_groups needs ring_scheme='eman2'")
    rings = cfg.eman_rings
    by_len: dict[int, list[int]] = {}
    for i, (_r, ln) in enumerate(rings):
        by_len.setdefault(ln, []).append(i)
    groups = []
    for ln in sorted(by_len):
        idx = np.asarray(by_len[ln], np.int64)
        radii = np.asarray([rings[i][0] for i in idx], np.float64)[:, None]
        ang = 2.0 * np.pi * np.arange(ln, dtype=np.float64)[None, :] / ln
        coords = np.stack([np.cos(ang) * radii, np.sin(ang) * radii],
                          axis=-1).astype(np.float32)
        groups.append((ln, idx, coords))
    return groups


class EmanTables(NamedTuple):
    """The eman2 search's tables as device tensors."""

    groups: tuple              # per group (L_g, coords, weights)
    dxs: torch.Tensor          # (n_dx,) f32 grid x shifts
    dys: torch.Tensor          # (n_dy,) f32 grid y shifts
    x_major: torch.Tensor      # (n_dx,) int64 ``arange(n_dx) * n_dy``


@lru_cache(maxsize=32)
def eman_tables(cfg: AlignConfig, device: torch.device) -> EmanTables:
    """``cfg``'s eman2 tables on ``device``, copied there once per (cfg,
    device).  Per group: (L_g, coords (R_g, L_g, 2), weights
    (R_g, L_g/2+1)), the weights with a short ring's Nyquist bin halved."""
    ringwe = cfg.eman_ring_weights
    out = []
    for ln, idx, coords in eman_groups(cfg):
        wrow = np.repeat(ringwe[idx][:, None], ln // 2 + 1, axis=1)
        if ln < cfg.ring_len:
            # a short ring's Nyquist lands on an INTERIOR bin of the
            # maxrin ccf spectrum, which the inverse rFFT doubles;
            # Applyws halves it so that its net weight matches a long
            # ring's
            wrow[:, -1] *= 0.5
        out.append((ln, torch.as_tensor(coords, device=device),
                    torch.as_tensor(wrow.astype(np.float32), device=device)))
    n_dx, n_dy = len(cfg.shift_x_vals), len(cfg.shift_y_vals)
    return EmanTables(
        tuple(out), torch.as_tensor(cfg.shift_x_vals, device=device),
        torch.as_tensor(cfg.shift_y_vals, device=device),
        torch.as_tensor(np.arange(n_dx, dtype=np.int64) * n_dy,
                        device=device))


@lru_cache(maxsize=16)
def eman_mm_tables(cfg: AlignConfig, device: torch.device):
    """The matmul sampler's constant tents per ring group, on ``device``
    once per (cfg, device): ((wy (n_dy, Q_g, H), wx (n_dx, Q_g, W)), ...)
    in ``eman_groups`` order (the JAX package's ``_group_tables``)."""
    out = []
    for _ln, _idx, coords in eman_groups(cfg):
        t = build_polar_tables(cfg, coords=coords)
        out.append((torch.as_tensor(t.wy, device=device),
                    torch.as_tensor(t.wx, device=device)))
    return tuple(out)


def prepare_ref_spectra_eman(refs, cfg: AlignConfig):
    """References (K, H, W) -> per-group weighted ring spectra
    ((K, R_g, L_g/2+1) complex64, ...) in ``eman_groups`` order, the
    ``ringwe`` weights folded in (``Util.Applyws``)."""
    out = []
    for _ln, coords, weights in eman_tables(cfg, refs.device).groups:
        out.append(ring_spectra(polar_resample(refs, coords)) * weights[None])
    return tuple(out)


def rotational_shift_search_eman(images, ref_fwg, params: AlignParams,
                                 cfg: AlignConfig, angle_mask=None,
                                 sampler: str = "plain",
                                 fast: bool = True) -> SearchResult:
    """Full (mirror x shift x ref x angle) search under the eman2 ring
    scheme; the same ``SearchResult`` and priority order as the standard
    search.  ``ref_fwg`` comes from ``prepare_ref_spectra_eman``.
    ``sampler`` "plain" samples by bilinear reads, "matmul" by tent
    products (``polar_group_mm``, bf16 operands and f32 sums with
    ``fast``) on the stack translated by its accumulated shifts.

    The loop walks the grid's dy values with every dx candidate per step,
    so a step's global shift indices are ``arange(n_dx) * n_dy + yi``
    (x-major, the order of ``cfg.shifts``), not a contiguous range.  A
    stack whose samples for one step exceed ``PLAIN_SAMPLE_BUDGET``
    ("plain") or ``MM_SEARCH_BUDGET`` ("matmul") is searched in blocks
    of particles.
    """
    if sampler not in ("plain", "matmul"):
        raise ValueError(f"sampler must be 'plain' or 'matmul', not "
                         f"{sampler!r}")
    n = images.shape[0]
    dev = images.device
    groups, dxs, dys, x_major = eman_tables(cfg, dev)
    n_dx, n_dy = dxs.shape[0], dys.shape[0]
    k_dim = ref_fwg[0].shape[0]
    if angle_mask is not None:
        angle_mask = torch.as_tensor(angle_mask, dtype=torch.float32,
                                     device=dev)
    samples = sum(c.shape[0] * c.shape[1] for _l, c, _w in groups)
    if sampler == "matmul":
        block = mm_block(n, k_dim, cfg, samples)
    else:
        per_particle = n_dx * max(c.shape[0] * c.shape[1]
                                  for _l, c, _w in groups)
        block = max(1, PLAIN_SAMPLE_BUDGET // per_particle)
    if n > block:
        return by_blocks(
            lambda x, p: rotational_shift_search_eman(
                x, ref_fwg, p, cfg, angle_mask, sampler, fast),
            block, images, params)
    maxrin = cfg.ring_len
    n_f = maxrin // 2 + 1
    n_mirr = 2 if cfg.mirror else 1

    if sampler == "matmul":
        img_t = translate_bilinear_mm(images, params.shift_x, params.shift_y)
        tents = eman_mm_tables(cfg, dev)
    best = empty_result(n, maxrin, dev)
    sx = params.shift_x[:, None] + dxs[None, :]
    for yi in range(n_dy):
        sy = (params.shift_y[:, None] + dys[yi]).expand(n, n_dx)
        spec = torch.zeros((n, n_mirr, n_dx, k_dim, n_f),
                           dtype=torch.complex64, device=dev)
        for g, ((ln, coords, _w), rfw) in enumerate(zip(groups, ref_fwg)):
            f_g = ln // 2 + 1
            if sampler == "matmul":
                wy, wx = tents[g]
                pol = polar_group_mm(img_t, wy[yi], wx, coords.shape[0], ln,
                                     fast=fast)
            else:
                pol = polar_resample(images, coords, sx, sy)
            sbj_f = ring_spectra(pol)
            # Crosrng_ms accumulation: this group's harmonics land in the
            # low bins of the shared maxrin spectrum
            spec[:, 0, ..., :f_g] += torch.einsum(
                "ncrf,krf->nckf", sbj_f.conj().resolve_conj(), rfw)
            if cfg.mirror:
                spec[:, 1, ..., :f_g] += torch.einsum(
                    "ncrf,krf->nckf", sbj_f, rfw).conj().resolve_conj()
        rows = torch.fft.irfft(spec, n=maxrin, dim=-1)
        if angle_mask is not None:
            rows = rows + angle_mask
        best = _update_best(best, rows, x_major + yi, n_dx * n_dy, k_dim)
    return best
