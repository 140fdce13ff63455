"""Rotational + translational + mirror alignment search (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/search.py``: reference spectra, the
plain search (``rotational_shift_search``, the f32 twin of the
hand-written kernel in ``ops/fused_search.py``), the ``--dst``
discrete-angle mask and ``decode_params``.

The search keeps a running per-particle best over chunks of the shift
grid, so it never holds the whole (N, 2, S, K, L) ccf table.  Winners
follow the flat priority order (mirror, shift x-major, ref, angle) with
mirror outermost: the larger value wins, and on an exact tie the lower
priority index ``e = ((m*S + s)*K + k)*L + a``.  That is the result of
one unchunked argmax over the whole table, whatever ``shift_chunk`` is.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import AlignConfig
from ..params import AlignParams
from .ccf import ccf_rows, ccf_spectra, ring_spectra, weight_ring_spectra
from .polar import polar_resample

_NEG_INF = -3.0e38


def delta_angle_bins(ring_len: int, delta: float,
                     mode: str = "F") -> np.ndarray:
    """Sorted unique angle bins nearest each multiple of ``delta`` degrees
    within the ring span (360 for mode "F", 180 for "H"): the rotations a
    ``--dst`` discrete-angle iteration may pick."""
    if delta <= 0.0:
        raise ValueError("delta must be positive")
    span = 360.0 if mode == "F" else 180.0
    step = span / ring_len
    angles = np.arange(0.0, span - 1e-9, delta)
    return np.unique(np.round(angles / step).astype(np.int64) % ring_len)


def delta_angle_mask(ring_len: int, delta: float,
                     mode: str = "F") -> np.ndarray:
    """Additive (L,) f32 mask: 0 at ``delta_angle_bins``, -3e38 elsewhere.
    Bin 0 is always allowed."""
    mask = np.full(ring_len, _NEG_INF, np.float32)
    mask[delta_angle_bins(ring_len, delta, mode)] = 0.0
    return mask


class SearchResult(NamedTuple):
    """Raw per-particle search outcome (pre-decode)."""

    best_val: torch.Tensor     # (N,) peak ccf value
    best_row: torch.Tensor     # (N, L) angle row of the winner
    best_aidx: torch.Tensor    # (N,) int32 angle bin of the peak
    best_sidx: torch.Tensor    # (N,) int32 global shift-grid index
    best_ref: torch.Tensor     # (N,) int32 winning reference
    best_mirror: torch.Tensor  # (N,) int32 0/1


class SearchTables(NamedTuple):
    """The ``AlignConfig`` tables the search reads, as device tensors."""

    polar_coords: torch.Tensor   # (R, L, 2) f32
    ring_weights: torch.Tensor   # (R,) f32
    shifts: torch.Tensor         # (S, 2) f32


@lru_cache(maxsize=32)
def search_tables(cfg: AlignConfig, device: torch.device) -> SearchTables:
    """``cfg``'s tables on ``device``, copied there once per (cfg,
    device): a copy from pageable host memory makes the host wait for the
    stream, so a search that copied them would be a sync point."""
    return SearchTables(
        *[torch.as_tensor(a, device=device)
          for a in (cfg.polar_coords, cfg.ring_weights, cfg.shifts)])


def prepare_ref_spectra(refs, cfg: AlignConfig):
    """References (K, H, W) -> weighted ring spectra (K, R, F) complex64."""
    tables = search_tables(cfg, refs.device)
    ref_f = ring_spectra(polar_resample(refs, tables.polar_coords))
    return weight_ring_spectra(ref_f, tables.ring_weights)


def priority_index(mirror, sidx, ref, aidx, n_shifts: int, n_refs: int,
                   ring_len: int):
    """Flat priority ``((m*S + s)*K + k)*L + a`` (int64) of a candidate."""
    return (((mirror.long() * n_shifts + sidx.long()) * n_refs + ref.long())
            * ring_len + aidx.long())


def rotational_shift_search(images, ref_fw, params: AlignParams,
                            cfg: AlignConfig, shift_chunk: int = 8,
                            angle_mask=None) -> SearchResult:
    """Full (mirror x shift x ref x angle) search for one batch.

    Args:
      images: (N, H, W) float32 particle stack.
      ref_fw: (K, R, F) complex64 weighted reference ring spectra.
      params: current AlignParams; the accumulated shifts move the
        sampling centre.
      cfg:    AlignConfig (shift grid, rings, mirror flag).
      shift_chunk: shifts evaluated at once; a memory knob only.
      angle_mask: optional (L,) additive f32 mask (``delta_angle_mask``)
        added to every row before the argmax, so the winning row comes
        back masked; decode with ``refine=False``.
    """
    n = images.shape[0]
    dev = images.device
    ring_len = cfg.ring_len
    n_refs = ref_fw.shape[0]
    tables = search_tables(cfg, dev)
    shifts = tables.shifts  # (S, 2)
    s_total = shifts.shape[0]
    coords = tables.polar_coords
    chunk = max(1, min(shift_chunk, s_total))
    if angle_mask is not None:
        angle_mask = torch.as_tensor(angle_mask, dtype=torch.float32,
                                     device=dev)

    def zeros_i():
        return torch.zeros(n, dtype=torch.int32, device=dev)

    best = SearchResult(
        best_val=torch.full((n,), _NEG_INF, dtype=torch.float32, device=dev),
        best_row=torch.zeros((n, ring_len), dtype=torch.float32, device=dev),
        best_aidx=zeros_i(), best_sidx=zeros_i(), best_ref=zeros_i(),
        best_mirror=zeros_i())
    for s0 in range(0, s_total, chunk):
        grid = shifts[s0:s0 + chunk]
        sx = params.shift_x[:, None] + grid[None, :, 0]
        sy = params.shift_y[:, None] + grid[None, :, 1]
        polar = polar_resample(images, coords, sx, sy)  # (N, C, R, L)
        orig_f, mirr_f = ccf_spectra(ring_spectra(polar), ref_fw)
        rows = ccf_rows(orig_f, mirr_f if cfg.mirror else None, ring_len)
        if angle_mask is not None:
            rows = rows + angle_mask
        best = _update_best(best, rows, s0, s_total, n_refs)
    return best


def _update_best(best: SearchResult, rows, s0: int, s_total: int,
                 n_refs: int) -> SearchResult:
    """Fold one chunk of ccf rows (N, M, C, K, L), holding the shifts
    ``s0 .. s0+C-1``, into the running best by (value, then lower
    priority index)."""
    n, n_mirr, chunk, k, ring_len = rows.shape
    flat = rows.reshape(n, -1)
    val, idx = torch.max(flat, dim=1)   # first maximum on ties
    aidx = (idx % ring_len).int()
    rest = idx // ring_len
    ridx = (rest % k).int()
    rest = rest // k
    sidx = (rest % chunk + s0).int()
    midx = (rest // chunk).int()
    row = torch.gather(rows.reshape(n, -1, ring_len), 1,
                       (idx // ring_len)[:, None, None].expand(n, 1, ring_len)
                       )[:, 0]

    e_new = priority_index(midx, sidx, ridx, aidx, s_total, n_refs, ring_len)
    e_old = priority_index(best.best_mirror, best.best_sidx, best.best_ref,
                           best.best_aidx, s_total, n_refs, ring_len)
    better = (val > best.best_val) | ((val == best.best_val) & (e_new < e_old))
    return SearchResult(
        best_val=torch.where(better, val, best.best_val),
        best_row=torch.where(better[:, None], row, best.best_row),
        best_aidx=torch.where(better, aidx, best.best_aidx),
        best_sidx=torch.where(better, sidx, best.best_sidx),
        best_ref=torch.where(better, ridx, best.best_ref),
        best_mirror=torch.where(better, midx, best.best_mirror),
    )


def decode_params(result: SearchResult, params: AlignParams,
                  cfg: AlignConfig, update_ref: bool = True,
                  refine: bool = True) -> AlignParams:
    """SearchResult -> updated AlignParams.

    * shifts accumulate and clamp to ``+/- cfg.shift_limit``;
    * angle = 7-point parabolic (prb1d) refinement of the peak bin, with
      no offset when the fit is flat (``c3 == 0``), then ``360 - angle``,
      and ``+180`` when mirrored, wrapped into [0, 360) on that branch
      only — as the reference does.  ``refine=False`` (the discrete-angle
      search) takes the bin's exact angle and never reads the row.
    """
    ring_len = cfg.ring_len
    step = cfg.angle_step
    row = result.best_row
    base_angle = step * result.best_aidx.float()
    if refine:
        offs = torch.arange(-3, 4, device=row.device)
        cols = (result.best_aidx.long()[:, None] + offs[None, :]) % ring_len
        x = torch.gather(row, 1, cols)  # (N, 7)
        c2 = (49.0 * x[:, 0] + 6.0 * x[:, 1] - 21.0 * x[:, 2]
              - 32.0 * x[:, 3] - 27.0 * x[:, 4] - 6.0 * x[:, 5]
              + 31.0 * x[:, 6])
        c3 = (5.0 * x[:, 0] - 3.0 * x[:, 2] - 4.0 * x[:, 3] - 3.0 * x[:, 4]
              + 5.0 * x[:, 6])
        frac = torch.where(c3 != 0.0, step * (c2 / (2.0 * c3) - 4.0),
                           torch.zeros_like(c3))
        angle = 360.0 - (base_angle + frac)
    else:
        angle = 360.0 - base_angle
    angle_m = angle + 180.0
    angle_m = torch.where(angle_m >= 360.0, angle_m - 360.0, angle_m)
    angle = torch.where(result.best_mirror == 1, angle_m, angle)

    shift_grid = search_tables(cfg, row.device).shifts
    ds = shift_grid[result.best_sidx.long()]  # (N, 2)
    limit = cfg.shift_limit
    new_sx = (params.shift_x + ds[:, 0]).clamp(-limit, limit)
    new_sy = (params.shift_y + ds[:, 1]).clamp(-limit, limit)
    return AlignParams(
        angle=angle.float(),
        shift_x=new_sx,
        shift_y=new_sy,
        mirror=result.best_mirror,
        ref_id=result.best_ref if update_ref else params.ref_id,
    )
