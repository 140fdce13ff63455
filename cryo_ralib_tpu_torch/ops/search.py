"""Rotational + translational + mirror alignment search (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/search.py``: reference spectra, the
plain search (``rotational_shift_search``, the f32 twin of the
hand-written kernel in ``ops/fused_search.py``), its stochastic
hill-climbing variant (``rotational_shift_search_shc``), the matmul
sampler's searches (``rotational_shift_search_mm``,
``rotational_shift_search_shc_mm``: the polar samples as tent products,
``ops/polar_mm.py``), the ``--dst`` discrete-angle mask, ``decode_params``, and the merge of the
winners of reference slices searched apart (``merge_ref_slices``, the
2-D mesh's ``ref`` split).

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
from .ccf import (ccf_rows, ccf_spectra, ccf_spectra_per_particle_ref,
                  ring_spectra, weight_ring_spectra)
from .polar import polar_resample
from .polar_mm import polar_group_mm, polar_tables, translate_bilinear_mm

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


def decode_priority(prio, n_shifts: int, n_refs: int, ring_len: int):
    """(mirror, sidx, ref, aidx) as int32 of flat priorities
    (``priority_index``'s inverse)."""
    aidx = prio % ring_len
    rest = prio // ring_len
    ref = rest % n_refs
    rest = rest // n_refs
    return ((rest // n_shifts).int(), (rest % n_shifts).int(), ref.int(),
            aidx.int())


_I64_MAX = 2**63 - 1


def merge_ref_slices(result: SearchResult, k0, n_shifts: int, n_refs: int,
                     reduce) -> SearchResult:
    """The winners of the whole search from those of its reference slices
    (the 2-D mesh's ``ref`` split): a slice searched the references
    ``k0 ..`` of ``n_refs``, and its ``best_ref`` counts from ``k0``.

    The rule is the search's own: the larger value wins, then the lower
    global priority (``priority_index`` with ``k0 + best_ref`` and all
    ``n_refs``).  A slice's flat order [mirror][shift][ref][angle] is a
    restriction of the global one, so its first-seen winner is the lowest
    priority among its ties, and the merge of the slices' winners is the
    unsplit search's winner.  ``reduce(t, op)`` reduces a tensor over the
    slices by ``op`` "max", "min" or "sum" (in place, where it
    all-reduces over a ref group, ``parallel/mesh.py::ref_reduce``):
    three reductions, the values, the priorities of the slices that hold
    the maximum (int64 max elsewhere), and the rows, zeroed but on the
    winner's slice (adding zeros is exact).  A slice that searched
    nothing passes ``empty_result``.
    """
    ring_len = result.best_row.shape[-1]
    prio = priority_index(result.best_mirror, result.best_sidx,
                          result.best_ref.long() + k0, result.best_aidx,
                          n_shifts, n_refs, ring_len)
    val = reduce(result.best_val.clone(), "max")
    prio = torch.where(result.best_val == val, prio, _I64_MAX)
    win = reduce(prio.clone(), "min")
    row = reduce(torch.where((prio == win)[..., None], result.best_row,
                             0.0), "sum")
    mirror, sidx, ref, aidx = decode_priority(win, n_shifts, n_refs,
                                              ring_len)
    return SearchResult(best_val=val, best_row=row, best_aidx=aidx,
                        best_sidx=sidx, best_ref=ref, best_mirror=mirror)


def rotational_shift_search(images, ref_fw, params: AlignParams,
                            cfg: AlignConfig, shift_chunk: int = 8,
                            angle_mask=None,
                            per_particle_ref: bool = False) -> SearchResult:
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
      per_particle_ref: each particle against its ``params.ref_id`` only
        (``ccf_spectra_per_particle_ref``); every winner's ``best_ref``
        is then 0, so decode with ``update_ref=False``.
    """
    n = images.shape[0]
    dev = images.device
    ring_len = cfg.ring_len
    n_refs = 1 if per_particle_ref else ref_fw.shape[0]
    tables = search_tables(cfg, dev)
    shifts = tables.shifts  # (S, 2)
    s_total = shifts.shape[0]
    coords = tables.polar_coords
    chunk = max(1, min(shift_chunk, s_total))
    if angle_mask is not None:
        angle_mask = torch.as_tensor(angle_mask, dtype=torch.float32,
                                     device=dev)

    best = empty_result(n, ring_len, dev)
    for s0 in range(0, s_total, chunk):
        grid = shifts[s0:s0 + chunk]
        sx = params.shift_x[:, None] + grid[None, :, 0]
        sy = params.shift_y[:, None] + grid[None, :, 1]
        polar = polar_resample(images, coords, sx, sy)  # (N, C, R, L)
        orig_f, mirr_f = _ccf(ring_spectra(polar), ref_fw, params,
                              per_particle_ref)
        rows = ccf_rows(orig_f, mirr_f if cfg.mirror else None, ring_len)
        if angle_mask is not None:
            rows = rows + angle_mask
        best = _update_best(best, rows, s0, s_total, n_refs)
    return best


def _ccf(sbj_f, ref_fw, params: AlignParams, per_particle_ref: bool):
    if per_particle_ref:
        return ccf_spectra_per_particle_ref(sbj_f, ref_fw, params.ref_id)
    return ccf_spectra(sbj_f, ref_fw)


def empty_result(n: int, ring_len: int, device) -> SearchResult:
    """The running best before any chunk: value -3e38, everything else 0."""
    def zeros_i():
        return torch.zeros(n, dtype=torch.int32, device=device)

    return SearchResult(
        best_val=torch.full((n,), _NEG_INF, dtype=torch.float32,
                            device=device),
        best_row=torch.zeros((n, ring_len), dtype=torch.float32,
                             device=device),
        best_aidx=zeros_i(), best_sidx=zeros_i(), best_ref=zeros_i(),
        best_mirror=zeros_i())


def _update_best(best: SearchResult, rows, s0, s_total: int,
                 n_refs: int) -> SearchResult:
    """Fold one chunk of ccf rows (N, M, C, K, L) into the running best
    by (value, then lower priority index).  ``s0`` is the chunk's first
    global shift index when its shifts are ``s0 .. s0+C-1``, or a (C,)
    integer tensor of global shift indices when they are not contiguous
    (the eman2 search walks the grid by dy)."""
    n, n_mirr, chunk, k, ring_len = rows.shape
    flat = rows.reshape(n, -1)
    val, idx = torch.max(flat, dim=1)   # first maximum on ties
    aidx = (idx % ring_len).int()
    rest = idx // ring_len
    ridx = (rest % k).int()
    rest = rest // k
    if torch.is_tensor(s0):
        sidx = s0[rest % chunk].int()
    else:
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


_SHC_BIG = 2**31 - 1
PREVIOUSMAX_INIT = 1.0e-23   # every particle's first ``previousmax``

# Polar samples one pass of a PyTorch search may hold at once.  The
# bilinear gather keeps ~100 bytes of coordinates, int64 indices and
# corner values alive per sample, so 160 M samples is ~16 GB: one shift
# of 16384 particles at 36 rings x 256 angles.
PLAIN_SAMPLE_BUDGET = 160 * 2**20


def plain_shift_chunk(n: int, cfg: AlignConfig) -> int:
    """The most shifts (up to 8) whose polar samples for ``n`` particles
    stay inside ``PLAIN_SAMPLE_BUDGET``, at least 1."""
    per_shift = max(1, n * cfg.ring_num * cfg.ring_len)
    return max(1, min(8, cfg.n_shifts, PLAIN_SAMPLE_BUDGET // per_shift))


def _shc_fold(carry, rows, global_sidx, s_total: int, previousmax):
    """Fold one chunk of ccf rows into the running SHC pick.

    ``rows``: (N, M, C, K, L); ``global_sidx``: (C,) global shift-grid
    indices of the chunk's candidates.  The SHC rule keeps the candidate
    of MINIMUM global priority ``(m * S + sidx) * K + k`` whose peak over
    angles is strictly above ``previousmax``, so the fold is a running
    min and the chunks may come in any order.  ``carry`` is
    ``(SearchResult, best_prio (N,) int64)``.
    """
    best, best_prio = carry
    n, n_mirr, chunk, k_dim, ring_len = rows.shape
    dev = rows.device
    rmax = rows.amax(dim=-1)                                   # (N, M, C, K)
    m_i = torch.arange(n_mirr, device=dev)[:, None, None]
    c_g = global_sidx.long()[None, :, None]
    k_i = torch.arange(k_dim, device=dev)[None, None, :]
    prio = (m_i * s_total + c_g) * k_dim + k_i                 # (M, C, K)

    passing = rmax > previousmax[:, None, None, None]
    flatp = torch.where(passing, prio[None], _SHC_BIG).reshape(n, -1)
    minp, idx = torch.min(flatp, dim=1)
    val = torch.gather(rmax.reshape(n, -1), 1, idx[:, None])[:, 0]
    row = torch.gather(rows.reshape(n, -1, ring_len), 1,
                       idx[:, None, None].expand(n, 1, ring_len))[:, 0]
    aidx = torch.argmax(row, dim=-1).int()

    # the priority is global, so it decodes without the chunk
    ridx = (minp % k_dim).int()
    rest = minp // k_dim
    sidx = (rest % s_total).int()
    midx = (rest // s_total).int()

    better = minp < best_prio
    new_best = SearchResult(
        best_val=torch.where(better, val, best.best_val),
        best_row=torch.where(better[:, None], row, best.best_row),
        best_aidx=torch.where(better, aidx, best.best_aidx),
        best_sidx=torch.where(better, sidx, best.best_sidx),
        best_ref=torch.where(better, ridx, best.best_ref),
        best_mirror=torch.where(better, midx, best.best_mirror))
    return new_best, torch.minimum(minp, best_prio)


def rotational_shift_search_shc(images, ref_fw, params: AlignParams,
                                cfg: AlignConfig, previousmax,
                                shift_chunk: int | None = None,
                                per_particle_ref: bool = False):
    """Stochastic-hill-climbing (SHC) variant of the search
    (``random_method="SHC"``).

    Instead of the global argmax, each particle takes the FIRST candidate
    in the priority order (mirror, shift, ref) whose angle-row peak is
    strictly above its ``previousmax`` (N,), with that row's angle
    argmax.  The order is fixed, not random, so runs reproduce.
    ``shift_chunk`` is a memory knob only (None: ``plain_shift_chunk``).
    ``per_particle_ref`` searches each particle's ``params.ref_id`` only,
    as in ``rotational_shift_search``.

    Returns ``(SearchResult, found)``; ``found`` is an (N,) bool mask.  A
    particle with no such candidate has zero-filled result fields, and
    the caller keeps its params and its ``previousmax``.
    """
    n = images.shape[0]
    dev = images.device
    tables = search_tables(cfg, dev)
    s_total = tables.shifts.shape[0]
    chunk = (plain_shift_chunk(n, cfg) if shift_chunk is None
             else max(1, min(shift_chunk, s_total)))
    carry = (empty_result(n, cfg.ring_len, dev),
             torch.full((n,), _SHC_BIG, dtype=torch.int64, device=dev))
    for s0 in range(0, s_total, chunk):
        grid = tables.shifts[s0:s0 + chunk]
        sx = params.shift_x[:, None] + grid[None, :, 0]
        sy = params.shift_y[:, None] + grid[None, :, 1]
        polar = polar_resample(images, tables.polar_coords, sx, sy)
        orig_f, mirr_f = _ccf(ring_spectra(polar), ref_fw, params,
                              per_particle_ref)
        rows = ccf_rows(orig_f, mirr_f if cfg.mirror else None, cfg.ring_len)
        gs = torch.arange(s0, s0 + grid.shape[0], device=dev)
        carry = _shc_fold(carry, rows, gs, s_total, previousmax)
    result, best_prio = carry
    return result, best_prio < _SHC_BIG


# Device memory one pass of a matmul-sampler search may hold: the
# samples of one dy group for a block of particles (``mm_block``)
MM_SEARCH_BUDGET = 4 * 2**30


def mm_search_bytes(batch: int, n_refs: int, cfg: AlignConfig,
                    q: int | None = None) -> int:
    """Device bytes of one dy group of the matmul sampler on ``batch``
    particles: the y contraction's (Q, N, W) result in f32, its bf16
    rounding and the f32 copy that the x contraction reads (10 B a
    sample point and pixel column), the (N, n_dx, Q) polar samples twice
    and their ring spectra, the image's copies, and the ccf rows with
    the fold's copies.  ``q`` is the sample points of one shift
    (default ``ring_num * ring_len``; the eman2 rings pass theirs)."""
    h = w = cfg.img_dim
    if q is None:
        q = cfg.ring_num * cfg.ring_len
    n_dx = len(cfg.shift_x_vals)
    n_mirr = 2 if cfg.mirror else 1
    per = (q * w * 10 + 3 * n_dx * q * 4 + h * w * 10
           + 3 * n_mirr * n_dx * n_refs * cfg.ring_len * 4
           + 2 * n_mirr * n_dx * n_refs * (cfg.ring_len // 2 + 1) * 8)
    return batch * per


def mm_block(n: int, n_refs: int, cfg: AlignConfig,
             q: int | None = None) -> int:
    """Particles per block of a matmul-sampler search: as many as keep
    ``mm_search_bytes`` inside ``MM_SEARCH_BUDGET``, at least 1."""
    per = mm_search_bytes(1, n_refs, cfg, q)
    return max(1, min(n, MM_SEARCH_BUDGET // per))


def by_blocks(search, block: int, images, params: AlignParams, *extra):
    """``search(images, params, *extra)`` on blocks of ``block``
    particles (``extra``: (N,) tensors, sliced too), the per-particle
    outputs concatenated: a ``SearchResult``, or ``(SearchResult,
    found)``."""
    parts = []
    for i in range(0, images.shape[0], block):
        sl = slice(i, i + block)
        parts.append(search(images[sl], AlignParams(*[f[sl] for f in params]),
                            *[e[sl] for e in extra]))
    if isinstance(parts[0], SearchResult):
        return SearchResult(*[torch.cat(f) for f in zip(*parts)])
    results, found = zip(*parts)
    return (SearchResult(*[torch.cat(f) for f in zip(*results)]),
            torch.cat(found))


def _mm_rows(images, ref_fw, params: AlignParams, cfg: AlignConfig,
             per_particle_ref: bool, fast: bool):
    """The matmul sampler's ccf rows, one dy group at a time: the stack
    bilinear-translated by each particle's accumulated shift
    (``translate_bilinear_mm``, f32, exact for integer shifts), every dy
    of the grid sampling all its dx candidates with constant tent
    products (``polar_group_mm``, bf16 operands and f32 sums with
    ``fast``).  Yields ``(rows, sidx)``: the group's ccf rows and their
    x-major global shift indices ``arange(n_dx) * n_dy + yi``, the order
    of ``cfg.shifts``."""
    dev = images.device
    wy, wx = polar_tables(cfg, dev)
    n_dy, n_dx = wy.shape[0], wx.shape[0]
    x_major = torch.arange(n_dx, device=dev) * n_dy
    img_t = translate_bilinear_mm(images, params.shift_x, params.shift_y)
    for yi in range(n_dy):
        polar = polar_group_mm(img_t, wy[yi], wx, cfg.ring_num,
                               cfg.ring_len, fast=fast)
        orig_f, mirr_f = _ccf(ring_spectra(polar), ref_fw, params,
                              per_particle_ref)
        yield (ccf_rows(orig_f, mirr_f if cfg.mirror else None,
                        cfg.ring_len), x_major + yi)


def rotational_shift_search_mm(images, ref_fw, params: AlignParams,
                               cfg: AlignConfig, per_particle_ref: bool = False,
                               fast: bool = True,
                               angle_mask=None) -> SearchResult:
    """The search of ``rotational_shift_search`` through the matmul
    sampler (``sampler="matmul"``): the ccf rows of ``_mm_rows`` fold
    into the running best with their x-major global shift indices, the
    same priority order and first-seen rule as the plain search.  A
    stack whose group would exceed ``MM_SEARCH_BUDGET`` goes by blocks
    of particles (``mm_block``).  ``per_particle_ref`` and
    ``angle_mask`` as in the plain search."""
    n = images.shape[0]
    n_refs = 1 if per_particle_ref else ref_fw.shape[0]
    block = mm_block(n, n_refs, cfg)
    if n > block:
        return by_blocks(
            lambda x, p: rotational_shift_search_mm(
                x, ref_fw, p, cfg, per_particle_ref, fast, angle_mask),
            block, images, params)
    if angle_mask is not None:
        angle_mask = torch.as_tensor(angle_mask, dtype=torch.float32,
                                     device=images.device)
    s_total = len(cfg.shifts)
    best = empty_result(n, cfg.ring_len, images.device)
    for rows, sidx in _mm_rows(images, ref_fw, params, cfg,
                               per_particle_ref, fast):
        if angle_mask is not None:
            rows = rows + angle_mask
        best = _update_best(best, rows, sidx, s_total, n_refs)
    return best


def rotational_shift_search_shc_mm(images, ref_fw, params: AlignParams,
                                   cfg: AlignConfig, previousmax,
                                   per_particle_ref: bool = False,
                                   fast: bool = True):
    """The SHC pick of ``rotational_shift_search_shc`` through the matmul
    sampler of ``rotational_shift_search_mm``: the pick is a running min
    over global priorities, so the dy order does not matter.  Returns
    ``(SearchResult, found)``."""
    n = images.shape[0]
    n_refs = 1 if per_particle_ref else ref_fw.shape[0]
    block = mm_block(n, n_refs, cfg)
    if n > block:
        return by_blocks(
            lambda x, p, pm: rotational_shift_search_shc_mm(
                x, ref_fw, p, cfg, pm, per_particle_ref, fast),
            block, images, params, previousmax)
    dev = images.device
    s_total = len(cfg.shifts)
    carry = (empty_result(n, cfg.ring_len, dev),
             torch.full((n,), _SHC_BIG, dtype=torch.int64, device=dev))
    for rows, sidx in _mm_rows(images, ref_fw, params, cfg,
                               per_particle_ref, fast):
        carry = _shc_fold(carry, rows, sidx, s_total, previousmax)
    result, best_prio = carry
    return result, best_prio < _SHC_BIG


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
