"""The template engine (``sampler="template"``): the whole search as
matrix products (PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/template_search.py``.  The
(mirror x shift x ref x angle) ccf table is one product of the particle
window with a template matrix:

    ccf[n, m, s, k, l] = <win[n], T[m, s, k, l]>

where ``win`` is the particle's central window translated by its
accumulated shift (``ops/polar_mm.py::translate_window_mm``) and ``T`` is
the bilinear-splat back-projection of the ring-weighted, angle-rolled
reference rings, rolled by the grid shift's integer part.  The splat uses
the bilinear tents of the polar sampling, so the table is the search's
own ccf table up to the engine's rounding, not an approximation.

Template build (per call, as the references change): the correlation
over the ring angle is done per frequency against the splat spectra
(``splat_spectra``, the rfft over the ring angle of the splat tensor
``Wy[q, h] * Wx[q, w]``, which depends on the configuration only and is
hoisted by the engine and the device loops), then one inverse real FFT
per channel gives every angle's template:

    tb_orig[k, l, px] = sum_r irfft(ref_fw[k, r] * conj(SF[r, :, px]))[l]
    tb_mirr[k, l, px] = sum_r irfft(ref_fw[k, r] *      SF[r, :, px] )[-l % L]

A fractional shift grid (``ts=0.5``) splits every grid shift into an
integer pixel roll and a sub-pixel remainder; shifts that share a
remainder share one splat build with the tents at ``coords + frac``.

Rounding points, the JAX engine's: the window from the bf16 image and
bf16 tents with a bf16 intermediate, bf16 template columns, f32 sums and
f32 scores.  On a CUDA device the search product is
``torch.mm(bf16, bf16, out_dtype=torch.float32)`` where the installed
PyTorch has it, else the same product on f32 operands that hold the bf16
values under TF32 (every bf16 value is exact in TF32 and every product
exact in f32); on the CPU ("f32") the exact products summed in f64
and rounded once, so that a particle's scores do not depend on its
batch or rank (``_scores``, ``ops/polar_mm.py::mm_bf16``).  The TF32
switch is set only around the engine's own products and restored.  No
product returns bf16 scores.  The pixel axis of both operands is padded
with zeros to a multiple of 8 (81 x 81 = 6561 at the headline), which is
exact and keeps cuBLAS on its tensor-core paths.

The search walks the columns in chunks of whole angle rows, in ascending
order, with a strict ``>`` across chunks and the first maximum within
one: the first-seen maximum of the flat priority order
[mirror][shift][ref][angle] (``ops/search.py::priority_index``).  The
columns are sliced from the padded template blocks chunk by chunk; the
(C, Wpx) matrix is never materialized (2.6 GB at the headline's K=8).

Bound on the card: operations.  The product does 2 x N x Wpx x C
operations (C = 2 x 49 x K x 256 at the headline: 43.1 TFLOP for 16384
particles at K=8) against the tensor cores' bf16 rate; the bytes are the
window re-read per chunk and the (N, chunk) f32 scores written and read
back.  No hand kernel: the products are plain large matrix products, as
the JAX package leaves them to XLA's ``dot_general``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .eman_search import eman_groups
from .polar_mm import (_product_switches, product_route, tent_rows,
                       translate_window_mm)
from .search import _NEG_INF, SearchResult


# The JAX engine's gate, kept so that both packages admit the same
# geometries: a soft budget for the padded template blocks (sized for a
# v5e's 16 GB, not the card's capacity; the search streams its columns).
TEMPLATE_MATRIX_BUDGET_BYTES = 6 << 30

# fractional shift grids: each unique fractional (fy, fx) remainder needs
# its own splat-spectra build; ts=0.5 grids need 4 groups, ts=0.25
# sixteen.
MAX_FRAC_GROUPS = 16

# columns per chunk of the search (whole angle rows); the JAX package's
# value, held on the card by chip_smoke.py phase 14
COL_CHUNK_TARGET = 2048

# particles per block of the window's translate (its tent products hold
# ~35 bytes per window pixel and particle while they run)
WINDOW_BLOCK = 2048

_BIG = 2**31 - 1


def _split_shift(v: float) -> tuple[int, float]:
    """Floor-decompose a grid shift into (integer pixel roll, fractional
    tent remainder in [0, 1)), absorbing float fuzz at the boundary."""
    i = math.floor(v)
    f = v - i
    if f > 1.0 - 1e-9:
        i += 1
        f = 0.0
    return int(i), float(f)


def _frac_groups(cfg):
    """Group the x-major shift grid by fractional remainder.

    Returns (groups, decomp): ``groups`` maps a rounded (fy, fx) key to a
    representative exact (fy, fx); ``decomp`` lists, in the flat-table
    x-major shift order (``cfg.shifts``), each shift's (iy, ix, group
    key).  Integer grids give the single group (0, 0).
    """
    groups: dict = {}
    decomp = []
    for dx in cfg.shift_x_vals:
        for dy in cfg.shift_y_vals:
            iy, fy = _split_shift(float(dy))
            ix, fx = _split_shift(float(dx))
            key = (round(fy, 6), round(fx, 6))
            groups.setdefault(key, (fy, fx))
            decomp.append((iy, ix, key))
    return groups, decomp


def template_geometry(cfg):
    """(window_start, window_width, pad) of the central square window
    that covers every ring sample under every grid shift plus the
    bilinear tent: radius max_radius + max_shift + 1.

    max_shift is the largest ACTUAL grid value, not ``shift_rng``: step
    rounding in the inclusive grid can overshoot the range (step 0.75,
    range 1.9 gives +/-2.25), and a pad sized from the range would put
    slice origins outside the padded block."""
    mx = float(max(np.abs(cfg.shift_x_vals).max(initial=0.0),
                   np.abs(cfg.shift_y_vals).max(initial=0.0)))
    rad = int(np.ceil(cfg.max_radius + mx + 1))
    c = cfg.img_dim // 2
    pad = int(np.ceil(mx))
    return c - rad, 2 * rad + 1, pad


def _template_blocks_bytes(cfg, n_classes: int) -> int:
    """Bytes of the padded (Fg, M, K, L, wp, wp) bf16 block stack."""
    groups, _ = _frac_groups(cfg)
    _, width, pad = template_geometry(cfg)
    n_mirror = 2 if cfg.mirror else 1
    return (len(groups) * n_mirror * n_classes * cfg.ring_len
            * (width + 2 * pad) ** 2 * 2)


def _splat_spectra_bytes(cfg) -> int:
    """Bytes of the (complex64) splat spectra across fractional groups,
    which the engine and the device loops keep on the device."""
    groups, _ = _frac_groups(cfg)
    _, width, _ = template_geometry(cfg)
    wpx = width * width
    if cfg.ring_scheme == "eman2":
        per = sum(len(idx) * (ln // 2 + 1)
                  for ln, idx, _c in eman_groups(cfg))
    else:
        per = cfg.ring_num * (cfg.ring_len // 2 + 1)
    return len(groups) * per * wpx * 8


def template_supported(cfg, n_classes: int) -> bool:
    """Geometry gate of the template engine, the JAX package's: the
    sampling window inside the image, the padded template blocks within
    ``TEMPLATE_MATRIX_BUDGET_BYTES`` and at most ``MAX_FRAC_GROUPS``
    unique fractional remainders.  Any ``img_dim``/``ring_len``/K runs
    otherwise, the eman2 ring scheme included."""
    groups, _ = _frac_groups(cfg)
    if len(groups) > MAX_FRAC_GROUPS:
        return False
    lo, width, _ = template_geometry(cfg)
    if lo < 0 or lo + width > cfg.img_dim:
        return False
    return _template_blocks_bytes(cfg, n_classes) \
        <= TEMPLATE_MATRIX_BUDGET_BYTES


def _base_tents(cfg, lo, width, frac=(0.0, 0.0)):
    """Window tent matrices (Q, width) x2 at a fractional shift offset,
    numpy constants.  ``frac=(fy, fx)`` moves every ring sample point by
    the sub-pixel remainder; the integer part of a grid shift is applied
    later as a pad + slice pixel roll of the finished template."""
    coords = cfg.polar_coords
    c = cfg.img_dim // 2
    wy = tent_rows(c - lo + coords[..., 1].reshape(-1) + frac[0], width)
    wx = tent_rows(c - lo + coords[..., 0].reshape(-1) + frac[1], width)
    return wy, wx


def _splat_rfft(wy, wx, ring_len: int, device):
    """(R, F, Wpx) complex64 rfft over the ring angle of the splat
    ``wy[q, h] * wx[q, w]`` of Q = R x ring_len samples."""
    wy = torch.as_tensor(wy, device=device)
    wx = torch.as_tensor(wx, device=device)
    width = wy.shape[1]
    splat = (wy[:, :, None] * wx[:, None, :]).reshape(-1, ring_len,
                                                      width * width)
    return torch.fft.rfft(splat, dim=1)


def splat_spectra(cfg, frac=(0.0, 0.0), device="cpu"):
    """rfft-over-angle spectra of the splat tensor on ``device``.

    "cuda" scheme: one (R, F, Wpx) complex64 tensor.  "eman2" scheme: a
    tuple with one (R_g, F_g, Wpx) tensor per ring-length group
    (``eman_search.eman_groups`` order): each group's splat transforms
    over its own ring length L_g, so its harmonics land on the low bins
    of the shared maxrin angle spectrum, as the ``Util.Crosrng_ms``
    accumulation of ``ops/eman_search.py`` adds them.  Depends only on
    (cfg, frac)."""
    lo, width, _ = template_geometry(cfg)
    if cfg.ring_scheme == "eman2":
        c = cfg.img_dim // 2
        out = []
        for ln, _idx, coords in eman_groups(cfg):
            wy = tent_rows(c - lo + coords[..., 1].reshape(-1) + frac[0],
                           width)
            wx = tent_rows(c - lo + coords[..., 0].reshape(-1) + frac[1],
                           width)
            out.append(_splat_rfft(wy, wx, ln, device))
        return tuple(out)
    wy, wx = _base_tents(cfg, lo, width, frac)
    return _splat_rfft(wy, wx, cfg.ring_len, device)


def splat_spectra_groups(cfg, device="cpu"):
    """Per-fractional-group splat spectra, in ``_frac_groups`` order:
    the configuration-only invariant that the engine and the device loops
    build once (a 1-tuple for integer grids).  Pass it as ``sf=`` to
    ``template_search``/``build_template_blocks``."""
    groups, _ = _frac_groups(cfg)
    return tuple(splat_spectra(cfg, frac=f, device=device)
                 for f in groups.values())


def _ref_k(ref_fw) -> int:
    """K from either spectra form: (K, R, F) (cuda scheme) or the
    per-ring-group tuple of ``prepare_ref_spectra_eman``."""
    if isinstance(ref_fw, (tuple, list)):
        return int(ref_fw[0].shape[0])
    return int(ref_fw.shape[0])


def _contract(spec, sfg):
    """(K, R, F) x (R, F, P) -> (F, K, P): sum over rings per
    frequency."""
    return torch.matmul(spec.permute(2, 0, 1), sfg.permute(1, 0, 2))


def _angle_spectra(ref_fw, cfg, sf_g):
    """Per-pixel angle spectra of the orig/mirror templates for one
    fractional group: ``(g, h)``, each (F_max, K, Wpx) complex64 (``h``
    is None without mirror).

    cuda scheme: one contraction against the (R, F, Wpx) splat spectra.
    eman2 scheme: ``ref_fw``/``sf_g`` are per-ring-group tuples; each
    group's harmonics (f < L_g/2+1) add into the low bins of the shared
    maxrin spectrum, the pixel-domain image of the ``Util.Crosrng_ms``
    accumulation in ``ops/eman_search.py``."""
    if cfg.ring_scheme == "eman2":
        if len(ref_fw) != len(sf_g):
            raise ValueError(f"{len(ref_fw)} spectra groups against "
                             f"{len(sf_g)} splat groups: sf built for "
                             "another ring plan?")
        n_f = cfg.ring_len // 2 + 1
        k_num = _ref_k(ref_fw)
        wpx = sf_g[0].shape[-1]
        dev = sf_g[0].device
        g = torch.zeros((n_f, k_num, wpx), dtype=torch.complex64,
                        device=dev)
        h = torch.zeros_like(g) if cfg.mirror else None
        for spec, sfg in zip(ref_fw, sf_g):
            f_g = sfg.shape[1]
            g[:f_g] += _contract(spec, sfg.conj())
            if cfg.mirror:
                h[:f_g] += _contract(spec, sfg)
        return g, h
    g = _contract(ref_fw, sf_g.conj())
    h = _contract(ref_fw, sf_g) if cfg.mirror else None
    return g, h


def _normalize_sf(sf, order_len: int, cfg):
    """Resolve a caller's ``sf`` into the per-fractional-group tuple (or
    None to rebuild).  An eman2 entry is itself a tuple of per-ring-group
    tensors, so eman2 detection keys on the element type."""
    if sf is None:
        return None
    if cfg.ring_scheme == "eman2":
        if (isinstance(sf, (tuple, list)) and len(sf) > 0
                and isinstance(sf[0], (tuple, list))):
            return tuple(sf) if len(sf) == order_len else None
        # a bare per-ring-group tuple == one fractional group's spectra
        return (tuple(sf),) if order_len == 1 else None
    if isinstance(sf, (tuple, list)):
        return tuple(sf) if len(sf) == order_len else None
    return (sf,) if order_len == 1 else None


def build_template_blocks(ref_fw, cfg, sf=None):
    """Weighted ring spectra -> padded per-fractional-group template
    blocks.

    ``ref_fw``: (K, R, F) from ``prepare_ref_spectra`` (cuda scheme) or
    the per-ring-group tuple of ``prepare_ref_spectra_eman`` (eman2).

    Returns ``(tbps, fids, oys, oxs)``: ``tbps`` is the
    (Fg, M, K, L, wp, wp) bf16 stack of padded template blocks (one per
    fractional group; Fg=1 for integer grids) on the spectra's device,
    and the (S,) int32 numpy tables give, per x-major grid shift, its
    block id and the (y, x) slice origins that realize the shift's
    integer pixel roll.  The inverse FFT runs in f32; the blocks are
    rebuilt every call (the references change).
    """
    ring_len = cfg.ring_len
    k_num = _ref_k(ref_fw)
    n_chan = 2 if cfg.mirror else 1
    lo, width, pad = template_geometry(cfg)
    groups, decomp = _frac_groups(cfg)
    order = list(groups)
    dev = (ref_fw[0] if isinstance(ref_fw, (tuple, list)) else ref_fw).device
    sfs = _normalize_sf(sf, len(order), cfg)
    blocks = []
    for idx, key in enumerate(order):
        sf_g = (sfs[idx] if sfs is not None
                else splat_spectra(cfg, frac=groups[key], device=dev))
        g, h = _angle_spectra(ref_fw, cfg, sf_g)
        chans = [torch.fft.irfft(g, n=ring_len, dim=0)]     # (L, K, Wpx)
        if cfg.mirror:
            tbm = torch.fft.irfft(h, n=ring_len, dim=0)
            # angle index reversal (-l % L) = flip + roll
            chans.append(torch.roll(torch.flip(tbm, dims=(0,)), 1, dims=0))
        tb = torch.stack(chans).transpose(1, 2)               # (M, K, L, P)
        tb = tb.reshape(n_chan, k_num, ring_len, width, width)
        blocks.append(F.pad(tb.to(torch.bfloat16), (pad, pad, pad, pad)))
    tbps = torch.stack(blocks)                     # (Fg, M, K, L, wp, wp)
    gid = {key: i for i, key in enumerate(order)}
    fids = np.asarray([gid[key] for _, _, key in decomp], np.int32)
    oys = np.asarray([pad - iy for iy, _, _ in decomp], np.int32)
    oxs = np.asarray([pad - ix for _, ix, _ in decomp], np.int32)
    # every slice origin must land inside the padded block: a slice
    # outside it would be cut short silently, a wrong template
    if not (oys.min() >= 0 and oys.max() <= 2 * pad
            and oxs.min() >= 0 and oxs.max() <= 2 * pad):
        raise RuntimeError(f"slice origins {oys}, {oxs} outside the "
                           f"padded block (pad {pad})")
    return tbps, fids, oys, oxs


def _padded(wpx: int) -> int:
    """The pixel axis of the search's operands: ``wpx`` rounded up to a
    multiple of 8."""
    return -(-wpx // 8) * 8


def _fill_cols(out, tbps, fids, oys, oxs, cfg, k_num: int, g0: int):
    """Write the angle rows of flat (m, s, k) groups ``g0 ..`` into
    ``out`` (n_groups x L, >= Wpx) bf16, pixel columns Wpx.. untouched:
    each group is its shift's slice of its block.  The columns are in
    the order [mirror][shift][ref][angle], the flat priority order of the
    search (``ops/search.py::priority_index``)."""
    ring_len = cfg.ring_len
    s_num = cfg.n_shifts
    _, width, _ = template_geometry(cfg)
    wpx = width * width
    for j in range(out.shape[0] // ring_len):
        g = g0 + j
        m, rem = divmod(g, s_num * k_num)
        s, k = divmod(rem, k_num)
        oy, ox = int(oys[s]), int(oxs[s])
        out[j * ring_len:(j + 1) * ring_len, :wpx].unflatten(
            1, (width, width)).copy_(
                tbps[int(fids[s]), m, k, :, oy:oy + width, ox:ox + width])


def _col_chunk(c_total: int, ring_len: int) -> int:
    """Largest divisor of c_total that is a multiple of ring_len and
    <= ``COL_CHUNK_TARGET`` (at least ring_len)."""
    groups = c_total // ring_len
    best = ring_len
    for g in range(1, groups + 1):
        if groups % g == 0 and g * ring_len <= COL_CHUNK_TARGET:
            best = g * ring_len
    return best


# -- the products ------------------------------------------------------

def _scores(win, cols, route: str):
    """(N, Wp) window x (chunk, Wp) bf16 columns -> (N, chunk) f32
    scores with f32 sums.  ``win`` is bf16 on the "bf16" route and f32
    holding bf16 values otherwise.  On the "f32" route (the CPU) the
    exact products are summed in f64 and rounded once, as ``mm_bf16``
    sums them there."""
    if route == "bf16":
        return torch.mm(win, cols.t(), out_dtype=torch.float32)
    if route == "f32":
        return torch.mm(win.double(), cols.double().t()).float()
    return torch.mm(win, cols.to(torch.float32).t())


# -- the searches ------------------------------------------------------

def _search_operands(images, ref_fw, params, cfg, sf):
    """Shared preamble of the full and SHC searches: the window (the
    accumulated shifts fused into its extraction, by blocks of
    ``WINDOW_BLOCK`` particles, rounded to bf16, padded to
    ``_padded(Wpx)`` pixels, in the route's operand type) and the
    column reader, which fills one chunk buffer from the template
    blocks.  Returns ``(win, cols_fn, c_total, chunk, route)``."""
    ring_len = cfg.ring_len
    k_num = _ref_k(ref_fw)
    lo, width, _ = template_geometry(cfg)
    wp = _padded(width * width)
    route = product_route(images.device)
    n = images.shape[0]
    win = torch.zeros((n, wp), dtype=torch.bfloat16, device=images.device)
    for s in range(0, n, WINDOW_BLOCK):
        sl = slice(s, s + WINDOW_BLOCK)
        win[sl, :width * width] = translate_window_mm(
            images[sl], params.shift_x[sl], params.shift_y[sl], lo,
            width).flatten(1)
    if route != "bf16":
        win = win.to(torch.float32)
    n_chan = 2 if cfg.mirror else 1
    c_total = n_chan * cfg.n_shifts * k_num * ring_len
    chunk = _col_chunk(c_total, ring_len)
    tbps, fids, oys, oxs = build_template_blocks(ref_fw, cfg, sf=sf)
    buf = torch.zeros((chunk, wp), dtype=torch.bfloat16, device=tbps.device)
    n_groups = chunk // ring_len

    def cols_fn(i):
        _fill_cols(buf, tbps, fids, oys, oxs, cfg, k_num, i * n_groups)
        return buf

    return win, cols_fn, c_total, chunk, route


def _online_argmax(win, cols_fn, c_total: int, chunk: int, ring_len: int,
                   route: str, angle_mask=None):
    """(N, Wp) x columns streamed by ``cols_fn(i) -> (chunk, Wp)`` ->
    per-particle (best value, flat column index, winning (L,) angle row).

    Chunks are whole angle rows, so the winner's row lies in the chunk
    that produced it.  Ascending chunks with a strict ``>`` and the
    first maximum within a chunk keep the first-seen maximum of the flat
    priority order.  ``angle_mask`` is an optional (L,) additive f32 mask
    (``--dst``), tiled over the chunk's rows before the argmax."""
    n = win.shape[0]
    dev = win.device
    n_groups = chunk // ring_len
    mask = None
    if angle_mask is not None:
        mask = torch.as_tensor(angle_mask, dtype=torch.float32,
                               device=dev).repeat(n_groups)
    best_val = torch.full((n,), _NEG_INF, dtype=torch.float32, device=dev)
    best_idx = torch.zeros(n, dtype=torch.int64, device=dev)
    best_row = torch.zeros((n, ring_len), dtype=torch.float32, device=dev)
    with _product_switches(route):
        for i in range(c_total // chunk):
            scores = _scores(win, cols_fn(i), route)
            if mask is not None:
                scores.add_(mask)
            v, a = torch.max(scores, dim=1)
            grp = (a // ring_len)[:, None, None].expand(n, 1, ring_len)
            row = torch.gather(scores.view(n, n_groups, ring_len), 1,
                               grp)[:, 0]
            take = v > best_val
            best_val = torch.where(take, v, best_val)
            best_idx = torch.where(take, a + i * chunk, best_idx)
            best_row = torch.where(take[:, None], row, best_row)
    return best_val, best_idx, best_row


def _online_shc(win, cols_fn, c_total: int, chunk: int, ring_len: int,
                route: str, previousmax):
    """SHC pick over streamed template columns.

    The column order [mirror][shift][ref][angle] is the priority order,
    so a chunk's group ``g`` has the global candidate priority
    ``i * n_groups + g`` = ``(m * S + s) * K + k``: the SHC rule (the
    first candidate whose angle peak beats ``previousmax``) is a running
    minimum over passing groups.  Returns (priority, value, row)."""
    n = win.shape[0]
    dev = win.device
    n_groups = chunk // ring_len
    gidx = torch.arange(n_groups, dtype=torch.int64, device=dev)[None, :]
    best_prio = torch.full((n,), _BIG, dtype=torch.int64, device=dev)
    best_val = torch.full((n,), _NEG_INF, dtype=torch.float32, device=dev)
    best_row = torch.zeros((n, ring_len), dtype=torch.float32, device=dev)
    with _product_switches(route):
        for i in range(c_total // chunk):
            sg = _scores(win, cols_fn(i), route).view(n, n_groups, ring_len)
            gmax = sg.amax(dim=-1)                         # (N, G)
            pm = torch.where(gmax > previousmax[:, None],
                             gidx + i * n_groups, _BIG)
            minp, g = torch.min(pm, dim=1)
            val = torch.gather(gmax, 1, g[:, None])[:, 0]
            row = torch.gather(sg, 1, g[:, None, None].expand(
                n, 1, ring_len))[:, 0]
            take = minp < best_prio
            best_prio = torch.where(take, minp, best_prio)
            best_val = torch.where(take, val, best_val)
            best_row = torch.where(take[:, None], row, best_row)
    return best_prio, best_val, best_row


def template_search_shc(images, ref_fw, params, cfg, previousmax, sf=None):
    """SHC (stochastic hill climbing) through the template products: the
    pick of ``ops/search.py::rotational_shift_search_shc`` (the first
    candidate in priority order whose angle-row peak is strictly above
    ``previousmax``, with that row's angle argmax).

    Returns ``(SearchResult, found)``; a particle with no such candidate
    has zero-filled fields and keeps its previous params."""
    k_num = _ref_k(ref_fw)
    s_num = cfg.n_shifts
    win, cols_fn, c_total, chunk, route = _search_operands(
        images, ref_fw, params, cfg, sf)
    prio, val, row = _online_shc(win, cols_fn, c_total, chunk, cfg.ring_len,
                                 route, previousmax)
    found = prio < _BIG
    safe = torch.where(found, prio, 0)
    ridx = (safe % k_num).int()
    rest = safe // k_num
    sidx = (rest % s_num).int()
    midx = (rest // s_num).int()
    aidx = torch.argmax(row, dim=-1).int()
    return SearchResult(best_val=val, best_row=row, best_aidx=aidx,
                        best_sidx=sidx, best_ref=ridx,
                        best_mirror=midx), found


def template_search(images, ref_fw, params, cfg, sf=None,
                    angle_mask=None) -> SearchResult:
    """Full (mirror x shift x ref x angle) search through the template
    products, with the ``SearchResult`` contract and the priority order
    of the plain search.

    ``images`` (N, H, W) and ``ref_fw`` (``prepare_ref_spectra``, or
    ``prepare_ref_spectra_eman`` under the eman2 rings) on one device;
    ``sf`` the hoisted ``splat_spectra_groups`` (None: built here).
    ``angle_mask`` restricts the angle argmax to discrete
    bins (``--dst``; decode with ``refine=False``)."""
    ring_len = cfg.ring_len
    k_num = _ref_k(ref_fw)
    s_num = cfg.n_shifts
    win, cols_fn, c_total, chunk, route = _search_operands(
        images, ref_fw, params, cfg, sf)
    best_val, idx, row = _online_argmax(win, cols_fn, c_total, chunk,
                                        ring_len, route,
                                        angle_mask=angle_mask)
    aidx = (idx % ring_len).int()
    rest = idx // ring_len
    ridx = (rest % k_num).int()
    rest = rest // k_num
    sidx = (rest % s_num).int()
    midx = (rest // s_num).int()
    return SearchResult(best_val=best_val, best_row=row, best_aidx=aidx,
                        best_sidx=sidx, best_ref=ridx, best_mirror=midx)
