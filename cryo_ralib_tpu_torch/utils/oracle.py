"""NumPy golden model of the alignment pipeline (a copy of
``cryo_ralib_tpu/utils/oracle.py``; tests/test_torch_oracle.py holds the
two to the same outputs).

A deliberately straightforward, loop-based reimplementation of the CUDA
semantics (cuda/gpu_aln_noref.cu) used as:

1. the test oracle every op is checked against (SURVEY.md §4: the
   reference ships no test suite — we create the pyramid with golden-value
   unit tests); and
2. the "EMAN2 CPU" baseline proxy for the benchmark speedup numbers
   (the reference's published 22x-37x is measured against SPHIRE's
   ``mref_ali2d_MPI``, which enumerates the identical search space per
   particle in C++ loops — see SURVEY.md §3.3).

Nothing here imports torch or JAX.  Keep this file boring.
"""

from __future__ import annotations

import numpy as np


def bilinear_sample_np(img: np.ndarray, y: float, x: float) -> float:
    """Clamp-to-edge bilinear read (texture semantics of
    cuda/gpu_aln_noref.cu:2083-2086)."""
    h, w = img.shape
    x = min(max(x, 0.0), w - 1.0)
    y = min(max(y, 0.0), h - 1.0)
    ix0 = int(np.floor(x))
    iy0 = int(np.floor(y))
    ix1 = min(ix0 + 1, w - 1)
    iy1 = min(iy0 + 1, h - 1)
    fx = x - ix0
    fy = y - iy0
    top = img[iy0, ix0] * (1 - fx) + img[iy0, ix1] * fx
    bot = img[iy1, ix0] * (1 - fx) + img[iy1, ix1] * fx
    return top * (1 - fy) + bot * fy


def polar_resample_np(img: np.ndarray, coords: np.ndarray,
                      shift_x: float = 0.0, shift_y: float = 0.0) -> np.ndarray:
    """cu_resample_to_polar (cuda/gpu_aln_noref.cu:818-879) for one image."""
    h, w = img.shape
    r_num, r_len, _ = coords.shape
    cx = w // 2 + shift_x
    cy = h // 2 + shift_y
    out = np.empty((r_num, r_len), np.float64)
    for i in range(r_num):
        for j in range(r_len):
            out[i, j] = bilinear_sample_np(
                img, cy + coords[i, j, 1], cx + coords[i, j, 0])
    return out


def ccf_table_np(sbj_polar: np.ndarray, ref_polar_list: np.ndarray,
                 ring_weights: np.ndarray) -> np.ndarray:
    """Rotational ccf rows of one subject (single shift) vs all refs.

    Implements cu_ccf_mult_m math + C2R IFFT:
    returns (2, K, L): [0] original, [1] mirrored.
    Uses normalized np.fft.irfft (the cuFFT C2R scale L is argmax-neutral).
    """
    r_num, r_len = sbj_polar.shape
    k = ref_polar_list.shape[0]
    sf = np.fft.rfft(sbj_polar, axis=-1)
    out = np.empty((2, k, r_len), np.float64)
    for kk in range(k):
        rf = np.fft.rfft(ref_polar_list[kk], axis=-1)
        orig = np.zeros(sf.shape[-1], np.complex128)
        mirr = np.zeros(sf.shape[-1], np.complex128)
        for i in range(r_num):
            orig += ring_weights[i] * np.conj(sf[i]) * rf[i]
            mirr += ring_weights[i] * np.conj(sf[i] * rf[i])
        out[0, kk] = np.fft.irfft(orig, n=r_len)
        out[1, kk] = np.fft.irfft(mirr, n=r_len)
    return out


def prb1d(x: np.ndarray) -> float:
    """SPARX Util::prb1d 7-point parabola peak offset, as specialized in
    cu_interpolate_angle (cuda/gpu_aln_noref.cu:2352-2399).
    Returns the interpolation factor (c2/(2*c3) - 4); 0 if degenerate."""
    c2 = (49. * x[0] + 6. * x[1] - 21. * x[2] - 32. * x[3] - 27. * x[4]
          - 6. * x[5] + 31. * x[6])
    c3 = 5. * x[0] - 3. * x[2] - 4. * x[3] - 3. * x[4] + 5. * x[6]
    if c3 != 0.0:
        return c2 / (2.0 * c3) - 4.0
    return 0.0


def _build_table_np(img, refs, coords, ring_weights, shifts,
                    acc_sx, acc_sy, mirror=True):
    """(M, S, K, L) ccf table of one particle (M=1 without the mirror
    channel)."""
    k = refs.shape[0]
    s = shifts.shape[0]
    r_len = coords.shape[1]
    n_mirr = 2 if mirror else 1
    ref_polar = np.stack([polar_resample_np(r, coords) for r in refs])
    table = np.empty((n_mirr, s, k, r_len), np.float64)
    for si in range(s):
        rows = ccf_table_np(
            polar_resample_np(img, coords, acc_sx + shifts[si, 0],
                              acc_sy + shifts[si, 1]),
            ref_polar, ring_weights)
        table[0, si] = rows[0]
        if mirror:
            table[1, si] = rows[1]
    return table


def _decode_np(table, idx, shifts, acc_sx, acc_sy, shift_limit,
               mode="F", refine=True):
    """compute_alignment_param decode of one flat table index
    (cuda/gpu_aln_noref.cu:2249-2314); mode "H" halves the bin step
    (EMAN2 ang_n half-ring convention).  ``refine=False`` skips the
    prb1d parabola (discrete-angle / delta searches)."""
    n_mirr, s, k, r_len = table.shape
    peak = table.reshape(-1)[idx]
    aidx = idx % r_len
    rest = idx // r_len
    ridx = rest % k
    rest //= k
    sidx = rest % s
    midx = rest // s

    step = (360.0 if mode == "F" else 180.0) / r_len
    if refine:
        row = table[midx, sidx, ridx]
        xs = np.array([row[(aidx + i) % r_len] for i in range(-3, 4)])
        angle = step * aidx + step * prb1d(xs)
    else:
        angle = step * aidx
    angle = 360.0 - angle
    if midx == 1:
        angle += 180.0
        if angle >= 360.0:
            angle -= 360.0

    sx = min(max(acc_sx + shifts[sidx, 0], -shift_limit), shift_limit)
    sy = min(max(acc_sy + shifts[sidx, 1], -shift_limit), shift_limit)
    return dict(angle=angle, shift_x=sx, shift_y=sy, mirror=int(midx),
                ref_id=int(ridx), peak=peak)


def align_particle_np(img: np.ndarray, refs: np.ndarray, coords: np.ndarray,
                      ring_weights: np.ndarray, shifts: np.ndarray,
                      acc_sx: float, acc_sy: float, shift_limit: float,
                      mode: str = "F", mirror: bool = True,
                      delta: float = 0.0):
    """Full single-particle search + decode.

    Mirrors mref_align_run for one particle: enumerate shifts, build the
    ccf table rows, global argmax in [mirror][shift][ref][angle] order,
    then compute_alignment_param decode (cuda/gpu_aln_noref.cu:2249-2314).
    ``mirror=False`` drops the mirrored channel (--nomirror); ``mode="H"``
    expects half-ring coords and decodes with the 180-degree span.
    ``delta > 0`` restricts the angle argmax to bins nearest multiples of
    delta and skips the prb1d refinement (the --dst discrete search,
    ``Util.Crosrng_ms_delta`` semantics).

    Returns dict(angle, shift_x, shift_y, mirror, ref_id, peak).
    """
    table = _build_table_np(img, refs, coords, ring_weights, shifts,
                            acc_sx, acc_sy, mirror=mirror)
    if delta > 0.0:
        r_len = table.shape[-1]
        masked = np.full_like(table, -np.inf)
        # same bin set as ops/search.delta_angle_bins (kept numpy-only here)
        span = 360.0 if mode == "F" else 180.0
        step = span / r_len
        bins = np.unique(np.round(
            np.arange(0.0, span - 1e-9, delta) / step).astype(np.int64)
            % r_len)
        masked[..., bins] = table[..., bins]
        idx = int(np.argmax(masked.reshape(-1)))
        return _decode_np(table, idx, shifts, acc_sx, acc_sy, shift_limit,
                          mode=mode, refine=False)
    idx = int(np.argmax(table.reshape(-1)))
    return _decode_np(table, idx, shifts, acc_sx, acc_sy, shift_limit,
                      mode=mode)


def align_particle_shc_np(img: np.ndarray, refs: np.ndarray,
                          coords: np.ndarray, ring_weights: np.ndarray,
                          shifts: np.ndarray, acc_sx: float, acc_sy: float,
                          shift_limit: float, previousmax: float,
                          mode: str = "F", mirror: bool = True):
    """SHC decode rule: the FIRST candidate in [mirror][shift][ref]
    priority order whose peak-over-angles beats ``previousmax``, decoded
    at that row's angle argmax (test_reffree_gpu_align.py:519-524,724;
    EMAN2 ``Util.shc`` candidate-peak semantics, deterministic
    priority-order variant of the reference's random scan).  Returns None
    when no candidate improves (the particle keeps its params; "nope")."""
    table = _build_table_np(img, refs, coords, ring_weights, shifts,
                            acc_sx, acc_sy, mirror=mirror)
    r_len = table.shape[-1]
    rowmax = table.reshape(-1, r_len).max(axis=-1)
    passing = np.nonzero(rowmax > previousmax)[0]
    if passing.size == 0:
        return None
    cand = int(passing[0])
    aidx = int(np.argmax(table.reshape(-1, r_len)[cand]))
    return _decode_np(table, cand * r_len + aidx, shifts, acc_sx, acc_sy,
                      shift_limit, mode=mode)


def transform_np(img: np.ndarray, angle: float, sx: float, sy: float,
                 mirror: int) -> np.ndarray:
    """cu_transform_batch (cuda/gpu_aln_noref.cu:1145-1197) for one image."""
    h, w = img.shape
    out = np.empty_like(img, dtype=np.float64)
    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    cx, cy = w // 2, h // 2
    for yo in range(h):
        for xo in range(w):
            x0 = (w - xo) if mirror else xo
            y0 = yo
            ux, uy = x0 - cx, y0 - cy
            rx = ux * ca - uy * sa + cx + sx
            ry = ux * sa + uy * ca + cy + sy
            out[yo, xo] = bilinear_sample_np(img, ry, rx)
    return out


def quadri_np(img: np.ndarray, yy: float, xx: float, ynew: int, xnew: int) -> float:
    """EMAN2 quadri_background (notebook 02 cell 2) for one sample; 1-based
    coords as in the kernel."""
    h, w = img.shape

    def fdata(i, j):
        return img[j - 1, i - 1]

    x, y = xx, yy
    if x < 1.0 or x >= w + 1.0 or y < 1.0 or y >= h + 1.0:
        x, y = float(xnew), float(ynew)
    i, j = int(x), int(y)
    dx0, dy0 = x - i, y - j
    ip1, im1, jp1, jm1 = i + 1, i - 1, j + 1, j - 1
    if ip1 > w: ip1 -= w
    if im1 < 1: im1 += w
    if jp1 > h: jp1 -= h
    if jm1 < 1: jm1 += h
    f0 = fdata(i, j)
    c1 = fdata(ip1, j) - f0
    c2 = (c1 - f0 + fdata(im1, j)) * 0.5
    c3 = fdata(i, jp1) - f0
    c4 = (c3 - f0 + fdata(i, jm1)) * 0.5
    dxb, dyb = dx0 - 1, dy0 - 1
    hxc = 1 if dx0 >= 0 else -1
    hyc = 1 if dy0 >= 0 else -1
    ic, jc = i + hxc, j + hyc
    if ic > w: ic -= w
    elif ic < 1: ic += w
    if jc > h: jc -= h
    elif jc < 1: jc += h
    c5 = ((fdata(ic, jc) - f0 - hxc * c1 - (hxc * (hxc - 1.0)) * c2
           - hyc * c3 - (hyc * (hyc - 1.0)) * c4) * (hxc * hyc))
    return f0 + dx0 * (c1 + dxb * c2 + dy0 * c5) + dy0 * (c3 + dyb * c4)


def rot_shift2d_np(img: np.ndarray, ang_deg: float, delx: float, dely: float,
                   scale: float = 1.0) -> np.ndarray:
    """rot_scale_trans2D_background kernel (notebook 02 cell 2), one image,
    no mirror (the wrapper applies mirror as a post-flip)."""
    h, w = img.shape
    out = np.empty_like(img, dtype=np.float64)
    if scale == 0.0:
        scale = 1.0
    ang = np.deg2rad(ang_deg)
    # restrict2
    while delx >= w: delx -= w
    while delx <= -w: delx += w
    while dely >= h: dely -= h
    while dely <= -h: dely += h
    xc, yc = w // 2, h // 2
    shiftxc, shiftyc = xc + delx, yc + dely
    cang, sang = np.cos(ang), np.sin(ang)
    for iy in range(h):
        y = iy - shiftyc
        ycang = y * cang / scale + yc
        ysang = -y * sang / scale + xc
        for ix in range(w):
            x = ix - shiftxc
            xold = x * cang / scale + ysang
            yold = x * sang / scale + ycang
            out[iy, ix] = quadri_np(img, yold + 1.0, xold + 1.0, iy + 1, ix + 1)
    return out


def mirror_flip_np(img: np.ndarray) -> np.ndarray:
    """Post-transform mirror of the notebook wrapper: flip columns from
    ``start = 1 - h % 2`` on."""
    h = img.shape[0]
    start = 1 - h % 2
    out = img.copy()
    out[:, start:] = out[:, start:][:, ::-1]
    return out


# ---------------------------------------------------------------------------
# EMAN2-convention CPU baseline: variable-length Numrinit rings + ringwe
# weights.  The reference CPU path (`mref_ali2d_MPI`,
# test_mref_gpu_align.py:741-750) aligns with `Util.Polar2Dm` over rings
# whose per-ring sample count is an FFT-friendly power of two near 2*pi*r
# (`sp_alignment.Numrinit`) and weights ring spectra with
# `sp_alignment.ringwe`; the GPU path (and this rebuild) uses uniform
# ring_len=256 with linear (i+1) weights (SURVEY.md §3.3).  These functions
# model the EMAN2 convention so tests can *quantify* assignment agreement
# between the two schemes (the SURVEY §3.3 validation contract).
# ---------------------------------------------------------------------------


def numrinit(first_ring: int, last_ring: int, skip: int = 1,
             mode: str = "F") -> list[tuple[int, int]]:
    """`sp_alignment.Numrinit` ring plan: [(radius, ring_len), ...].

    Per ring at radius k the length is the largest power of two <= the
    circumference sample count ``round(dpi*k)``, doubled when the true
    count overshoots by >50% (inner rings) or >20% (outermost ring),
    capped at 32768."""
    dpi = 2.0 * np.pi if mode in ("f", "F") else np.pi
    maxfft = 32768
    rings = []
    for k in range(first_ring, last_ring + 1, skip):
        jp = int(dpi * k + 0.5)
        ip = 1
        while ip * 2 <= jp:
            ip *= 2
        if k + skip <= last_ring and jp > ip + ip // 2:
            ip = min(maxfft, 2 * ip)
        if k + skip > last_ring and jp > ip + ip // 5:
            ip = min(maxfft, 2 * ip)
        rings.append((k, ip))
    return rings


def ringwe(rings: list[tuple[int, int]], mode: str = "F") -> np.ndarray:
    """`sp_alignment.ringwe` weights: w_i = r_i * dpi / L_i * maxrin / L_i."""
    dpi = 2.0 * np.pi if mode in ("f", "F") else np.pi
    maxrin = rings[-1][1]
    return np.asarray([r * dpi / ln * maxrin / ln for r, ln in rings],
                      np.float64)


def polar_rings_np(img: np.ndarray, rings: list[tuple[int, int]],
                   shift_x: float = 0.0, shift_y: float = 0.0) -> list:
    """Variable-length polar resample (`Util.Polar2Dm` convention model):
    ring at radius r sampled at its own L uniform angles, bilinear reads
    about the same center as `polar_resample_np`."""
    h, w = img.shape
    cx = w // 2 + shift_x
    cy = h // 2 + shift_y
    out = []
    for r, ln in rings:
        row = np.empty(ln, np.float64)
        for j in range(ln):
            ang = 2.0 * np.pi * j / ln
            row[j] = bilinear_sample_np(img, cy + r * np.sin(ang),
                                        cx + r * np.cos(ang))
        out.append(row)
    return out


def ccf_rows_eman_np(sbj_rings: list, ref_rings_list: list,
                     weights: np.ndarray, maxrin: int) -> np.ndarray:
    """Rotational ccf of one subject vs all refs under the EMAN2 scheme
    (`Util.Crosrng_ms` model): each ring contributes its own harmonics
    (up to L_i/2) into a maxrin-length angle response; mirror via the
    conjugate trick as in `ccf_table_np`.  Returns (2, K, maxrin)."""
    k = len(ref_rings_list)
    nf = maxrin // 2 + 1
    sf = [np.fft.rfft(r) for r in sbj_rings]
    out = np.empty((2, k, maxrin), np.float64)
    for kk in range(k):
        orig = np.zeros(nf, np.complex128)
        mirr = np.zeros(nf, np.complex128)
        for i, (s, ref_ring) in enumerate(zip(sf, ref_rings_list[kk])):
            rf = np.fft.rfft(ref_ring)
            nb = min(len(s), nf)
            wb = np.full(nb, weights[i])
            if nb < nf:
                # a short ring's Nyquist lands on an INTERIOR bin of the
                # maxrin spectrum, which irfft doubles; Applyws pre-halves
                # it (sp_alignment.Applyws: 0.5*w when numr3i != maxrin)
                wb[-1] *= 0.5
            orig[:nb] += wb * np.conj(s[:nb]) * rf[:nb]
            mirr[:nb] += wb * np.conj(s[:nb] * rf[:nb])
        out[0, kk] = np.fft.irfft(orig, n=maxrin)
        out[1, kk] = np.fft.irfft(mirr, n=maxrin)
    return out


def align_particle_eman_np(img: np.ndarray, refs: np.ndarray,
                           rings: list[tuple[int, int]], shifts: np.ndarray,
                           acc_sx: float = 0.0, acc_sy: float = 0.0,
                           shift_limit: float = 1e9):
    """EMAN2-convention single-particle search: variable rings + ringwe,
    argmax over [mirror][shift][ref][maxrin angles] in the same priority
    order as `align_particle_np`, same prb1d refine and angle decode.

    The CPU baseline this models: `Util.multiref_polar_ali_2d` inside
    `mref_ali2d_MPI` (test_mref_gpu_align.py:771)."""
    weights = ringwe(rings)
    maxrin = rings[-1][1]
    ref_rings = [polar_rings_np(r, rings) for r in refs]
    k = refs.shape[0]
    s = shifts.shape[0]
    table = np.empty((2, s, k, maxrin), np.float64)
    for si in range(s):
        rows = ccf_rows_eman_np(
            polar_rings_np(img, rings, acc_sx + shifts[si, 0],
                           acc_sy + shifts[si, 1]),
            ref_rings, weights, maxrin)
        table[0, si] = rows[0]
        table[1, si] = rows[1]

    flat = table.reshape(-1)
    idx = int(np.argmax(flat))
    peak = flat[idx]
    aidx = idx % maxrin
    rest = idx // maxrin
    ridx = rest % k
    rest //= k
    sidx = rest % s
    midx = rest // s

    row = table[midx, sidx, ridx]
    xs = np.array([row[(aidx + i) % maxrin] for i in range(-3, 4)])
    step = 360.0 / maxrin
    angle = step * aidx + step * prb1d(xs)
    angle = 360.0 - angle
    if midx == 1:
        angle += 180.0
        if angle >= 360.0:
            angle -= 360.0
    sx = min(max(acc_sx + shifts[sidx, 0], -shift_limit), shift_limit)
    sy = min(max(acc_sy + shifts[sidx, 1], -shift_limit), shift_limit)
    return dict(angle=angle, shift_x=sx, shift_y=sy, mirror=int(midx),
                ref_id=int(ridx), peak=peak)


# --------------------------------------------------------------------------
# SCF (self-correlation) alignment — random_method="SCF"
# --------------------------------------------------------------------------

def scf_np(img: np.ndarray) -> np.ndarray:
    """Self-correlation function: centered inverse FFT of the Fourier
    amplitude |F| (EMAN2 ``fundamentals.scf`` / self-mutual-correlation).

    Translation-invariant and centrosymmetric — rotation can be read off
    it independently of shifts, at the cost of a 180-degree ambiguity.
    Used by the CPU twin's ``random_method="SCF"`` path
    (test_reffree_gpu_align.py:714: SCF forces mode="H";
    ``ali2d_single_iter`` -> SPHIRE ``multalign2d_scf``, outside the
    reference repo — semantics defined here and mirrored by
    ops/scf.py).
    """
    amp = np.abs(np.fft.fft2(img.astype(np.float64)))
    return np.fft.fftshift(np.fft.ifft2(amp).real)


def align_particle_scf_np(img: np.ndarray, ref: np.ndarray,
                          coords: np.ndarray, ring_weights: np.ndarray,
                          xr: int, yr: int, shift_limit: float):
    """SCF two-stage alignment of one particle against one reference.

    Stage 1 (rotation): polar half-rings ("H" ``coords``) of scf(img) vs
    scf(ref), rotational ccf with the mirror channel, global argmax over
    (mirror, angle), prb1d refinement, H-mode decode — exactly the
    standard decode at zero shift.  The scf's centrosymmetry leaves a
    180-degree ambiguity: candidates {angle, angle+180}.

    Stage 2 (translation): for each candidate, score integer shifts
    s in [-xr..xr]x[-yr..yr] as

        score(s) = sum_z invref(z) * img(z + s)   (circulant roll)

    where ``invref = transform_np(ref, angle if mirror else -angle, 0,
    0, mirror)`` — the identity sum_y ref(y) * transform_np(img, angle,
    sx, sy, m)(y) == sum_z invref(z) * img(z+s) (rotating the single
    reference instead of the particle per shift; for 2-D rotations
    M R(t) M = R(-t) gives the mirrored-branch angle sign).  The best
    (candidate, shift) wins; order [cand][sy][sx], first max.

    Returns dict(angle, shift_x, shift_y, mirror, ref_id=0, peak).
    """
    sci = scf_np(img)
    scr = scf_np(ref)
    table = ccf_table_np(polar_resample_np(sci, coords),
                         np.stack([polar_resample_np(scr, coords)]),
                         ring_weights)  # (2, 1, L)
    r_len = table.shape[-1]
    flat = table.reshape(-1)
    idx = int(np.argmax(flat))
    aidx = idx % r_len
    midx = idx // r_len
    row = table[midx, 0]
    xs = np.array([row[(aidx + i) % r_len] for i in range(-3, 4)])
    step = 180.0 / r_len            # H mode
    ang = step * aidx + step * prb1d(xs)
    ang = 360.0 - ang
    if midx == 1:
        ang += 180.0
        if ang >= 360.0:
            ang -= 360.0

    best = None
    for cand in (ang % 360.0, (ang + 180.0) % 360.0):
        inv_ang = cand if midx == 1 else -cand
        invref = transform_np(ref.astype(np.float64), inv_ang, 0.0, 0.0,
                              midx)
        for sy in range(-int(yr), int(yr) + 1):
            for sx in range(-int(xr), int(xr) + 1):
                score = float(np.sum(
                    invref * np.roll(img, (-sy, -sx), axis=(0, 1))))
                if best is None or score > best["peak"]:
                    best = dict(angle=cand,
                                shift_x=min(max(sx, -shift_limit),
                                            shift_limit),
                                shift_y=min(max(sy, -shift_limit),
                                            shift_limit),
                                mirror=int(midx), ref_id=0, peak=score)
    return best
