"""Reference-free 2D alignment, the entry point (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/reffree.py::ali2d_base_tpu``:
every particle is aligned to the running global average with the full
rotation / shift / mirror search (``--nomirror`` drops the mirror
channel; ``mode="H"`` searches half rings; ``random_method`` "SHC" or
"SCF" replaces the search; ``ring_scheme="eman2"`` the rings), with
optional CTF premultiplication and Wiener-restored averages, the
``--Fourvar`` Fourier variance (``varf.hdf``), FSC-driven tangent
filtering, average centering, the ``a1`` dot criterion with auto-stop at ``maxit=0``, the ``--dst``
discrete-angle schedule, per-iteration QC (pixel error, mirror
consistency), a ``checkpoint.npz`` per iteration that ``resume=True``
continues from (either package's file), and the outputs ``aqc.hdf``,
``aqf.hdf``, ``aqfinal.hdf``, ``resolution%03d``, ``initial2Dparams.txt``
and ``logfile.txt``.

The stack is premultiplied by its CTFs under ``CTF`` and its masked
mean taken off on ``device`` in blocks (``engine.prepare_stack``), into
a device tensor that the engine keeps when it fits
(``parallel/batching.py``) or else into pinned host memory, from which
the engine streams it in batches (``batch_size=`` forces a batch).  The
average conditioning (one H x W image per iteration) runs on the host.

Under a ``mesh`` (``parallel/mesh.py``) each rank aligns its block of
the stack with global indices (the first even/odd sums take their
parity from them), the engine all-reduces the sums and gathers the
params, the CTF restoration and the Fourier variance reduce their sums
over the ranks, and rank 0 conditions the average (FSC, criterion,
filter, centering), writes every output file and the checkpoint, and
broadcasts the average and its criterion; the QC runs on the gathered
tables, on every rank.  Its one reference does not split over the ranks
of a 2-D mesh: ``ref > 1`` raises ``ValueError`` in every
``random_method``, as the JAX package's ``P("ref")`` placement refuses
it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import AlignConfig
from ..params import params_table, pixel_error_2D
from ..ops.ctf_ops import CtfContext
from ..ops.filters import fshift
from ..ops.fourvar import divide_by_variance, fourier_variance, variance_map
from ..ops.fsc import fsc_mask, write_fsc
from ..ops.masks import infomask, model_circle
from ..io.eman_hdf import write_image
from ..io.star import write_text_row
from ..parallel.mesh import (StackShard, barrier, broadcast_refs,
                             check_ref_split, rank_scan, shard_range,
                             shard_stack)
from ..utils.log import RunLogger
from ..utils.profiling import job, span
from .checkpoint import load_checkpoint, save_checkpoint
from .engine import (PREP_BLOCK, AlignmentEngine, plan_batch, prepare_stack,
                     resolve_device)
from .steps import resolve_route
from .user_functions import factory


@dataclass
class RefFreeResult:
    params: np.ndarray          # (N, 4) header [alpha, sx, sy, mirror]
    average: np.ndarray         # final filtered average
    criteria: list = field(default_factory=list)
    pixel_errors: list = field(default_factory=list)
    mirror_consistency: list = field(default_factory=list)
    radial_variances: list = field(default_factory=list)  # Fourvar, per it.
    iterations: int = 0
    class_counts: np.ndarray = field(   # (1,) members of the last pass
        default_factory=lambda: np.zeros(1, np.int64))


def ali2d_base(
    images,
    outdir: str | None = None,
    maskfile: np.ndarray | None = None,
    ir: int = 1,
    ou: int = -1,
    rs: int = 1,
    xr: float = 4.0,
    yr: float = -1.0,
    ts: float = 2.0,
    dst: float = 0.0,
    center: int = -1,
    maxit: int = 0,
    CTF: bool = False,
    Fourvar: bool = False,
    snr: float = 1.0,
    ctf_params: dict | None = None,
    user_func_name: str = "ref_ali2d",
    random_method: str = "",
    nomirror: bool = False,
    mode: str = "F",
    log: RunLogger | None = None,
    resume: bool = False,
    ring_scheme: str = "cuda",
    device="cuda",
    sampler: str = "auto",
    batch_size: int | None = None,
    mesh=None,
) -> RefFreeResult:
    """Align ``images`` (N, H, W; numpy or tensor) to their iteratively
    refined global average on ``device`` (the GPU unless
    ``device="cpu"``).

    Flags as ``ali2d_base_tpu``: ``yr < 0`` means ``yr = xr``; ``ou=-1``
    means ``nx//2 - 2``; ``maxit=0`` means up to 10 iterations with
    auto-stop when the criterion falls; ``center`` -1 subtracts the mean
    particle shift from the average, 0 leaves it, 1 centers it on its
    center of gravity; ``dst`` makes every 4th iteration (except the
    last 10) search multiples of ``dst`` degrees only, with no angle
    refinement.  ``mode="H"`` searches half rings (rotations in
    [0, 180)); ``random_method="SHC"`` is stochastic hill climbing (a
    particle takes the first candidate above its ``previousmax``),
    ``"SCF"`` self-correlation alignment (forces half rings);
    ``ring_scheme="eman2"`` the variable-length Numrinit rings (standard
    search only).  ``CTF=True`` premultiplies the particles by their CTFs
    (``ctf_params``: ``dfu`` per particle at least, see
    ``ops.ctf_ops.CtfContext``) and Wiener-restores the average with
    ``snr``.  ``Fourvar`` computes the 2-D Fourier variance of the aligned
    stack each iteration (the FFT-shear engine with bf16 DFTs, as
    ``ali2d_base_tpu``'s ``fourier_variance`` defaults), divides the
    average's spectrum by it and writes ``varf.hdf``.  ``sampler``,
    ``batch_size`` and ``mesh`` as in ``mref_ali2d`` (SHC runs the
    kernel's SHC pick under "auto"; SCF refuses "template"); a 2-D mesh
    with ``ref > 1`` raises ``ValueError``.
    """
    with job(driver="ali2d_base", n=int(images.shape[0]), K=1) as job_span:
        check_ref_split(1, mesh)
        device = resolve_device(device if mesh is None else mesh.device)
        root = mesh is None or mesh.is_root
        if outdir and root:
            os.makedirs(outdir, exist_ok=True)
        log = ((log or RunLogger(outdir)) if root
               else RunLogger(None, quiet=True))
        write_dir = outdir if root else None
        user_func = factory[user_func_name]
        # TF32 would cut the f32 semantics the port is held to
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        n, ny, nx = images.shape
        if nx != ny:
            raise ValueError("images must be square")
        if random_method == "SCF":
            mode = "H"   # SCF forces half rings
        last_ring = int(ou) if int(ou) != -1 else nx // 2 - 2
        if yr is None or yr < 0:
            yr = xr
        max_iter = int(maxit) if int(maxit) else 10
        auto_stop = int(maxit) == 0
        ir, rs = int(ir), int(rs)
        if ir < 1 or rs < 1 or ir > last_ring:
            raise ValueError(f"invalid ring plan: ir={ir} rs={rs} "
                             f"ou={last_ring}")
        if int(center) > 1:
            raise ValueError(f"--center={int(center)} is not supported "
                             "(reference-documented values: -1, 0, 1)")
        n_rings = len(range(ir, last_ring + 1, rs))
        if ring_scheme == "eman2" and random_method:
            raise ValueError("ring_scheme='eman2' supports the standard "
                             "search only (no SHC/SCF)")
        cfg = AlignConfig(img_dim=nx, ring_num=n_rings, ring_len=256,
                          first_ring=ir, ring_step=rs, ring_scheme=ring_scheme,
                          shift_step=float(ts), shift_rng_x=float(xr),
                          shift_rng_y=float(yr), mode=mode,
                          mirror=not nomirror)

        mask = (maskfile if maskfile is not None
                else model_circle(last_ring, nx))
        mask = np.asarray(mask, np.float32)
        mask_dev = torch.as_tensor(mask, device=device)

        ctf_ctx = None
        if CTF:
            if ctf_params is None:
                raise ValueError("CTF=True requires ctf_params (at least "
                                 "per-particle 'dfu' defocus in A)")
            ctf_ctx = CtfContext(nx, ctf_params, snr=snr, device=device,
                                 mesh=mesh)
            if n != ctf_ctx.n_total:
                raise ValueError(f"{n} images vs {ctf_ctx.n_total} CTFs")
            log.add("CTF premultiplication on, snr=%g" % snr)

        def prep(x, start):
            # subtract each particle's mean under the mask
            if ctf_ctx is not None:
                x = ctf_ctx.premultiply_block(x, start)
            mean, _sigma = infomask(x, mask_dev)
            return x - mean[:, None, None]

        local, _gidx = shard_stack(images, mesh)
        start, stop = shard_range(n, mesh)
        route = resolve_route(sampler, device, cfg, random_method, 1, mesh)
        batch = plan_batch(stop - start, route, cfg, device, batch_size,
                           log=log.add, mesh=mesh)
        with span("driver.prepare", device,
                  bytes=4 * int(np.prod(local.shape))):
            data = prepare_stack(local, device, batch >= stop - start, prep)
        engine = AlignmentEngine(StackShard(data, start, n), cfg, n_classes=1,
                                 device=device, sampler=route,
                                 update_ref=False, delta=dst,
                                 random_method=random_method, batch_size=batch,
                                 mesh=mesh)
        job_span.set(sampler=route.search, resident=engine.resident,
                     batch=engine.batch)
        if dst:
            log.add("Discrete angle used         : %d" % int(dst))
        if not engine.resident:
            log.add("streaming %d particles in batches of %d"
                    % (n, engine.batch))

        result = RefFreeResult(params=np.zeros((n, 4)),
                               average=np.zeros((nx, nx)))
        a0 = -1.0e22
        sx_sum = 0.0
        sy_sum = 0.0
        sums = None
        tavg = np.zeros((nx, nx), np.float32)
        total_iter = 0

        start_it = 0
        if resume and outdir:
            # the checkpoint that rank 0 wrote last is complete on every rank
            barrier(mesh)
            ck = load_checkpoint(outdir)
            if ck is not None:
                start_it, ck_params, tavg_ck, extra = ck
                start_it += 1
                engine.set_params(ck_params)
                tavg = tavg_ck[0]
                if random_method == "SHC" and "previousmax" in extra:
                    engine.set_previousmax(np.asarray(extra["previousmax"]))
                sums = np.asarray(extra["sums"])
                a0 = float(extra["a0"])
                sx_sum = float(extra["sx_sum"])
                sy_sum = float(extra["sy_sum"])
                total_iter = start_it
                log.add("resumed from checkpoint at iteration %d" % start_it)

        full = engine.params_np()

        def _delta_for(j: int) -> float:
            """--dst schedule: discrete angles every 4th iteration, except
            within the last 10."""
            if not dst or j < 0:
                return 0.0
            return dst if (j % 4 == 0 and (j + 1) <= max_iter - 10) else 0.0

        for it in range(start_it, max_iter):
            with span("driver.update", iteration=it, part="before"):
                total_iter += 1
                # ---- the new average from the previous iteration's sums
                if sums is None:
                    # iteration 0: even/odd sums of the raw stack
                    with span("driver.raw_sums", device):
                        sums = _even_odd_sums(data, device, start, mesh)
                ave1, ave2 = sums[0, 0], sums[0, 1]
                if ctf_ctx is not None:
                    tavg = ctf_ctx.restore((ave1 + ave2)[None])[0]
                else:
                    tavg = ((ave1 + ave2) / n).astype(np.float32)

                log.add("Iteration #%4d" % total_iter)
                log.add("X range = %5.2f   Y range = %5.2f   Step = %5.2f"
                        % (xr, yr, ts))
                if root:
                    frsc = fsc_mask(ave1, ave2, mask, 1.0)
                if write_dir:
                    write_image(os.path.join(outdir, "aqc.hdf"), tavg,
                                total_iter - 1)
                    write_fsc(os.path.join(outdir,
                                           "resolution%03d" % total_iter),
                              *frsc)

                # ---- Fourier variance of the aligned stack, with the params
                # that built these sums; the average is divided by it BEFORE
                # the criterion
                if Fourvar:
                    with span("driver.fourvar", device):
                        vav, rvar = fourier_variance(data, engine.params,
                                                     mask=mask_dev, mesh=mesh)
                    tavg = divide_by_variance(tavg, vav)
                    result.radial_variances.append(rvar)
                    if write_dir:
                        write_image(os.path.join(outdir, "varf.hdf"),
                                    variance_map(vav), total_iter - 1)

                # ---- rank 0: the criterion on the unfiltered average, and the
                # user function
                a1 = 0.0
                if root:
                    a1 = float(np.sum(tavg * tavg * mask))
                    log.add("Criterion %d = %15.8e" % (total_iter, a1))
                    if center == -1:
                        tavg_f, _cs = user_func([mask, 0, tavg, frsc])
                        cs = [float(sx_sum) / n, float(sy_sum) / n]
                        tavg_f = fshift(
                            torch.as_tensor(np.asarray(tavg_f, np.float32)),
                            -cs[0], -cs[1]).numpy()
                        log.add("Average center x = %10.3f        "
                                "Center y = %10.3f" % (cs[0], cs[1]))
                    else:
                        # after a discrete-angle iteration, centering is off
                        # for one call of the user function
                        c_eff = 0 if _delta_for(it - 1) != 0.0 else center
                        tavg_f, _cs = user_func([mask, c_eff, tavg, frsc])
                    tavg = np.asarray(tavg_f, np.float32)
                tavg, a1 = _share(tavg, a1, mesh)
                result.criteria.append(a1)
                if write_dir:
                    write_image(os.path.join(outdir, "aqf.hdf"), tavg,
                                total_iter - 1)
                if a1 < a0:
                    if auto_stop:
                        break
                else:
                    a0 = a1

                # ---- alignment against the new average
                old_tab = params_table(full)
                delta_it = _delta_for(it)
                if delta_it:
                    log.add("Iteration %d uses discrete angles (delta=%g)"
                            % (total_iter, delta_it))
            out = engine.iterate(tavg[None], discrete=delta_it != 0.0)
            with span("driver.update", iteration=it, part="after"):
                full = engine.params_np()
                sums = out.class_sums
                result.class_counts = out.counts
                sx_sum = out.sx_sum
                sy_sum = out.sy_sum
                if random_method == "SHC":
                    log.add("SHC: %d / %d particles kept their previous "
                            "orientation" % (out.nope, n))

                # ---- QC: pixel error / mirror consistency against the old
                # params
                new_tab = params_table(full)
                consistent = old_tab[:, 3] == new_tab[:, 3]
                errs = pixel_error_2D(
                    (old_tab[:, 0], old_tab[:, 1], old_tab[:, 2]),
                    (new_tab[:, 0], new_tab[:, 1], new_tab[:, 2]),
                    last_ring).numpy()
                n_cons = int(consistent.sum())
                result.mirror_consistency.append(n_cons / n)
                result.pixel_errors.append(
                    float(errs[consistent].sum() / max(n_cons, 1)))
                log.add("Mirror consistency %6.2f%%, mean pixel error %.4f"
                        % (100.0 * n_cons / n, result.pixel_errors[-1]))
                extra = {"sums": sums, "a0": a0, "sx_sum": sx_sum,
                         "sy_sum": sy_sum}
                if random_method == "SHC":
                    extra["previousmax"] = engine.previousmax_np()
                if write_dir:
                    save_checkpoint(outdir, it, full, tavg[None], extra=extra)

        if write_dir:
            write_image(os.path.join(outdir, "aqfinal.hdf"), tavg, 0)
        result.average = tavg
        result.iterations = total_iter
        result.params = params_table(full)
        if write_dir:
            write_text_row(result.params,
                           os.path.join(outdir, "initial2Dparams.txt"))
        log.add("Finished ali2d_base")
        return result


def _share(tavg, a1: float, mesh):
    """Rank 0's average and criterion on every rank: one float64
    broadcast (float32 values pass through float64 unchanged)."""
    if mesh is None:
        return tavg, a1
    buf = broadcast_refs(np.append(np.asarray(tavg, np.float64).ravel(), a1),
                         mesh)
    return buf[:-1].reshape(tavg.shape).astype(np.float32), float(buf[-1])


def _ordered_sum(x):
    """``x[0] + x[1] + ...`` over the first axis in f32, added in order,
    as numpy adds them: numpy's own reduction on the host; on a CUDA
    device the last row of ``cumsum``, whose scan over an outer
    dimension adds in order in f32 (the CPU's ``cumsum`` adds in f64)."""
    if x.device.type == "cpu":
        return torch.from_numpy(x.numpy().sum(0))
    return x.cumsum(0)[-1]


def _even_odd_sums(data, device, start: int = 0, mesh=None) -> np.ndarray:
    """(1, 2, H, W) float32 sums of the even- and odd-indexed particles
    of ``data`` (on the device or the host), by blocks of ``PREP_BLOCK``
    on ``device``, as numpy.  ``data`` holds the particles ``start ..``,
    so the parity is the global index's.  The particles are added in
    stack order, in f32, as the JAX package's numpy sums add them
    (``_ordered_sum``), and under a ``mesh`` the running sums pass from
    rank to rank (``rank_scan``): every split of the stack over blocks
    and ranks gives one process's sums bit for bit.  (Sums in another order, or in
    f64, differ in their last bits, and the template engine's bf16
    references turn such bits into angles.)"""
    n, h, w = data.shape

    def add(acc):
        for s in range(0, n, PREP_BLOCK):
            x = torch.as_tensor(data[s:s + PREP_BLOCK], dtype=torch.float32,
                                device=device)
            for k, rows in (((start + s) % 2, x[0::2]),
                            ((start + s + 1) % 2, x[1::2])):
                acc[k] = _ordered_sum(torch.cat([acc[k][None], rows]))
        return acc

    acc = rank_scan(mesh, add, torch.zeros((2, h, w), dtype=torch.float32,
                                           device=device))
    return acc[None].cpu().numpy()
