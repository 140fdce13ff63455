"""Multireference 2D alignment, the entry point (PyTorch).

Counterpart of ``cryo_ralib_tpu/models/mref.py::mref_ali2d_tpu``: K
references, every particle searched against all of them (mirror + shift
grid), class assignment by the ccf argmax, even/odd class sums,
vanished-class reseeding from ``random.Random(rand_seed)``, per-class FSC
averaged over classes, optional CTF premultiplication with
Wiener-restored references, the ``ref_ali2d`` filter (and centering with
``center=1``), the outputs ``aqm%03d.hdf``, ``drm%03d%04d.txt`` and
``final2Dparams.txt``, and a ``checkpoint.npz`` after every iteration
that ``resume=True`` continues from.

The stack is premultiplied by its CTFs under ``CTF`` and normalised on
``device`` in blocks (``engine.prepare_stack``), into a device tensor
that the engine keeps when it fits (``parallel/batching.py``) or else
into pinned host memory, from which the engine streams it in batches
(``batch_size=`` forces a batch).  The reference update (K small images)
runs on the host.

Under a ``mesh`` (``parallel/mesh.py``) each rank aligns its block of
the stack, with global indices; the engine all-reduces the class sums
and gathers the params; a vanished class is reseeded from the rank that
holds the drawn particle (every rank draws the same numbers); rank 0
runs the FSC, the filter and the centering, writes every output file and
the checkpoint, and broadcasts the new references.  Every rank calls the
collectives in the same order: only file writes and the reference update
are guarded by the rank.
"""

from __future__ import annotations

import os
import random as _random
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import AlignConfig
from ..params import params_table
from ..ops.ctf_ops import CtfContext
from ..ops.fsc import fsc, write_fsc
from ..ops.masks import model_circle, normalize_mask
from ..io.eman_hdf import header_fits, write_hdf_stack
from ..io.star import write_text_row
from ..parallel.mesh import (StackShard, barrier, block_owner,
                             broadcast_refs, shard_range, shard_stack)
from ..utils.log import RunLogger
from ..utils.profiling import annotate
from .checkpoint import load_checkpoint, save_checkpoint
from .engine import (AlignmentEngine, plan_batch, prepare_stack,
                     resolve_device)
from .user_functions import factory


@dataclass
class MrefResult:
    params: np.ndarray            # (N, 4) header [alpha, sx, sy, mirror]
    assignments: np.ndarray       # (N,) class ids
    references: np.ndarray        # (K, H, W) final references
    class_counts: np.ndarray      # (K,) final member counts
    members: list = field(default_factory=list)  # per-class particle ids
    iterations: int = 0


def mref_ali2d(
    images,
    refs: np.ndarray,
    outdir: str | None = None,
    maskfile: np.ndarray | None = None,
    ir: int = 1,
    ou: int = -1,
    rs: int = 1,
    xr: float = 0.0,
    yr: float = 0.0,
    ts: float = 1.0,
    center: int = -1,
    maxit: int = 0,
    CTF: bool = False,
    snr: float = 1.0,
    ctf_params: dict | None = None,
    user_func_name: str = "ref_ali2d",
    rand_seed: int = 1000,
    log: RunLogger | None = None,
    resume: bool = False,
    ring_scheme: str = "cuda",
    device="cuda",
    sampler: str = "auto",
    batch_size: int | None = None,
    mesh=None,
) -> MrefResult:
    """Multireference-align ``images`` (N, H, W; numpy or tensor) against
    ``refs`` (K, H, W) on ``device`` (the GPU unless ``device="cpu"``).

    Flags as ``mref_ali2d_tpu``: ``yr < 0`` means ``yr = xr``; ``ou=-1``
    means ``nx//2 - 2``; ``maxit=0`` means 10 iterations; ``center`` is
    -1 or 0 (none) or 1 (center each reference).  ``sampler`` picks the
    search: "auto" (the CUDA kernel on a CUDA device, the plain version
    on the CPU), "kernel" or "plain".  ``ring_scheme="eman2"`` searches
    the variable-length Numrinit rings with ``ringwe`` weights, through
    the PyTorch search on either device (``sampler="kernel"`` raises
    ``ValueError`` there).  ``CTF=True`` premultiplies the particles by
    their CTFs (``ctf_params``: ``dfu`` per particle at least, see
    ``ops.ctf_ops.CtfContext``) and Wiener-restores the references with
    ``snr``.  ``batch_size`` streams the stack from the host in batches
    of that many particles (None: the planner's choice, resident where
    the stack fits the device).  ``mesh`` (a ``ParticleMesh``) runs this
    call as one rank of a data-parallel group on ``mesh.device``:
    ``images`` is the whole stack or a ``StackShard`` of the rank's
    block, every rank returns the same result, and rank 0 alone writes
    to ``outdir`` and logs.
    """
    device = resolve_device(device if mesh is None else mesh.device)
    root = mesh is None or mesh.is_root
    if outdir and root:
        os.makedirs(outdir, exist_ok=True)
    log = (log or RunLogger(outdir)) if root else RunLogger(None, quiet=True)
    write_dir = outdir if root else None
    user_func = factory[user_func_name]
    if int(center) > 1:
        raise ValueError(f"--center={int(center)} is not supported "
                         "(reference-documented values: 0, 1; -1 for the "
                         "reffree average centering)")
    # TF32 would cut the f32 semantics the port is held to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    n, ny, nx = images.shape
    if nx != ny:
        raise ValueError("images must be square")
    numref = refs.shape[0]
    last_ring = int(ou) if int(ou) != -1 else nx // 2 - 2
    max_iter = int(maxit) if int(maxit) else 10
    if yr is None or yr < 0:
        yr = xr
    ir, rs = int(ir), int(rs)
    if ir < 1 or rs < 1 or ir > last_ring:
        raise ValueError(f"invalid ring plan: ir={ir} rs={rs} ou={last_ring}")
    n_rings = len(range(ir, last_ring + 1, rs))
    cfg = AlignConfig(img_dim=nx, ring_num=n_rings, ring_len=256,
                      first_ring=ir, ring_step=rs, ring_scheme=ring_scheme,
                      shift_step=float(ts), shift_rng_x=float(xr),
                      shift_rng_y=float(yr))

    mask = maskfile if maskfile is not None else model_circle(last_ring, nx)
    mask_host = torch.as_tensor(np.asarray(mask, np.float32))
    mask_dev = mask_host.to(device)
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
        # particles: no_sigma=False (N(0,1) under the mask); refs: mean only
        if ctf_ctx is not None:
            x = ctf_ctx.premultiply_block(x, start)
        return normalize_mask(x, mask_dev, no_sigma=False)

    local, _gidx = shard_stack(images, mesh)
    start, stop = shard_range(n, mesh)
    batch = plan_batch(stop - start, numref, cfg, device, sampler, "",
                       batch_size, log=log.add,
                       ranks_on_device=1 if mesh is None
                       else mesh.ranks_on_device)
    data = prepare_stack(local, device, batch >= stop - start, prep)
    refi = normalize_mask(torch.as_tensor(np.asarray(refs, np.float32)),
                          mask_host, no_sigma=True).numpy()

    rng = _random.Random(rand_seed)
    engine = AlignmentEngine(StackShard(data, start, n), cfg,
                             n_classes=numref, device=device,
                             sampler=sampler, batch_size=batch, mesh=mesh)
    if not engine.resident:
        log.add("streaming %d particles in batches of %d"
                % (n, engine.batch))

    counts = np.zeros(numref, np.int64)
    assign = np.zeros(n, np.int64)
    members: list = [[] for _ in range(numref)]

    start_it = 0
    if resume and outdir:
        # the checkpoint that rank 0 wrote last is complete on every rank
        barrier(mesh)
        ck = load_checkpoint(outdir, rng)
        if ck is not None:
            start_it, ck_params, refi, _extra = ck
            start_it += 1
            engine.set_params(ck_params)
            log.add("resumed from checkpoint at iteration %d" % start_it)

    for it in range(start_it, max_iter):
        with annotate("mref::align_iter"):
            out = engine.iterate(refi)
        sums = out.class_sums                  # (K, 2, H, W)
        counts = out.counts
        params = engine.params_np()
        assign = params.ref_id.astype(np.int64)
        members = [list(np.nonzero(assign == j)[0]) for j in range(numref)]

        # ---- reference update on the host
        ave_fsc = None
        c_fsc = 0
        frsc = None
        new_refs = np.empty_like(refi)
        vanished = []
        if ctf_ctx is not None:
            # Wiener-restored combined averages replace the sums over the
            # counts; the FSC below still takes the raw even/odd halves
            wiener = ctf_ctx.restore(sums[:, 0] + sums[:, 1], assign)
        for j in range(numref):
            if counts[j] < 4:
                # vanished class: reseed with a random particle, sent by
                # the rank that holds it
                pick = rng.randint(0, n - 1)
                members[j] = [pick]
                owner = block_owner(pick, n, mesh)
                new_refs[j] = broadcast_refs(
                    data[pick - start].cpu().numpy() if start <= pick < stop
                    else np.zeros_like(new_refs[j]), mesh, src=owner)
                vanished.append(j)
            elif not root:
                continue
            else:
                cur = fsc(sums[j, 0], sums[j, 1], 1.0)
                if write_dir:
                    write_fsc(os.path.join(outdir, "drm%03d%04d.txt"
                                           % (it, j)), *cur)
                new_refs[j] = (wiener[j] if ctf_ctx is not None else
                               (sums[j, 0] + sums[j, 1]) / float(counts[j]))
                if ave_fsc is None:
                    ave_fsc = np.array(cur[1], np.float64)
                    c_fsc = 1
                else:
                    ave_fsc += np.asarray(cur[1])
                    c_fsc += 1
                frsc = cur
        if ave_fsc is not None and ave_fsc.sum() != 0:
            ave_fsc /= float(c_fsc)
            frsc = (frsc[0], ave_fsc, frsc[2])

        for j in range(numref if root else 0):
            filtered = (user_func([mask, center, new_refs[j], frsc])[0]
                        if frsc is not None else new_refs[j])
            new_refs[j] = normalize_mask(
                torch.as_tensor(np.asarray(filtered, np.float32)),
                mask_host, no_sigma=True).numpy()
        if write_dir:
            write_class_averages(os.path.join(outdir, "aqm%03d.hdf" % it),
                                 new_refs, counts, members, log)
        refi = broadcast_refs(new_refs, mesh)

        if write_dir:
            save_checkpoint(outdir, it, params, refi, rng=rng)
        log.add("ITERATION #%3d" % (it + 1))
        for j in range(numref):
            log.add("   group #%3d   number of particles = %7d"
                    % (j, int(counts[j])))
        if vanished:
            log.add("   reseeded vanished classes: %s" % vanished)

    # final params in header convention
    table = params_table(engine.params_np())
    if write_dir:
        write_text_row(table, os.path.join(outdir, "final2Dparams.txt"))
    log.add("Finished mref_ali2d")
    return MrefResult(params=table, assignments=assign, references=refi,
                      class_counts=counts, members=members,
                      iterations=max_iter)


def write_class_averages(path: str, refs, counts, members, log):
    """``aqm%03d.hdf``: the K references with ``ave_n`` and ``members``
    headers, in one write (the JAX driver's K ``write_image`` calls give
    the same file).  A class whose ``members`` does not fit HDF5's one
    object-header message (more than 16364 particles) is written
    without it, keeping ``ave_n``, and logged; ``final2Dparams.txt``
    carries every assignment."""
    headers = []
    for j, mem in enumerate(members):
        hdr = {"ave_n": int(counts[j]),
               "members": sorted(float(m) for m in mem)}
        if not header_fits("members", hdr["members"]):
            del hdr["members"]
            log.add("   group #%3d: %d members, more than an HDF5 header "
                    "attribute holds; %s has no members list for it"
                    % (j, len(mem), os.path.basename(path)))
        headers.append(hdr)
    write_hdf_stack(path, refs, headers)
