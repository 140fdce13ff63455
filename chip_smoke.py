#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``cryo_ralib_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU
and the CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card, its power limit and the versions;
  2. build the search kernel (csrc/search.cu, nvcc for sm_90a; eight
     instantiations: mirror or not, angle mask or not, ref group 8 or 1,
     the three ablation stages of the mirrored, unmasked one at ref group
     8 and 1, and the SHC pick's two: mirror or not, one reference) and
     the class-sum kernel
     (csrc/class_sums.cu: its two passes, the first staged in shared
     memory or not); print ptxas' registers and spills and each shape's
     launch plan (shifts per group, image staged in shared memory,
     shared memory per block);
  3. kernel vs its plain PyTorch version at 90 px / ou=36 / K=8 / xr=3
     and 160 px / ou=48 / K=4 / xr=2, 512 particles with integer and
     fractional accumulated shifts: structured stacks must give identical
     winners, pure noise may differ on at most 1% of particles, and
     then only between peaks within 1e-5 relative; peak values within
     1e-4 of the largest, decoded params within 1e-3;
  3b. the same rules for the four variants {mirror, nomirror} x {no
     mask, the --dst=15 angle mask} at K=1 (the reference-free search)
     in both geometries (rows compared on the allowed bins under a
     mask, decoded with refine=False), and for K=64 (eight ref groups in
     one launch) at 90 px on a structured stack of distinct templates;
     K=64 asymmetric_templates (near-duplicate refs) at N=512 and 16384
     under the noise rule, each refined angle within 1e-3 plus twice the
     change its 7-point fit takes from the two rows' difference;
  3c. an SNR sweep (signal variance / noise variance 1.0, 0.3, 0.1,
     0.03; unit-sigma asymmetric_templates, K=8, N=512, no CTF): kernel
     and plain under the noise rule, and the share of winners whose ref
     and mirror match the stack's known class and mirror;
  4. mref_ali2d through the kernel and through the plain search agree
     on a small stack;
  4b. ali2d_base through the kernel and through the plain search, 512
     particles, maxit=11, dst=15, with and without mirrors: at least 99%
     of particles with the same mirror and params within 1e-3;
  5. kernel and plain timed (CUDA events) at the main paths' shapes:
     K=8 and K=64 mref, K=32 (a rank's slice of K=64 in phase 13d, held
     to the plain search by the noise rule), K=1 for every variant of
     the reffree driver;
     the ablation stages of the default variant at K=8 and K=64
     (tools/torch_search_ablate.py's), printed as one JSON line;
  5b. the kernel's SHC pick (fused_search_shc) against the plain SHC
     search on the K=1 stack of phase 5, with and without mirrors, at
     previousmax 1e-23, 0.98 x each particle's exhaustive peak and 3e38:
     found and the winners equal but where a candidate's peak lies
     within 1e-5 of the threshold, values and rows within 1e-5 of the
     row's largest magnitude, out_groups the count the plain pick
     implies; timed with mirrors at each threshold (the search_shc
     record: its bound is the K=1 bound times the share of shift groups
     run at 0.98 x the peaks);
  6. the main path: mref_ali2d on 16384 synthetic 90 px particles, K=8,
     ou=36, xr=yr=3, 6 iterations, through the kernel (its launch count
     must rise by exactly 6); counts sum to N, nothing is NaN, class
     purity against the known labels >= 0.9;
  6b. mref_ali2d at K=64 (BASELINE config 4), 2 iterations: 2 launches
     (listed as search_k64), counts sum to N, nothing is NaN;
  7. the reference-free main paths on 16384 particles from one template
     (ou=36, xr=yr=3, ts=1, K=1, center=-1, dst=15): run A with mirrors
     and maxit=11 (exactly 1 masked and 10 unmasked launches), run B
     without mirrors, nomirror=True, maxit=6 (exactly 6 no-mirror
     launches), run C as B with maxit=11 (1 no-mirror masked and 10
     no-mirror launches); nothing NaN, counts sum to N, and in run A the
     last criterion is at least half the first;
  7b. one headline align_step (N=16384, K=8) broken down by stage in
     CUDA-event ms (prepare_ref_spectra, search, decode_params,
     fused_class_sums: the class-sum kernel), and the host part of a
     phase-6 mref_ali2d iteration (its seconds per iteration less
     align_step);
  7c. the class-sum kernel (csrc/class_sums.cu, fused_class_sums) at the
     main paths' shapes (N=16384 and 105,247, 90 px, K=1, 8 and 64):
     its sums against the plain route's (within 1e-12 of the largest,
     counts equal, two calls bit for bit), its ms (CUDA events) beside
     its bound (one read of the stack at 3.35 TB/s) and the plain
     route's ms (the class_sums record);
  8. the device loops: make_mref_device_loop on phase 6's stack (K=8, 6
     iterations, cutoff 0.25) and ref_free_alignment_2d on run A's stack
     (K=1, 10 iterations), each once as a main path, then timed as
     bench.py's _sustained_pps times the JAX loop (a built loop, three
     calls, the median), every timed call under
     torch.cuda.set_sync_debug_mode("error") (a host sync raises) and
     launching the search kernel exactly once per iteration; counts sum
     to N, nothing NaN, mref purity >= 0.9; s/iteration and particles/s
     printed beside mref_ali2d's;
  9. the command line on files: phase 6's stack and templates and run
     A's stack written as .mrcs (io/mrc.py), then cli.mref (--ou=36
     --xr=3 --ts=1 --maxit=6: 6 search launches) and cli.reffree
     (--dst=15 --maxit=11: 1 masked and 10 default launches); every
     output file the JAX CLI writes is there, and aqm005.hdf read back by
     the port's own HDF5 reader (no h5py) has K images, ave_n summing to
     N, members partitioning 0..N-1 and purity >= 0.9; cli.check exits 0
     and --gpu_info prints the card;
  3d. (after 3c) kernel vs plain on half rings (mode H) at N=512: K=8 and
     K=1, with and without the --dst=15 mask of the 180-degree span, and
     K=1 at one shift (SCF's rotation stage), the rules of phase 3; and
     the SNR sweep of 3c with CTF (particles seen through per-particle
     CTFs, premultiplied as --CTF does); phase 5 also compares and times
     the kernel on half rings at N=16384 (K=8, K=1, K=1 at one shift);
  10. the alignment modes at full width (16384 particles, 90 px, ou=36,
     xr=yr=3, ts=1), each between a reset and a read of the counters:
     a. ali2d_base(mode="H"), maxit=6: exactly 6 default launches; kernel
        and plain paths agree on >= 99% of 512 particles;
     b. ali2d_base(random_method="SHC"), 4 iterations: one launch of the
        kernel's SHC pick an iteration (the TPU package has no such
        kernel; the engine that ran is printed), the count of particles
        that kept
        their orientation never above N and falling, nothing NaN;
     c. ali2d_base(random_method="SCF"), 3 iterations: one K=1, one-shift
        launch per iteration; scf_align through the kernel on 512 known
        transforms of the template recovers every mirror flag;
     d. mref_ali2d(ring_scheme="eman2"), K=8, 3 iterations: no kernel
        launch (the kernel takes uniform 256-sample rings), purity >= 0.9;
     e. mref_ali2d(CTF=True) on a stack seen through per-particle CTFs,
        K=8, 6 iterations: exactly 6 launches, purity >= 0.9; and cli.mref
        --CTF --ctf_file=<a STAR file written here>: 6 launches;
     f. ali2d_base(Fourvar=True), 3 iterations: 3 launches; varf.hdf read
        back by the port's reader holds one finite, non-negative image per
        iteration, radial_variances one (H//2+1,) profile each.
  11. stacks larger than the card (90 px, K=8, ou=36, xr=yr=3, ts=1):
     a. one headline align_step (N=16384): its peak device memory
        (max_memory_allocated) beside the planner's model, which must not
        be below it nor, less the plain route's transform block that it
        charges on the card too, over twice it, and its time;
     b. 2^18 particles (8.49 GB): the planner's own pick; the engine on
        one preprocessed stack resident and streamed in 8 batches of
        32768 (8 launches per streamed iteration), s/iteration of both,
        the time to pin the stack and of the 8 uploads alone, and the
        particles whose first-iteration params differ (at most 1e-4 of
        them); then mref_ali2d, maxit=2, both ways from the host array:
        purity >= 0.9, final assignments agreeing on >= 99.99%;
     c. ali2d_base(random_method="SHC") on reffree A's stack, 2
        iterations, resident and in batches of 4096: one SHC launch an
        iteration or a batch, params and previousmax agreeing on >= 99.9%
        of particles;
     d. align_step at ring_len=128 with sampler="auto" on the card: no
        launch, the plain engine logged, winners equal to the plain
        search on the CPU; sampler="kernel" raises ValueError.
  12. after the alignment, on phase 6's stack (16384 x 90 px) and its
     mref_ali2d params, with no search launch:
     a. rot_shift2d (quadri) by blocks on the card: its CUDA-event ms and
        peak device memory beside transform_batch's on the same
        transforms; the first 2048 particles against the port on the
        CPU (atol 1e-4, pixels over 1e-5 counted), and the CPU's time;
     b. examples/torch_08_export_aligned.py from an EDA params table:
        aligned.hdf and class_avgs.hdf read back by the port's reader
        (N images, zeroed xform.align2d, assign, members), each class
        average correlating >= 0.9 with its template;
     c. io/dataset.py's HDFfile on the raw stack and the same table,
        aligned_particles() on the card: bitwise 12b's stack;
     d. TwoSDR(20, 20, 8) and MPCA(10, 10) of the aligned stack on the
        card, seconds and iterations, examples/torch_03_eda.py's k-means
        purity (not a gate); on a 2048-image stack with a separated
        spectrum at the same width the card and the CPU agree on the
        means, each column's subspace (1e-3) and the sign-aligned
        factors (1e-3 of the largest);
     e. the native MRC reader (whether it builds, and why not) held
        bitwise to numpy on the stack's .mrcs, both timed; whether the
        system's libdb is present, and where it is, a bdb: copy of run
        A's stack through cli.reffree for 2 iterations (its own main
        path: 2 launches).
  13. two ranks (torch.distributed), each a process of its own: NCCL over
     two cards where two are visible, else gloo with both ranks on
     cuda:0 (the backend is printed):
     a. mref_ali2d on phase 6's stack (16384 x 90 px, K=8, maxit=2),
        each rank reading its block of phase 9's .mrcs: iteration 1's
        winners equal one process's, the class sums within 1e-5 of their
        largest, then at least 99.9% of assignments equal and the params
        within 1e-3 where they agree; exactly one search launch per rank
        per iteration (each rank's counters); s/iteration beside one
        process's, the all-reduce's ms (CUDA events) and bytes, the params
        gather's ms;
     b. python -m torch.distributed.run --nproc_per_node 2 -m
        cryo_ralib_tpu_torch.cli.mref on phase 9's files: its
        final2Dparams.txt and aqm005.hdf members against phase 9's run by
        13a's rule, its log naming the ranks and the backend;
     c. reffree A (ali2d_base, maxit=11, dst=15) resident and streamed in
        batches of 4096 against phase 7's run (phase 4b's rule), and the
        mref device loop (6 iterations) against phase 8's; under NCCL the
        loop runs again under sync debug mode "error" (gloo stages CUDA
        tensors through the host, so the check is not made there).
     d. (after 13e) the 2-D ('dp', 'ref') mesh, make_mesh_2d(1,
        2): two ranks on the card(s) share phase 6b's stack (16384 x 90
        px) and split its K=64 blob templates, 32 each; mref_ali2d
        (maxit=2) launches the kernel exactly twice per rank, counted at
        K=32 (the wrapper's tally by variant and K, printed; the loop's
        launches at K=4 likewise), the ranks merge their winners by the
        kernel's rule; held to phase 6b's run by 13a's rule, counts
        summing to N; s/iteration beside phase 6b's, the merge's ms and
        bytes, each rank's kernel ms at K=32 with the other rank on the
        card; the mref device loop at K=8 against phase 8's; where four
        cards are visible, also (dp=2, ref=2) under NCCL with the loop
        under sync debug mode "error" (else the log says why not);
     e. mref_ali2d (maxit=2) and reffree A under SHC (2 iterations)
        through sampler="template" and "matmul" on the two ranks, against
        one process's runs on the card: no kernel launch, at least 99.9%
        of assignments equal and the params within 1e-2 where they agree
        (a rank's block is another cuBLAS shape; the largest gap printed);
     A rank that raises fails the phase (torch.multiprocessing.spawn
     re-raises it) and the run.
  14. the template engine (sampler="template", ops/template_search.py:
     the search as bf16 products on the tensor cores), no search-kernel
     launch on any of its paths:
     a. template_search on the card against itself on the CPU, 512
        structured particles with integer and fractional accumulated
        shifts: at least 99.9% of winners equal, the others' peaks within
        5e-3 relative; the share equal to the kernel's, a figure (the
        interpolation differs at fractional accumulated shifts);
     b. ms per search at N=16384 (CUDA events, mean of 3) at K=8, K=1
        and K=64, beside the
        kernel's (phase 5) and the bound (its operations at the bf16
        tensor-core peak); K=8 at column-chunk targets 2048, 4096 and
        8192 (winners held to 2048's); K=8 by stage (template build,
        window, the products alone, column fill and fold);
     c. mref_ali2d (K=8, maxit=6), reffree A under SHC (4 iterations)
        and mref under the eman2 rings (3 iterations) through it, each
        beside its phase-6/10b/10d s/iteration and held by that phase's
        rules (purity >= 0.9, SHC's nope counts);
     d. make_mref_device_loop(sampler="template"): purity >= 0.9, then
        timed as phase 8 times the kernel's loop, each call under sync
        debug mode "error";
     e. one template align_step's peak device memory against the
        planner's model (not below it, not over twice it).
  15. the FFT-shear warp and the matmul sampler (sampler="matmul":
     the polar samples as bf16 tent products), at 16384 x 90 px, K=8, no
     search-kernel launch on any of their paths:
     a. the FFT-shear class sums (class_sum_transform_mm, bf16 DFTs: the
        template and matmul steps' sums) beside the bilinear
        transform_batch + class_sum_oe, ms (CUDA events, mean of 3) and
        peak device memory (the shear's against the planner's model); the
        card against the CPU port on 512 particles (within 5e-3 of the
        largest sum);
     b. rot_shift2d(engine="shear") beside quadri in ms; card against CPU
        on 512 (1e-4);
     c. fourier_variance by the shear and the exact engine in ms, and the
        s/iteration of phase 10f (Fourvar) and 14c (template mref), whose
        variance and sums now run through the shear;
     d. the matmul search at K=8, 1 and 64 in ms, beside the kernel's
        (phase 5) and the template engine's (14b), with two bounds: the
        search's own (the kernel rows') and the formulation's (its
        products' operations at the bf16 peak against the bytes of its
        bf16 intermediate); the card's winners against the CPU port's on
        512 particles (14a's rule);
     e. mref_ali2d (K=8), reffree A, SHC and SCF (ali2d_base) and mref
        under the eman2 rings through sampler="matmul", 2 iterations
        each, beside phases 6, 7, 10b, 10c and 10d (purity >= 0.9);
     f. one matmul align_step's peak against the planner's model (not
        below it, not over twice it);
     g. reffree's iteration-0 even/odd sums in ms, equal to numpy's
        (the JAX driver's) bit for bit.
Every launch counter is set to 0 just before each main-path run (6, 6b,
7, 8, 9, 10, 11, 12, 14, 15, and 13 and 13d in each rank) and read just
after it; the kernels' record lists 13d's launches counted at K=32 as
search_k32.  The
last lines are the slice's JSON line (loop rates, stage breakdown, CLI
times, phase 13), the stage ablation's JSON line, the card, the kernels'
JSON record (with each instantiation's registers, spill bytes and shared
memory per block, and the launches of each path, the ranks' among them),
the class-sum kernel's record (its shapes' ms, bounds and plain ms, its
registers, spills and shared memory, and its launches on the main paths
of this process) and the run's verdict.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HEADLINE = dict(nx=90, ou=36, xr=3.0, k=8)
BIG_BOX = dict(nx=160, ou=48, xr=2.0, k=4)
N_CHECK = 512
N_SLICE = 16384
MAXIT = 6
K_LARGE = 64
K_SPLIT = 32     # a rank's slice of K_LARGE on the (dp=1, ref=2) mesh
N_RIB80S = 105247   # the rib80s stack of the benchmark's cells
DST = 15.0
SOURCE = "cryo_ralib_tpu_torch/csrc/search.cu"
REPLACES = "cryo_ralib_tpu/ops/fused_search.py:129"
# the TPU kernel's lines of each variant (one body, static flags)
VARIANT_REPLACES = {
    "search": REPLACES,
    "search_nomirror": "cryo_ralib_tpu/ops/fused_search.py:147",
    "search_masked": "cryo_ralib_tpu/ops/fused_search.py:162",
    "search_nomirror_masked": "cryo_ralib_tpu/ops/fused_search.py:147",
    "search_k64": "cryo_ralib_tpu/ops/fused_search.py:356",
    "search_k32": "cryo_ralib_tpu/ops/fused_search.py:356",
    "search_shc": "cryo_ralib_tpu/ops/search.py:366",
    "search_shc_nomirror": "cryo_ralib_tpu/ops/search.py:366",
}
SNRS = (1.0, 0.3, 0.1, 0.03)   # signal variance / noise variance
F32_PEAK = 67e12     # FLOP/s, H100 SXM, outside the tensor cores
HBM_RATE = 3.35e12   # bytes/s
L, F = 256, 129


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    """Fail the run (an assert would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def geometry(geom, mirror=True, mode="F"):
    from cryo_ralib_tpu_torch.config import AlignConfig

    return AlignConfig(img_dim=geom["nx"], ring_num=geom["ou"],
                       shift_step=1.0, shift_rng_x=geom["xr"],
                       shift_rng_y=geom["xr"], mirror=mirror, mode=mode)


def ptxas_table(report: str) -> dict:
    """{(NMIRR, MASK, KG, STAGE, PICK): {"registers", "spill_bytes"}} of
    the search kernel's instantiations, from nvcc's -Xptxas -v report
    (spill bytes: the spill stores)."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"search_kernelILi(\d+)ELb(\d)ELi(\d+)ELi(\d+)ELi(\d+)E",
                      line)
        if m:
            cur = out.setdefault(tuple(map(int, m.groups())), {})
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def class_sums_ptxas(report: str) -> dict:
    """{kernel: {"registers", "spill_bytes"}} of the class-sum kernel's
    two passes (pass 1 staged in shared memory or read through the
    cache), from nvcc's -Xptxas -v report."""
    names = {"chunk_sums_kernelILb1E": "chunk_sums_staged",
             "chunk_sums_kernelILb0E": "chunk_sums_cached",
             "slot_sums_kernel": "slot_sums"}
    out, cur = {}, None
    for line in report.splitlines():
        for key, name in names.items():
            if key in line:
                cur = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def search_bound(n, nx, r, s, k, n_mirr):
    """(bound_ms, bound_by) of one search: the larger of the f32
    operations the search needs over the f32 peak and its bytes (each
    input read once, each output written once) over the memory rate.
    Per particle and shift it needs r x 256 bilinear samples (8
    operations each), r forward and n_mirr x k inverse real FFTs of 256
    points (2.5 L log2 L each) and the k x r x 129 complex products (8
    operations each, both mirror channels from the same four real
    products)."""
    per_shift = (r * L * 8 + (r + n_mirr * k) * 2.5 * L * 8
                 + 8 * k * r * F)
    flops = float(n * s * per_shift)
    nbytes = (4 * n * nx * nx + 8 * n + 8 * r * L + 8 * s + 8 * k * r * F
              + 8 * L + n * 4 * (1 + L + 4))
    t_op, t_mem = flops / F32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_op, t_mem),
            "operations" if t_op >= t_mem else "bytes")


def acc_params(n, seed, dev):
    """Zero angles, accumulated shifts drawn from integer and fractional
    values."""
    from cryo_ralib_tpu_torch.params import params_from_numpy

    rng = np.random.default_rng(seed)
    acc = np.array([0.0, 1.0, -1.0, 0.5, -0.25, 0.75], np.float32)
    return params_from_numpy({
        "angle": np.zeros(n, np.float32),
        "shift_x": rng.choice(acc, n), "shift_y": rng.choice(acc, n),
        "mirror": np.zeros(n, np.int32), "ref_id": np.zeros(n, np.int32)},
        dev)


def make_case(geom, n, kind, seed, dev, mirror=True, refs=None, mode="F"):
    from cryo_ralib_tpu_torch.ops.search import prepare_ref_spectra
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      scattered_stack)

    nx = geom["nx"]
    if refs is None:
        refs = asymmetric_templates(geom["k"], nx)
    if kind == "structured":
        imgs = scattered_stack(refs, n, max_shift=1, noise=0.1, seed=seed,
                               device=dev, mirror=mirror)[0]
    else:
        rng = np.random.default_rng(seed)
        imgs = torch.as_tensor(
            rng.standard_normal((n, nx, nx), dtype=np.float32), device=dev)
    cfg = geometry(geom, mirror, mode)
    rfw = prepare_ref_spectra(torch.as_tensor(refs, device=dev), cfg)
    return cfg, imgs.contiguous(), rfw, acc_params(n, seed + 1, dev)


C2 = torch.tensor([49.0, 6.0, -21.0, -32.0, -27.0, -6.0, 31.0],
                  dtype=torch.float64)
C3 = torch.tensor([5.0, 0.0, -3.0, -4.0, -3.0, 0.0, 5.0],
                  dtype=torch.float64)


def fit_points(res):
    """(N, 7) float64: the 7 row values around the winning bin that
    decode_params' parabolic fit reads."""
    offs = torch.arange(-3, 4, device=res.best_row.device)
    cols = (res.best_aidx.long()[:, None] + offs) % L
    return torch.gather(res.best_row, 1, cols).double()


def fit_change(got, want, cfg, d, label):
    """Per particle, twice the first-order change that the 7-point fit
    (c2 / (2 c3), decode_params) takes from the two rows' difference e
    on its points: step x (172 e + |c2 / c3| x 20 e) / (2 |c3|), with
    172 and 20 the sums of |c2| and |c3| coefficients.  Prints the
    particle with the largest refined-angle difference ``d`` (its 7
    points in both, c3 and the change) and how flat the peaks are
    (|c3| / peak) by the ref that won them."""
    xk, xp = fit_points(got), fit_points(want)
    c2, c3 = xp @ C2.to(xp.device), xp @ C3.to(xp.device)
    e = (xk - xp).abs().max(1).values
    change = (cfg.angle_step * (172.0 + (c2 / c3).abs() * 20.0) * e
              / (2.0 * c3.abs()))
    flat = (c3 / xp[:, 3]).abs()
    over = d > 1e-3
    ref = want.best_ref
    i = int(d.argmax())
    log(f"  {label}: largest refined-angle difference {float(d[i]):.3e} deg "
        f"at particle {i}: 7 points kernel {xk[i].tolist()} plain "
        f"{xp[i].tolist()}, c3 {float(c3[i]):.6e}, |c3| / peak "
        f"{float(flat[i]):.3e}, first-order change from the rows "
        f"{float(change[i]):.3e} deg.  {int(over.sum())} particles over "
        f"1e-3 deg, their largest |c3| / peak "
        f"{float(flat[over].max()) if bool(over.any()) else 0.0:.3e}, "
        f"their lowest ref {int(ref[over].min()) if bool(over.any()) else -1}"
        f"; median |c3| / peak of all {float(flat.median()):.3e}, of the "
        f"particles won by refs 0-7 {float(flat[ref < 8].median()):.3e}, "
        f"by refs 8-{int(ref.max())} {float(flat[ref >= 8].median()):.3e}")
    return 2.0 * change


def compare(cfg, imgs, rfw, params, kind, label, mask=None):
    """Kernel vs plain on one input; returns max |best_val| difference.
    ``kind`` "structured" wants identical winners; "noise" lets at most
    1% differ, between peaks within 1e-5 relative; "flat" (near-duplicate
    refs with flat angular peaks) is "noise" with each refined angle
    allowed 1e-3 plus ``fit_change``, the others 1e-3.  Under an angle
    mask the rows are compared on the allowed bins (the kernel's row is
    unmasked, the plain version's masked) and the params decoded with
    refine=False."""
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops.search import decode_params

    shift_chunk = 8 if imgs.shape[0] <= 4096 else 1
    got = fs.fused_search(imgs, rfw, params, cfg, angle_mask=mask)
    want = fs.search_plain(imgs, rfw, params, cfg, shift_chunk=shift_chunk,
                           angle_mask=mask)
    torch.cuda.synchronize()
    same = torch.ones_like(got.best_ref, dtype=torch.bool)
    for f in ("best_ref", "best_sidx", "best_mirror", "best_aidx"):
        same &= getattr(got, f) == getattr(want, f)
    n_diff = int((~same).sum())
    scale = float(want.best_val.abs().max())
    err = float((got.best_val - want.best_val).abs().max())
    log(f"  {label}: {n_diff}/{imgs.shape[0]} winners differ, "
        f"max |dval| {err:.3e} (max |val| {scale:.3e})")
    if kind == "structured":
        check(n_diff == 0, f"{label}: winners differ on structured data")
    else:
        check(n_diff <= 0.01 * imgs.shape[0], f"{label}: {n_diff} differ")
        if n_diff:
            rel = ((got.best_val - want.best_val).abs()
                   / want.best_val.abs())[~same]
            log(f"  {label}: max rel peak difference among them "
                f"{float(rel.max()):.2e}")
            check(float(rel.max()) <= 1e-5, f"{label}: rel {rel.max()}")
    check(err <= 1e-4 * scale, f"{label}: best_val off by {err}")
    check(bool(torch.isfinite(got.best_row).all()), f"{label}: rows")
    if mask is not None:
        allowed = mask == 0
        check(bool(allowed[got.best_aidx.long()].all()),
              f"{label}: a masked angle bin won")
        row_err = float((got.best_row - want.best_row)[same][:, allowed]
                        .abs().max())
        check(row_err <= 1e-4 * scale, f"{label}: row off by {row_err}")
    if not cfg.mirror:
        check(int(got.best_mirror.max()) == 0, f"{label}: mirrored winner")
    refine = mask is None
    p_got = decode_params(got, params, cfg, refine=refine)
    p_want = decode_params(want, params, cfg, refine=refine)
    d = (p_got.angle - p_want.angle).abs().double()
    d = torch.where(same, torch.minimum(d, 360.0 - d), torch.zeros_like(d))
    tol = 1e-3
    if kind == "flat":
        tol = tol + fit_change(got, want, cfg, d, label)
    bad = d >= tol
    check(not bool(bad.any()), f"{label}: {int(bad.sum())} angles off, by "
          f"up to {float(d.max())}")
    for f in ("shift_x", "shift_y"):
        check(torch.equal(getattr(p_got, f)[same], getattr(p_want, f)[same]),
              f"{label}: decoded {f} differs")
    return err


def shc_candidate_peaks(imgs, rfw, params, cfg):
    """(N, M*S*K) row peaks of every SHC candidate in priority order
    (mirror, shift, ref), from the plain search's rows, four shifts at a
    time."""
    from cryo_ralib_tpu_torch.ops.ccf import (ccf_rows, ccf_spectra,
                                              ring_spectra)
    from cryo_ralib_tpu_torch.ops.polar import polar_resample
    from cryo_ralib_tpu_torch.ops.search import search_tables

    tables = search_tables(cfg, imgs.device)
    peaks = []
    for s0 in range(0, cfg.n_shifts, 4):
        grid = tables.shifts[s0:s0 + 4]
        sx = params.shift_x[:, None] + grid[None, :, 0]
        sy = params.shift_y[:, None] + grid[None, :, 1]
        orig, mirr = ccf_spectra(ring_spectra(polar_resample(
            imgs, tables.polar_coords, sx, sy)), rfw)
        peaks.append(ccf_rows(orig, mirr if cfg.mirror else None,
                              cfg.ring_len).amax(-1))
    return torch.cat(peaks, dim=2).reshape(imgs.shape[0], -1)


def compare_shc(cfg, imgs, rfw, params, pm, peaks, label):
    """The kernel's SHC pick (``fused_search_shc``, one launch) against
    ``rotational_shift_search_shc`` on the same card tensors.  ``found``
    and the winners (ref, shift, mirror) equal but where a candidate up to
    either pick has its peak within 1e-5 (relative) of ``previousmax``
    (at least 90% of particles held); values and rows within 1e-5 of the
    row's largest magnitude; angles equal but where the row's two highest
    bins lie within that of each other, and the kernel's bin a peak of
    the plain row; a particle with no pick -3e38, a zero row and zero
    indices; ``out_groups`` the count that the plain pick implies (up to
    the winner's shift group where it is unmirrored, else every group).
    Returns (max |dval| over the held particles with a pick, the share of
    a full search's shift groups the kernel ran)."""
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops.search import rotational_shift_search_shc

    n, k, s = imgs.shape[0], rfw.shape[0], cfg.n_shifts
    groups = torch.full((n,), -1, dtype=torch.int32, device=imgs.device)
    got, found = fs.fused_search_shc(imgs, rfw, params, cfg, pm,
                                     out_groups=groups)
    want, found_w = rotational_shift_search_shc(imgs, rfw, params, cfg, pm)
    torch.cuda.synchronize()
    total = peaks.shape[1]

    def prio(r, f):
        p = (r.best_mirror.long() * s + r.best_sidx.long()) * k + r.best_ref
        return torch.where(f, p, total - 1)

    upto = torch.maximum(prio(got, found), prio(want, found_w))
    near = (peaks - pm[:, None]).abs() <= 1e-5 * pm.abs()[:, None]
    near &= torch.arange(total, device=pm.device)[None] <= upto[:, None]
    ok = ~near.any(1)
    held = float(ok.float().mean())
    check(held >= 0.9, f"{label}: only {held:.4f} held away from the "
          f"threshold")
    check(torch.equal(found[ok], found_w[ok]), f"{label}: found differs")
    n_diff = 0
    for f in ("best_ref", "best_sidx", "best_mirror"):
        n_diff += int((getattr(got, f) != getattr(want, f))[ok].sum())
    check(n_diff == 0, f"{label}: {n_diff} winners differ")
    both = ok & found
    scale = want.best_row.abs().amax(1)
    dval = (got.best_val - want.best_val).abs()
    check(bool((dval <= 1e-5 * scale)[both].all()), f"{label}: values")
    drow = (got.best_row - want.best_row).abs().amax(1)
    check(bool((drow <= 1e-5 * scale)[both].all()), f"{label}: rows")
    top2 = want.best_row.topk(2, dim=1).values
    clear = both & (top2[:, 0] - top2[:, 1] > 1e-5 * scale)
    check(torch.equal(got.best_aidx[clear], want.best_aidx[clear]),
          f"{label}: angles")
    at = want.best_row.gather(1, got.best_aidx.long()[:, None])[:, 0]
    check(bool((at >= want.best_val - 1e-5 * scale)[both].all()),
          f"{label}: the kernel's angle is no peak of the plain row")
    none = ok & ~found
    check(bool((got.best_val[none] == -3.0e38).all())
          and not bool(got.best_row[none].any())
          and not any(bool(getattr(got, f)[none].any()) for f in
                      ("best_ref", "best_sidx", "best_mirror", "best_aidx")),
          f"{label}: a particle with no pick is not zero")
    group = fs.kernel_plan(cfg.ring_num, cfg.mirror, k, s, imgs.shape[1],
                           imgs.shape[2])["group"]
    full = -(-s // group)
    stop = torch.div(want.best_sidx, group, rounding_mode="floor") + 1
    implied = torch.where(found_w & (want.best_mirror == 0), stop, full)
    check(torch.equal(groups[ok].long(), implied[ok].long()),
          f"{label}: out_groups differ from the plain pick's")
    share = float(groups.double().sum()) / (n * full)
    err = float(dval[both].max()) if bool(both.any()) else 0.0
    log(f"  {label}: {held:.4f} held, {int(found.sum())}/{n} found, "
        f"max |dval| {err:.3e}, shift groups run {share:.4f} of {full} "
        f"a particle")
    return err, share


def purity(assign, truth, k):
    hits = 0
    for j in range(k):
        members = truth[assign == j]
        if members.size:
            hits += np.bincount(members, minlength=k).max()
    return hits / truth.size


def reffree_agree(a, b, label):
    """Share of particles with the same mirror and params within 1e-3 in
    two reffree results; lists the others."""
    d = np.abs(a.params[:, 0] - b.params[:, 0])
    ok = ((a.params[:, 3] == b.params[:, 3])
          & (np.minimum(d, 360.0 - d) < 1e-3)
          & (np.abs(a.params[:, 1:3] - b.params[:, 1:3]) < 1e-3).all(1))
    share = float(ok.mean())
    log(f"  {label}: {share:.4f} of particles agree; differing: "
        + "; ".join(f"#{i} kernel {a.params[i].round(3).tolist()} plain "
                    f"{b.params[i].round(3).tolist()}"
                    for i in np.nonzero(~ok)[0][:20]))
    check(share >= 0.99, f"{label}: only {share:.4f} agree")


def events_ms(fn, reps: int = 3) -> dict:
    """Mean CUDA-event ms of each stage of ``fn(mark)`` over ``reps``
    calls after a warm-up; ``fn`` calls ``mark(name)`` after each stage."""
    sums = {}
    for rep in range(reps + 1):
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        mark("start")
        fn(mark)
        torch.cuda.synchronize()
        if rep:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                sums[name] = sums.get(name, 0.0) + a.elapsed_time(b)
    return {name: v / reps for name, v in sums.items()}


def stage_breakdown(imgs, tmpl, cfg, dev) -> dict:
    """One align_step of the phase-6 shape (N particles, K=8, zero
    params), its stages in CUDA-event ms, and the whole step."""
    from cryo_ralib_tpu_torch.models.steps import align_step
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops.classavg import fused_class_sums
    from cryo_ralib_tpu_torch.ops.search import (decode_params,
                                                 prepare_ref_spectra)
    from cryo_ralib_tpu_torch.params import AlignParams

    n, k = imgs.shape[0], tmpl.shape[0]
    refs = torch.as_tensor(tmpl, device=dev)
    params = AlignParams.zeros(n, dev)
    gidx = torch.arange(n, device=dev)

    def stages(mark):
        rfw = prepare_ref_spectra(refs, cfg)
        mark("prepare_ref_spectra")
        res = fs.fused_search(imgs, rfw, params, cfg)
        mark("search")
        p = decode_params(res, params, cfg)
        mark("decode_params")
        fused_class_sums(imgs, p, k, global_index=gidx)
        mark("fused_class_sums")

    out = events_ms(stages)
    out["align_step"] = events_ms(lambda mark: (
        align_step(imgs, refs, params, gidx, None, cfg, n_classes=k),
        mark("align_step")))["align_step"]
    return out


def class_sums_phase(dev, card) -> list:
    """Phase 7c: the class-sum kernel against its plain route at the main
    paths' shapes (random params, every class in use), and both timed."""
    from cryo_ralib_tpu_torch.ops.classavg import (class_sums_plain,
                                                   fused_class_sums)
    from cryo_ralib_tpu_torch.params import params_from_numpy

    rows = []
    nx = HEADLINE["nx"]
    for n in (N_SLICE, N_RIB80S):
        gen = torch.Generator(device=dev).manual_seed(n)
        imgs = torch.randn((n, nx, nx), generator=gen, device=dev)
        gidx = torch.arange(n, device=dev)
        for k in (1, HEADLINE["k"], K_LARGE):
            rng = np.random.default_rng(n + k)
            params = params_from_numpy(
                {"angle": rng.uniform(0, 360, n).astype(np.float32),
                 "shift_x": rng.uniform(-3, 3, n).astype(np.float32),
                 "shift_y": rng.uniform(-3, 3, n).astype(np.float32),
                 "mirror": rng.integers(0, 2, n).astype(np.int32),
                 "ref_id": rng.integers(0, k, n).astype(np.int32)}, dev)
            got, counts = fused_class_sums(imgs, params, k, gidx)
            again, _ = fused_class_sums(imgs, params, k, gidx)
            want, want_counts = class_sums_plain(imgs, params, k, gidx)
            err = float((got - want).abs().max() / want.abs().max())
            label = f"class sums N={n} {nx}px K={k}"
            check(err <= 1e-12, f"{label}: {err:.3e} from the plain route")
            check(bool(torch.equal(counts, want_counts)), f"{label}: counts")
            check(bool(torch.equal(again, got)), f"{label}: two calls differ")
            ms = cuda_ms(lambda: fused_class_sums(imgs, params, k, gidx), 10)
            plain_ms = cuda_ms(
                lambda: class_sums_plain(imgs, params, k, gidx), 2)
            bound_ms = 1e3 * 4 * n * nx * nx / HBM_RATE
            rows.append({"n": n, "k": k, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": "bytes",
                         "share": bound_ms / ms, "max_rel_err": err})
            log(f"{label}: kernel {ms:.3f} ms ({100 * bound_ms / ms:.1f}% of "
                f"its bound {bound_ms:.3f} ms), plain {plain_ms:.2f} ms, "
                f"{err:.2e} from the plain route  [{card}]")
        del imgs
    return rows


def time_loop(label, run, args, n_iter: int):
    """Time a built device loop as bench.py's _sustained_pps times the
    JAX one: three calls, the median.  Each call runs under
    torch.cuda.set_sync_debug_mode("error"), so a host sync inside it
    raises, and must launch the search kernel once per iteration."""
    from cryo_ralib_tpu_torch.ops import fused_search as fs

    times = []
    for _ in range(3):
        fs.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = fs.fused_search.launches["search"]
        check(got == n_iter, f"{label}: {got} launches in a timed call, "
              f"not {n_iter}")
    return out, float(np.median(times))


def loop_line(label, seconds, n_iter, mref_s_it, card) -> dict:
    """Log and return a loop's s/iteration and particles/s, beside
    mref_ali2d's (phase 6) where given."""
    row = {"s_per_iteration": seconds / n_iter,
           "particles_per_s": N_SLICE * n_iter / seconds,
           "seconds": seconds, "iterations": n_iter}
    beside = ""
    if mref_s_it is not None:
        row["mref_ali2d_s_per_iteration"] = mref_s_it
        row["mref_ali2d_particles_per_s"] = N_SLICE / mref_s_it
        beside = (f"; mref_ali2d (phase 6) {mref_s_it:.4f} s/iteration, "
                  f"{N_SLICE / mref_s_it:.0f} particles/s")
    log(f"{label} N={N_SLICE} 90px ou=36 xr=yr=3 ts=1, {n_iter} iterations: "
        f"{row['s_per_iteration']:.4f} s/iteration, "
        f"{row['particles_per_s']:.0f} particles/s (median of 3 calls, each "
        f"under sync debug mode 'error'){beside}  [{card}]")
    return row


def loop_checks(label, params, out, k, truth):
    """Counts sum to N, nothing NaN, purity >= 0.9 against ``truth``."""
    counts = torch.bincount(params.ref_id.long(), minlength=k)
    check(int(counts.sum()) == N_SLICE, f"{label}: counts {counts}")
    check(bool(torch.isfinite(out).all())
          and bool(torch.isfinite(params.angle).all()), f"{label}: NaN")
    if truth is not None:
        pur = purity(params.ref_id.cpu().numpy(), truth, k)
        log(f"{label}: purity {pur:.4f}, counts {counts.tolist()}")
        check(pur >= 0.9, f"{label}: purity {pur}")


def quietly(fn):
    """Run ``fn`` with its standard output kept; returns (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    return res, buf.getvalue()


def cli_phase(tmp, imgs, tmpl, truth, stack_a, main_path, card) -> dict:
    """Phase 9: both alignment CLIs on .mrcs files, their outputs read
    back without h5py, cli.check and --gpu_info."""
    from cryo_ralib_tpu_torch.cli import check as cli_check
    from cryo_ralib_tpu_torch.cli import mref as cli_mref
    from cryo_ralib_tpu_torch.cli import reffree as cli_reffree
    from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf
    from cryo_ralib_tpu_torch.io.mrc import write_mrc

    k = tmpl.shape[0]
    stack, refs, stack1 = (os.path.join(tmp, name) for name in
                           ("stack.mrcs", "refs.mrcs", "stack1.mrcs"))
    write_mrc(stack, imgs.cpu().numpy())
    write_mrc(refs, tmpl)
    write_mrc(stack1, stack_a.cpu().numpy())
    # one process on one card, on a machine with more (0 = every card)
    geo = ["--ou=36", "--xr=3", "--ts=1", "--devices=1"]
    out_m, out_r = os.path.join(tmp, "mref"), os.path.join(tmp, "reffree")
    row = {}
    (rc, _), row["mref_seconds"] = main_path(
        "cli mref", lambda: quietly(lambda: cli_mref.main(
            [stack, refs, out_m, *geo, f"--maxit={MAXIT}"])),
        {"search": MAXIT})
    check(rc == 0, f"cli mref exit {rc}")
    (rc, _), row["reffree_seconds"] = main_path(
        "cli reffree", lambda: quietly(lambda: cli_reffree.main(
            [stack1, out_r, *geo, f"--dst={DST:g}", "--maxit=11"])),
        {"search": 10, "search_masked": 1})
    check(rc == 0, f"cli reffree exit {rc}")

    names = set(os.listdir(out_m))
    want = ({f"aqm{i:03d}.hdf" for i in range(MAXIT)}
            | {"final2Dparams.txt", "checkpoint.npz", "checkpoint_rng.pkl",
               "logfile.txt"})
    check(want <= names, f"cli mref: missing {sorted(want - names)}")
    check(any(n.startswith("drm") for n in names), "cli mref: no drm*.txt")
    names = set(os.listdir(out_r))
    want = ({"aqc.hdf", "aqf.hdf", "aqfinal.hdf", "initial2Dparams.txt",
             "checkpoint.npz", "logfile.txt"}
            | {f"resolution{i:03d}" for i in range(1, 12)})
    check(want <= names, f"cli reffree: missing {sorted(want - names)}")

    # the class averages, read back by the port's reader (no h5py)
    avgs, headers = read_own_hdf(os.path.join(out_m, f"aqm{MAXIT - 1:03d}.hdf"))
    check(avgs.shape == (k, imgs.shape[1], imgs.shape[2])
          and bool(np.isfinite(avgs).all()), f"aqm: {avgs.shape}")
    check(sum(h["ave_n"] for h in headers) == N_SLICE, "aqm: ave_n")
    members = [np.asarray(h["members"], np.int64) for h in headers]
    check(np.array_equal(np.sort(np.concatenate(members)),
                         np.arange(N_SLICE)), "aqm: members do not "
          "partition the stack")
    hits = sum(np.bincount(truth[m], minlength=k).max() for m in members
               if m.size)
    row["mref_purity_from_members"] = hits / N_SLICE
    check(row["mref_purity_from_members"] >= 0.9,
          f"cli mref purity {row['mref_purity_from_members']}")
    params = np.loadtxt(os.path.join(out_r, "initial2Dparams.txt"))
    final, _ = read_own_hdf(os.path.join(out_r, "aqfinal.hdf"))
    check(params.shape == (N_SLICE, 4) and np.isfinite(params).all()
          and np.isfinite(final).all(), "cli reffree outputs")
    log(f"cli mref: {row['mref_seconds']:.2f} s for {MAXIT} iterations "
        f"(stack read and outputs included), purity from aqm "
        f"members {row['mref_purity_from_members']:.4f}, ave_n "
        f"{[h['ave_n'] for h in headers]}; cli reffree: "
        f"{row['reffree_seconds']:.2f} s for 11 iterations  [{card}]")

    rc, text = quietly(lambda: cli_check.main([]))
    log("cli.check: " + " | ".join(line.strip() for line in
                                   text.splitlines()))
    check(rc == 0, f"cli.check exit {rc}")
    rc, text = quietly(lambda: cli_mref.main([stack, refs, out_m,
                                              "--gpu_info"]))
    log("cli mref --gpu_info: " + text.strip())
    check(rc == 0 and torch.cuda.get_device_name(0) in text,
          "--gpu_info does not name the card")
    return row


CTF_SCALARS = dict(apix=2.0, voltage=300.0, cs=2.7, w=0.1)
ALL_VARIANTS = ("search", "search_nomirror", "search_masked",
                "search_nomirror_masked", "search_shc", "search_shc_nomirror")
NO_LAUNCH = dict.fromkeys(ALL_VARIANTS, 0)


def ctf_params(n, seed):
    """Per-particle defocus (1.0-2.5 um, 2% astigmatism at a random
    angle) with the scalars of a 300 kV microscope at 2 A/px."""
    rng = np.random.default_rng(seed)
    dfu = rng.uniform(10000.0, 25000.0, n)
    return dict(dfu=dfu, dfv=dfu * rng.uniform(0.98, 1.02, n),
                dfang=rng.uniform(0.0, 180.0, n), **CTF_SCALARS)


def ctf_stack(tmpl, n, noise, seed, dev, max_shift=2):
    """A stack seen through per-particle CTFs: noise-free transformed
    templates multiplied by each particle's CTF in Fourier space, then
    white noise of sigma ``noise``.  Returns (images, class ids, mirrors,
    ctf_params)."""
    from cryo_ralib_tpu_torch.ops.ctf_ops import CtfContext
    from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

    clean, cls, _, _, mir = scattered_stack(tmpl, n, max_shift=max_shift,
                                            noise=0.0, seed=seed, device=dev)
    params = ctf_params(n, seed + 1)
    imgs = CtfContext(tmpl.shape[-1], params, device=dev).premultiply(clean)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    imgs += noise * torch.randn(imgs.shape, generator=gen, device=dev)
    return imgs.contiguous(), cls, mir, params


def write_star(path, params):
    """A RELION STAR file of the per-particle CTF rows of ``params``."""
    from cryo_ralib_tpu_torch.io.star import Starfile, Table

    n = len(params["dfu"])
    # DetectorPixelSize (um) and Magnification giving params["apix"]
    cols = {
        "_rlnDefocusU": params["dfu"], "_rlnDefocusV": params["dfv"],
        "_rlnDefocusAngle": params["dfang"],
        "_rlnVoltage": np.full(n, params["voltage"]),
        "_rlnSphericalAberration": np.full(n, params["cs"]),
        "_rlnAmplitudeContrast": np.full(n, params["w"]),
        "_rlnDetectorPixelSize": np.full(n, 5.0),
        "_rlnMagnification": np.full(n, 5.0 * 10000.0 / params["apix"]),
    }
    headers = list(cols)
    Starfile(headers, Table(headers, {h: np.asarray(v, np.float64)
                                      for h, v in cols.items()})).write(path)


class ListLogger:
    """A run logger that keeps its lines (for the SHC counts)."""

    def __init__(self):
        self.lines = []

    def add(self, msg):
        self.lines.append(str(msg))


def mode_line(label, what, seconds, n_iter, card, extra="") -> dict:
    row = {"s_per_iteration": seconds / n_iter,
           "particles_per_s": N_SLICE * n_iter / seconds,
           "seconds": seconds, "iterations": n_iter}
    log(f"{label}: {what} N={N_SLICE} 90px ou=36 xr=yr=3 ts=1, {n_iter} "
        f"iterations: {seconds:.2f} s, {row['s_per_iteration']:.4f} "
        f"s/iteration, {row['particles_per_s']:.0f} particles/s{extra}  "
        f"[{card}]")
    return row


def modes_phase(dev, card, main_path, imgs, tmpl, cls, stack_a, mir_a,
                tmpl1) -> dict:
    """Phase 10: the alignment modes at full width, through ali2d_base,
    mref_ali2d and cli.mref."""
    from cryo_ralib_tpu_torch.cli import mref as cli_mref
    from cryo_ralib_tpu_torch.config import AlignConfig
    from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf
    from cryo_ralib_tpu_torch.io.mrc import write_mrc
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base
    from cryo_ralib_tpu_torch.models.steps import resolve_route
    from cryo_ralib_tpu_torch.ops.scf import scf_align
    from cryo_ralib_tpu_torch.utils.log import RunLogger
    from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

    out = {}
    k = tmpl.shape[0]
    n = stack_a.shape[0]
    rf_kw = dict(ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"],
                 ts=1.0, center=-1, device=dev)
    quiet = dict(log=RunLogger(None, quiet=True))

    def finite(res, label):
        check(bool(np.isfinite(res.params).all()
                   and np.isfinite(res.average).all()
                   and np.isfinite(res.criteria).all()), f"{label}: NaN")
        check(int(res.class_counts.sum()) == n, f"{label}: counts")

    def mirror_share(res, mir):
        flip = float((res.params[:, 3] == mir).mean())
        return max(flip, 1.0 - flip)

    # ---- 10a. half rings through the kernel
    small = scattered_stack(tmpl1, N_CHECK, max_shift=2, noise=1.0, seed=4,
                            device=dev)[0]
    runs = {sampler: ali2d_base(small, maxit=MAXIT, mode="H",
                                sampler=sampler, **rf_kw, **quiet)
            for sampler in ("kernel", "plain")}
    reffree_agree(runs["kernel"], runs["plain"],
                  f"ali2d_base mode=H N={N_CHECK} maxit={MAXIT}")
    res, seconds = main_path("reffree mode H", lambda: ali2d_base(
        stack_a, maxit=MAXIT, mode="H", **rf_kw, **quiet),
        {**NO_LAUNCH, "search": MAXIT})
    finite(res, "reffree mode H")
    check(res.iterations == MAXIT, "reffree mode H: iterations")
    out["reffree_mode_h"] = mode_line(
        "10a reffree mode H", "ali2d_base(mode='H')", seconds, MAXIT, card,
        f"; mirror flags matching the truth up to a global flip "
        f"{mirror_share(res, mir_a):.4f}")

    # ---- 10b. SHC: the kernel's SHC pick, by the engine rule
    n_shc = 4
    engine = resolve_route("auto", dev, geometry(HEADLINE), "SHC").search
    lines = ListLogger()
    res, seconds = main_path("reffree SHC", lambda: ali2d_base(
        stack_a, maxit=n_shc, random_method="SHC", log=lines, **rf_kw),
        {**NO_LAUNCH, "search_shc": n_shc})
    finite(res, "reffree SHC")
    nope = [int(m.split()[1]) for m in lines.lines if m.startswith("SHC:")]
    log(f"10b reffree SHC: engine {engine!r} (the kernel's SHC pick), "
        f"particles that kept their orientation per iteration {nope}")
    check(engine == "kernel", f"SHC engine {engine}")
    check(len(nope) == n_shc and all(0 <= v <= n for v in nope)
          and nope[0] == 0, f"SHC nope counts {nope}")
    out["reffree_shc"] = mode_line(
        "10b reffree SHC", "ali2d_base(random_method='SHC')", seconds, n_shc,
        card, f"; {n_shc} SHC launches; nope {nope}")
    out["reffree_shc"]["nope"] = nope

    # ---- 10c. SCF: a K=1, one-shift kernel launch per iteration
    n_scf = 3
    cfg_h = geometry(HEADLINE, mode="H")
    known, _, _, _, mir_k = scattered_stack(tmpl1, N_CHECK, max_shift=2,
                                            noise=0.0, seed=5, device=dev)
    ref1 = torch.as_tensor(tmpl1[0], device=dev)
    got, _ = scf_align(known.contiguous(), ref1, cfg_h, sampler="kernel")
    want, _ = scf_align(known.contiguous(), ref1, cfg_h, sampler="plain")
    right = float((got.mirror.cpu().numpy() == mir_k).mean())
    same = float((got.mirror == want.mirror).float().mean())
    log(f"10c scf_align on {N_CHECK} known transforms of the template: "
        f"mirror flags right {right:.4f}; kernel and plain flags equal "
        f"{same:.4f}")
    check(right >= 0.99, f"scf_align recovers {right} of the mirror flags")
    check(same >= 0.99, f"scf_align kernel vs plain {same}")
    res, seconds = main_path("reffree SCF", lambda: ali2d_base(
        stack_a, maxit=n_scf, random_method="SCF", **rf_kw, **quiet),
        {**NO_LAUNCH, "search": n_scf})
    finite(res, "reffree SCF")
    out["reffree_scf"] = mode_line(
        "10c reffree SCF", "ali2d_base(random_method='SCF')", seconds, n_scf,
        card, f"; mirror flags matching the truth up to a global flip "
        f"{mirror_share(res, mir_a):.4f}")

    # ---- 10d. the eman2 rings: the PyTorch search, by the engine rule
    n_em = 3
    cfg_e = AlignConfig(img_dim=HEADLINE["nx"], ring_num=HEADLINE["ou"],
                        ring_scheme="eman2", shift_rng_x=HEADLINE["xr"],
                        shift_rng_y=HEADLINE["xr"])
    engine = resolve_route("auto", dev, cfg_e).search
    check(engine == "plain", f"eman2 engine {engine}")
    res, seconds = main_path("mref eman2", lambda: mref_ali2d(
        imgs, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"],
        ts=1, maxit=n_em, ring_scheme="eman2", device=dev, **quiet),
        NO_LAUNCH)
    check(bool(np.isfinite(res.params).all()
               and np.isfinite(res.references).all()), "mref eman2: NaN")
    check(int(res.class_counts.sum()) == n, "mref eman2: counts")
    pur = purity(res.assignments, cls, k)
    out["mref_eman2"] = mode_line(
        "10d mref eman2", f"mref_ali2d(ring_scheme='eman2') K={k}, maxrin "
        f"{cfg_e.ring_len}, engine {engine!r} (no kernel launch)", seconds,
        n_em, card, f"; purity {pur:.4f}")
    out["mref_eman2"]["purity"] = pur
    check(pur >= 0.9, f"mref eman2 purity {pur}")

    # ---- 10e. CTF: premultiplied particles through the kernel
    stack_c, cls_c, _, ctfp = ctf_stack(tmpl, n, 1.0, 13, dev)
    res, seconds = main_path("mref CTF", lambda: mref_ali2d(
        stack_c, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
        yr=HEADLINE["xr"], ts=1, maxit=MAXIT, CTF=True, ctf_params=ctfp,
        snr=1.0, device=dev, **quiet), {**NO_LAUNCH, "search": MAXIT})
    check(bool(np.isfinite(res.params).all()
               and np.isfinite(res.references).all()), "mref CTF: NaN")
    check(int(res.class_counts.sum()) == n, "mref CTF: counts")
    pur = purity(res.assignments, cls_c, k)
    out["mref_ctf"] = mode_line(
        "10e mref CTF", f"mref_ali2d(CTF=True) K={k}", seconds, MAXIT, card,
        f"; purity {pur:.4f}, counts {res.class_counts.tolist()}")
    out["mref_ctf"]["purity"] = pur
    check(pur >= 0.9, f"mref CTF purity {pur}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ctf_") as tmp:
        stack, refs, star = (os.path.join(tmp, name) for name in
                             ("stack.mrcs", "refs.mrcs", "particles.star"))
        write_mrc(stack, stack_c.cpu().numpy())
        write_mrc(refs, tmpl)
        write_star(star, ctfp)
        out_c = os.path.join(tmp, "mref_ctf")
        (rc, _), cli_s = main_path(
            "cli mref CTF", lambda: quietly(lambda: cli_mref.main(
                [stack, refs, out_c, "--ou=36", "--xr=3", "--ts=1",
                 f"--maxit={MAXIT}", "--CTF", f"--ctf_file={star}",
                 "--devices=1"])),
            {**NO_LAUNCH, "search": MAXIT})
        check(rc == 0, f"cli mref --CTF exit {rc}")
        _, headers = read_own_hdf(os.path.join(out_c,
                                               f"aqm{MAXIT - 1:03d}.hdf"))
        members = [np.asarray(h["members"], np.int64) for h in headers]
        hits = sum(np.bincount(cls_c[m], minlength=k).max() for m in members
                   if m.size)
        out["cli_mref_ctf"] = {"seconds": cli_s, "purity": hits / n}
        log(f"10e cli mref --CTF --ctf_file=particles.star: {cli_s:.2f} s for "
            f"{MAXIT} iterations (stack and STAR read, outputs included), "
            f"purity from aqm members {hits / n:.4f}  [{card}]")
        check(hits / n >= 0.9, f"cli mref --CTF purity {hits / n}")
    del stack_c

    # ---- 10f. Fourvar
    n_fv = 3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fv_") as tmp:
        res, seconds = main_path("reffree Fourvar", lambda: ali2d_base(
            stack_a, outdir=tmp, maxit=n_fv, Fourvar=True, **rf_kw, **quiet),
            {**NO_LAUNCH, "search": n_fv})
        varf, _ = read_own_hdf(os.path.join(tmp, "varf.hdf"))
    finite(res, "reffree Fourvar")
    nx = stack_a.shape[-1]
    check(varf.shape == (n_fv, nx, nx) and bool(np.isfinite(varf).all())
          and bool((varf >= 0).all()), f"varf.hdf {varf.shape}")
    check(len(res.radial_variances) == n_fv
          and all(r.shape == (nx // 2 + 1,) and np.isfinite(r).all()
                  for r in res.radial_variances), "radial_variances")
    out["reffree_fourvar"] = mode_line(
        "10f reffree Fourvar", "ali2d_base(Fourvar=True), outputs written",
        seconds, n_fv, card,
        f"; varf.hdf {varf.shape}, criteria "
        f"{[float('%.4g' % c) for c in res.criteria]}")
    return out


N_STREAM = 262144      # 2^18 particles of 90 px: 8.49 GB
STREAM_BATCH = 32768   # 11b's forced batch: 8 batches
STEP_MS_PR5 = 97.73    # the headline align_step before the peak cut


def mem_available() -> str:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable"):
                return line.split(":", 1)[1].strip()
    return "not reported"


def big_stack(tmpl, n, dev, seed):
    """``n`` particles like phase 6's, made on the card by blocks of
    N_SLICE and gathered into one host array; returns (images, classes)."""
    from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

    out = np.empty((n,) + tmpl.shape[1:], np.float32)
    cls = np.empty(n, np.int64)
    for i, s in enumerate(range(0, n, N_SLICE)):
        imgs, c = scattered_stack(tmpl, min(N_SLICE, n - s), max_shift=2,
                                  noise=1.0, seed=seed + i, device=dev)[:2]
        out[s:s + len(c)] = imgs.cpu().numpy()
        cls[s:s + len(c)] = c
    return out, cls


def params_differ(a, b):
    """(N,) bool: particles whose ref_id or mirror differ, or whose angle
    or shifts differ by 1e-3 or more (AlignParams of host arrays)."""
    d = np.abs(a.angle - b.angle)
    return ((a.ref_id != b.ref_id) | (a.mirror != b.mirror)
            | (np.minimum(d, 360.0 - d) >= 1e-3)
            | (np.abs(a.shift_x - b.shift_x) >= 1e-3)
            | (np.abs(a.shift_y - b.shift_y) >= 1e-3))


def streaming_phase(dev, card, main_path, imgs, tmpl, cls, stack_a) -> dict:
    """Phase 11: the peak cut (11a), a stack of 2^18 particles resident
    and streamed (11b), SHC streamed (11c) and the kernel's gate (11d)."""
    import logging

    from cryo_ralib_tpu_torch.config import AlignConfig
    from cryo_ralib_tpu_torch.models.engine import (AlignmentEngine,
                                                    host_stack, plan_batch)
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base
    from cryo_ralib_tpu_torch.models.steps import align_step, resolve_route
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops.masks import model_circle, normalize_mask
    from cryo_ralib_tpu_torch.parallel.batching import (device_memory_bytes,
                                                        step_footprint)
    from cryo_ralib_tpu_torch.params import AlignParams
    from cryo_ralib_tpu_torch.utils.log import RunLogger
    from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

    out = {"card": card}
    k, nx = tmpl.shape[0], tmpl.shape[-1]
    cfg = geometry(HEADLINE)
    quiet = dict(log=RunLogger(None, quiet=True))

    # ---- 11a. the peak cut: one headline align_step
    refs = torch.as_tensor(tmpl, device=dev)
    zeros = AlignParams.zeros(N_SLICE, dev)
    gidx = torch.arange(N_SLICE, device=dev)
    align_step(imgs, refs, zeros, gidx, None, cfg, n_classes=k)   # warm-up
    torch.cuda.synchronize()
    held = (imgs.nbytes + refs.nbytes + gidx.nbytes
            + sum(f.nbytes for f in zeros))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    align_step(imgs, refs, zeros, gidx, None, cfg, n_classes=k)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + held
    fp = step_footprint(N_SLICE, resolve_route("kernel", dev, cfg, n_refs=k),
                        cfg)
    model = fp.total
    # the planner charges the plain route's transform block on the card
    # too, where the class-sum kernel takes none of it (so that every
    # batch plan stays as it was): the rest of the model is what has to
    # stay within twice the peak
    model_rest = model - max(fp.search, fp.transform) + fp.search
    step_ms = events_ms(lambda mark: (
        align_step(imgs, refs, zeros, gidx, None, cfg, n_classes=k),
        mark("align_step")))["align_step"]
    out["peak_cut"] = {"peak_bytes": peak, "model_bytes": model,
                       "model_bytes_without_transform": model_rest,
                       "align_step_ms": step_ms}
    log(f"11a align_step N={N_SLICE} 90px K={k}: peak "
        f"{peak / 2**30:.3f} GiB (max_memory_allocated over the step, with "
        f"its images, refs and params), the planner's model "
        f"{model / 2**30:.3f} GiB (ratio {model / peak:.3f}), "
        f"{model_rest / 2**30:.3f} GiB without the transform block; step "
        f"{step_ms:.2f} ms (CUDA events, mean of 3; {STEP_MS_PR5} ms "
        f"before the cut)  [{card}]")
    check(model >= peak, f"11a: the model {model} is below the peak {peak}")
    check(model_rest <= 2 * peak, f"11a: the model {model_rest} without "
          f"the transform block is over twice the peak {peak}")

    # ---- 11b. 2^18 particles: resident, and streamed in 8 batches
    log(f"11b host memory before the phase: MemAvailable {mem_available()}")
    big, big_cls = big_stack(tmpl, N_STREAM, dev, seed=100)
    log(f"11b stack: {big.shape} float32, {big.nbytes / 1e9:.2f} GB on the "
        f"host; MemAvailable {mem_available()}")
    budget = device_memory_bytes(dev)
    picked = plan_batch(N_STREAM, resolve_route("auto", dev, cfg, n_refs=k),
                        cfg, dev, log=log)
    log(f"11b the planner, unprompted: batch {picked} "
        f"({'resident' if picked >= N_STREAM else 'streamed'}) of "
        f"{budget / 2**30:.2f} GiB usable  [{card}]")
    out["planner_batch"] = picked

    # the engine on one preprocessed stack, both ways: the first
    # iteration runs the same kernel on the same inputs and refs
    mask = torch.as_tensor(model_circle(HEADLINE["ou"], nx), device=dev)
    data = torch.empty(big.shape, dtype=torch.float32, device=dev)
    for s in range(0, N_STREAM, N_SLICE):
        data[s:s + N_SLICE] = normalize_mask(
            torch.as_tensor(big[s:s + N_SLICE], device=dev), mask)
    refs_n = normalize_mask(refs, mask, no_sigma=True).cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pinned = host_stack(data, pin=True)
    pin_s = time.perf_counter() - t0
    buf = torch.empty((STREAM_BATCH,) + big.shape[1:], device=dev)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        for s in range(0, N_STREAM, STREAM_BATCH):
            buf.copy_(pinned[s:s + STREAM_BATCH], non_blocking=True)
    side.synchronize()
    upload_s = time.perf_counter() - t0
    del buf
    log(f"11b pinning the {pinned.nbytes / 1e9:.2f} GB stack (from the card): "
        f"{pin_s:.3f} s; the 8 uploads of {STREAM_BATCH} particles alone, "
        f"no compute: {upload_s:.4f} s "
        f"({pinned.nbytes / upload_s / 1e9:.1f} GB/s)  [{card}]")

    runs = {}
    for name, bs, src in (("resident", None, data),
                          ("streamed", STREAM_BATCH, pinned)):
        eng = AlignmentEngine(src, cfg, n_classes=k, device=dev,
                              batch_size=bs)
        check(eng.resident == (bs is None), f"11b {name}: resident "
              f"{eng.resident}")
        per_it, first = [], None
        for it in range(2):
            fs.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.iterate(refs_n)
            per_it.append(time.perf_counter() - t0)
            got = fs.fused_search.launches["search"]
            want = 1 if bs is None else N_STREAM // STREAM_BATCH
            check(got == want, f"11b engine {name}: {got} launches in an "
                  f"iteration, not {want}")
            if it == 0:
                first = eng.params_np()
        runs[name] = (first, eng.params_np(), per_it)
        del eng
    diff1 = params_differ(runs["resident"][0], runs["streamed"][0])
    diff2 = params_differ(runs["resident"][1], runs["streamed"][1])
    s_res, s_str = (float(np.mean(runs[n][2])) for n in ("resident",
                                                        "streamed"))
    overhead = s_str - s_res
    verdict = ("the uploads are hidden behind the compute"
               if overhead < 0.5 * upload_s else
               "the overlap is NOT working: streamed costs resident plus "
               "the upload")
    log(f"11b engine N={N_STREAM} K={k}: s/iteration resident "
        f"{runs['resident'][2]} mean {s_res:.4f}, streamed in batches of "
        f"{STREAM_BATCH} {runs['streamed'][2]} mean {s_str:.4f} "
        f"({overhead * 1e3:+.1f} ms beside {upload_s * 1e3:.1f} ms of "
        f"uploads alone: {verdict}); iteration 1 (one preprocessed stack, "
        f"the same refs, so 0 expected): {int(diff1.sum())} particles "
        f"differ; after iteration 2: {int(diff2.sum())}  [{card}]")
    check(diff1.mean() <= 1e-4, f"11b: {int(diff1.sum())} differ after "
          "iteration 1")
    out["engine"] = {"n": N_STREAM, "batch": STREAM_BATCH,
                     "resident_s_per_iteration": s_res,
                     "streamed_s_per_iteration": s_str,
                     "pin_s": pin_s, "upload_alone_s": upload_s,
                     "differ_iteration_1": int(diff1.sum()),
                     "differ_iteration_2": int(diff2.sum())}
    del data, pinned

    # the drivers: mref_ali2d, maxit=2, from the host array
    res = {}
    for name, bs, expect in (("resident", None, 2),
                             ("streamed", STREAM_BATCH,
                              2 * N_STREAM // STREAM_BATCH)):
        lines = ListLogger()
        res[name], seconds = main_path(f"mref N={N_STREAM} {name}",
                                       lambda: mref_ali2d(
            big, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
            yr=HEADLINE["xr"], ts=1, maxit=2, device=dev, batch_size=bs,
            log=lines), {"search": expect})
        r = res[name]
        check(bool(np.isfinite(r.params).all()
                   and np.isfinite(r.references).all()), f"11b {name}: NaN")
        check(int(r.class_counts.sum()) == N_STREAM, f"11b {name}: counts")
        pur = purity(r.assignments, big_cls, k)
        streaming = [m for m in lines.lines if m.startswith("streaming")]
        log(f"11b mref_ali2d N={N_STREAM} {name}, maxit=2: {seconds:.2f} s "
            f"({seconds / 2:.3f} s/iteration, preprocessing and outputs "
            f"included), purity {pur:.4f}, counts "
            f"{r.class_counts.tolist()}; {streaming}  [{card}]")
        check(pur >= 0.9, f"11b {name}: purity {pur}")
        out[f"mref_{name}"] = {"seconds": seconds, "purity": pur}
    same = float((res["resident"].assignments
                  == res["streamed"].assignments).mean())
    log(f"11b final assignments agree on {same:.6f} of particles")
    check(same >= 0.9999, f"11b: final assignments agree on {same}")
    out["final_agreement"] = same
    del big

    # ---- 11c. SHC streamed, batches of 4096
    n_shc, shc = 2, {}
    rf_kw = dict(ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"],
                 ts=1.0, center=-1, device=dev, maxit=n_shc,
                 random_method="SHC")
    for name, bs in (("resident", None), ("streamed", 4096)):
        lines = ListLogger()
        batches = 1 if bs is None else -(-len(stack_a) // bs)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_shc_") as tmp:
            r, seconds = main_path(f"reffree SHC {name}", lambda: ali2d_base(
                stack_a, outdir=tmp, batch_size=bs, log=lines, **rf_kw),
                {**NO_LAUNCH, "search_shc": n_shc * batches})
            pm = np.load(os.path.join(tmp, "checkpoint.npz"))["x_previousmax"]
        nope = [int(m.split()[1]) for m in lines.lines if m.startswith("SHC:")]
        shc[name] = (r, pm, nope, seconds)
    (r_r, pm_r, nope_r, s_r), (r_s, pm_s, nope_s, s_s) = shc.values()
    d = np.abs(r_r.params[:, 0] - r_s.params[:, 0])
    differ = ((r_r.params[:, 3] != r_s.params[:, 3])
              | (np.minimum(d, 360.0 - d) >= 1e-3)
              | (np.abs(r_r.params[:, 1:3] - r_s.params[:, 1:3]) >= 1e-3)
              .any(1) | (np.abs(pm_r - pm_s) > 1e-4 * np.abs(pm_r)))
    log(f"11c ali2d_base SHC N={N_SLICE}, {n_shc} iterations: resident "
        f"{s_r:.2f} s, streamed in batches of 4096 {s_s:.2f} s; nope "
        f"{nope_r} / {nope_s}; {int(differ.sum())} particles differ in "
        f"params (1e-3) or previousmax (1e-4 relative)  [{card}]")
    check(differ.mean() <= 1e-3, f"11c: {int(differ.sum())} differ")
    check(len(nope_s) == n_shc
          and all(abs(a - b) <= max(1, differ.sum())
                  for a, b in zip(nope_r, nope_s)), f"11c nope {nope_s}")
    out["shc"] = {"resident_s": s_r, "streamed_s": s_s, "nope": [nope_r,
                                                                nope_s],
                  "differ": int(differ.sum())}

    # ---- 11d. the kernel's gate: ring_len=128 runs the plain search
    cfg128 = AlignConfig(img_dim=nx, ring_num=HEADLINE["ou"], ring_len=128,
                         shift_step=1.0, shift_rng_x=HEADLINE["xr"],
                         shift_rng_y=HEADLINE["xr"])
    small = scattered_stack(tmpl, N_CHECK, max_shift=2, noise=0.1, seed=60,
                            device=dev)[0].contiguous()
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    steps_log = logging.getLogger("cryo_ralib_tpu_torch.models.steps")
    steps_log.addHandler(handler)
    steps_log.setLevel(logging.INFO)
    try:
        got, _ = main_path("align_step ring_len=128", lambda: align_step(
            small, refs, AlignParams.zeros(N_CHECK, dev),
            torch.arange(N_CHECK, device=dev), None, cfg128, n_classes=k,
            sampler="auto"), NO_LAUNCH)
    finally:
        steps_log.removeHandler(handler)
    engine_lines = [r.getMessage() for r in records]
    want = align_step(small.cpu(), refs.cpu(), AlignParams.zeros(N_CHECK),
                      torch.arange(N_CHECK), None, cfg128, n_classes=k)
    p_got = AlignParams(*[f.cpu().numpy() for f in got.params])
    p_want = AlignParams(*[f.numpy() for f in want.params])
    n_diff = int(params_differ(p_got, p_want).sum())
    try:
        align_step(small, refs, AlignParams.zeros(N_CHECK, dev),
                   torch.arange(N_CHECK, device=dev), None, cfg128,
                   n_classes=k, sampler="kernel")
        raised = None
    except ValueError as err:
        raised = str(err)
    log(f"11d align_step ring_len=128 N={N_CHECK} K={k}, sampler='auto' on "
        f"the card: logged {engine_lines}; {n_diff} winners differ from the "
        f"plain search on the CPU; sampler='kernel' raised: {raised!r}")
    check(any("search engine: plain" in m for m in engine_lines),
          "11d: the engine was not logged as plain")
    check(n_diff == 0, f"11d: {n_diff} differ from the CPU")
    check(raised is not None and "gate" in raised,
          "11d: sampler='kernel' did not raise ValueError")
    out["gate"] = {"launches": 0, "differ_from_cpu": n_diff}
    return out


N_ROT_CPU = 2048       # 12a's CPU timing and card-vs-CPU check, 12d's
ROT_ATOL = 1e-4        # rot_shift2d card vs CPU (tests/test_torch_rot_shift.py)
RED_TOL = 1e-3         # subspace overlap, factors (tests/test_torch_analysis.py)


def load_example(name):
    """An example script of ``examples/`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def separated_stack(n, nx, comps, seed):
    """``n`` images ``sum_k c_ik s_k u_k v_k^T`` (orthonormal u, v, weights
    0.8^k) plus 1e-3 noise: a spectrum whose leading eigenvalues lie
    apart, so that eigenvectors are defined up to sign on any device."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((nx, comps)))[0]
    v = np.linalg.qr(rng.standard_normal((nx, comps)))[0]
    coef = rng.standard_normal((n, comps)) * 0.8 ** np.arange(comps)
    arr = (coef * u[:, None, :]).transpose(1, 0, 2) @ v.T
    arr += 1e-3 * rng.standard_normal((n, nx, nx))
    return arr.astype(np.float32)


def reduction_agree(got, want, label):
    """Card against CPU results of MPCA / TwoSDR (numpy tuples, mean
    last): means within 1e-5, every factor column's overlap within 1e-3
    of 1 (Gt's rows first aligned to At's and Bt's column signs), factors
    within 1e-3 of the largest after the sign of each column is aligned,
    energy within rtol 1e-4; returns the worst of each."""
    *mats, mean = got
    *mats_c, mean_c = want
    f, fc = mats[0], mats_c[0]
    bases = list(zip(mats[1:], mats_c[1:]))
    if len(bases) == 3:   # TwoSDR: (Gt, At, Bt)
        sa = np.sign(np.diag(bases[1][0].T @ bases[1][1]))
        sb = np.sign(np.diag(bases[2][0].T @ bases[2][1]))
        bases[0] = (np.kron(sa, sb)[:, None] * bases[0][0], bases[0][1])
    row = {"mean": float(np.abs(mean - mean_c).max()),
           "overlap": max(float(np.abs(1.0 - np.abs(np.diag(a.T @ b))).max())
                          for a, b in bases)}
    sign = np.sign((f * fc).sum(0))
    row["factors"] = float(np.abs(f * sign - fc).max() / np.abs(fc).max())
    row["energy"] = float(abs((f ** 2).sum() / (fc ** 2).sum() - 1.0))
    log(f"12d {label} card vs CPU: {json.dumps(row)}")
    check(row["mean"] <= 1e-5 and row["overlap"] <= RED_TOL
          and row["factors"] <= RED_TOL and row["energy"] <= 1e-4,
          f"12d {label}: the card and the CPU disagree {row}")
    return row


def post_alignment_phase(dev, card, tmp, imgs, tmpl, truth, mref_params,
                         mref_assign) -> dict:
    """Phase 12: after the alignment, on phase 6's stack and mref_ali2d
    params: the batch op (12a), the aligned-stack export (12b), HDFfile
    (12c), the reduction (12d) and host input (12e, the native reader)."""
    import logging
    import shutil

    from cryo_ralib_tpu_torch import native
    from cryo_ralib_tpu_torch.analysis import MPCA, TwoSDR, purity_score
    from cryo_ralib_tpu_torch.io.dataset import HDFfile
    from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf, write_hdf_stack
    from cryo_ralib_tpu_torch.io.mrc import read_mrc, write_mrc
    from cryo_ralib_tpu_torch.io.star import write_text_row
    from cryo_ralib_tpu_torch.ops.transform import (rot_shift2d,
                                                    transform_batch,
                                                    transform_block)
    from cryo_ralib_tpu_torch.params import AlignParams

    out = {"card": card}
    n, h, w = imgs.shape
    k = tmpl.shape[0]
    alpha, sx, sy = (torch.as_tensor(mref_params[:, i], dtype=torch.float32,
                                     device=dev) for i in range(3))
    mirror = torch.as_tensor(mref_params[:, 3].astype(np.int32), device=dev)

    # ---- 12a. rot_shift2d: card against the port on the CPU, its time
    # and peak beside transform_batch's (by blocks, as the step runs it)
    def rot():
        return rot_shift2d(imgs, alpha, sx, sy, mirror=mirror)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    aligned_card = rot()
    torch.cuda.synchronize()
    rot_peak = torch.cuda.max_memory_allocated()
    rot_ms = cuda_ms(rot, 3)
    rad = alpha * (np.pi / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    tb_params = AlignParams(alpha, -(sx * c - sy * s), -(sx * s + sy * c),
                            mirror, torch.zeros_like(mirror))
    block = transform_block(h, w)

    def bilinear():
        res = torch.empty_like(imgs)
        for b0 in range(0, n, block):
            sl = slice(b0, b0 + block)
            res[sl] = transform_batch(imgs[sl],
                                      AlignParams(*[f[sl] for f in tb_params]))
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bilinear()
    torch.cuda.synchronize()
    tb_peak = torch.cuda.max_memory_allocated()
    tb_ms = cuda_ms(bilinear, 3)
    cpu_args = [t[:N_ROT_CPU].cpu() for t in (imgs, alpha, sx, sy, mirror)]
    rot_shift2d(cpu_args[0][:8], *[t[:8] for t in cpu_args[1:4]],
                mirror=cpu_args[4][:8])
    t0 = time.perf_counter()
    aligned_cpu = rot_shift2d(*cpu_args[:4], mirror=cpu_args[4]).numpy()
    cpu_s = time.perf_counter() - t0
    diff = np.abs(aligned_card[:N_ROT_CPU].cpu().numpy() - aligned_cpu)
    out["rot_shift2d"] = {
        "n": n, "ms": rot_ms, "peak_gib": rot_peak / 2**30,
        "peak_above_inputs_gib": (rot_peak - base) / 2**30,
        "transform_batch_ms": tb_ms, "transform_batch_peak_gib": tb_peak / 2**30,
        "block": block, "cpu_n": N_ROT_CPU, "cpu_s": cpu_s,
        "images_per_s": n / (rot_ms / 1e3), "cpu_images_per_s": N_ROT_CPU / cpu_s,
        "card_over_cpu": (n / (rot_ms / 1e3)) / (N_ROT_CPU / cpu_s),
        "max_abs_err_vs_cpu": float(diff.max()),
        "pixels_over_1e-5": int((diff > 1e-5).sum())}
    log(f"12a rot_shift2d N={n} {h}px by blocks of {block}: {rot_ms:.2f} ms "
        f"(CUDA events, mean of 3), peak {rot_peak / 2**30:.3f} GiB "
        f"({(rot_peak - base) / 2**30:.3f} above the inputs); transform_batch "
        f"on the same transforms by the same blocks {tb_ms:.2f} ms, peak "
        f"{tb_peak / 2**30:.3f} GiB; the port on this machine's CPU at "
        f"N={N_ROT_CPU}: {cpu_s:.3f} s, so the card runs "
        f"{out['rot_shift2d']['card_over_cpu']:.1f}x the CPU's images/s; "
        f"card vs CPU max |diff| {diff.max():.3e}, "
        f"{out['rot_shift2d']['pixels_over_1e-5']} of {diff.size} pixels "
        f"over 1e-5  [{card}]")
    check(diff.max() <= ROT_ATOL, f"12a: card vs CPU {diff.max()}")

    # ---- 12b. the export (examples/torch_08_export_aligned.py) from a
    # params table in the EDA format, read back by the port's reader
    host = imgs.cpu().numpy()
    table = np.column_stack([np.arange(n), mref_params[:, :4], mref_assign])
    params_path = os.path.join(tmp, "params.txt")
    stack_path = os.path.join(tmp, "stack.hdf")
    write_text_row(table, params_path)
    write_hdf_stack(stack_path, host)
    ex = load_example("torch_08_export_aligned")
    t0 = time.perf_counter()
    a_p, sx_p, sy_p, m_p, cls_p = ex.load_params(params_path)
    aligned_path, avg_path, aligned = ex.export_aligned(
        host, a_p, sx_p, sy_p, m_p, cls_p, os.path.join(tmp, "export"),
        device=dev)
    out["export_s"] = time.perf_counter() - t0
    back, headers = read_own_hdf(aligned_path)
    check(back.shape == (n, h, w) and np.array_equal(back, aligned),
          "12b: aligned.hdf does not read back as written")
    zero = {"alpha": 0.0, "tx": 0.0, "ty": 0.0, "mirror": 0, "scale": 1.0}
    check(all(json.loads(hd["xform.align2d"]) == zero for hd in headers),
          "12b: a transform is not zeroed")
    check([hd["assign"] for hd in headers] == mref_assign.tolist(),
          "12b: assign headers")
    avgs, avg_headers = read_own_hdf(avg_path)
    check([hd["members"] for hd in avg_headers]
          == np.bincount(mref_assign, minlength=k).tolist(), "12b: members")
    corr = [float(np.corrcoef(avgs[j].ravel(), tmpl[j].ravel())[0, 1])
            for j in range(k)]
    out["class_average_corr"] = corr
    log(f"12b export of {n} particles (rot_shift2d on the card, HDF5 written "
        f"by the port): {out['export_s']:.2f} s; class averages' correlation "
        f"with their templates {[round(x, 4) for x in corr]}  [{card}]")
    check(min(corr) >= 0.9, f"12b: class average correlation {corr}")

    # ---- 12c. HDFfile on the raw stack and the same table, on the card
    t0 = time.perf_counter()
    via_hdffile = HDFfile.load(stack_path, params_path).aligned_particles()
    out["hdffile_s"] = time.perf_counter() - t0
    check(np.array_equal(via_hdffile, aligned),
          "12c: HDFfile.aligned_particles differs from the export")
    log(f"12c HDFfile.load(stack.hdf, params.txt).aligned_particles(): "
        f"{out['hdffile_s']:.2f} s, bitwise equal to 12b's stack")

    # ---- 12d. the reduction on the aligned stack, and card vs CPU on a
    # stack with a separated spectrum at the same width
    iters = []

    class Iterations(logging.Handler):
        def emit(self, record):
            iters.append(record.getMessage())

    red_log = logging.getLogger("cryo_ralib_tpu_torch.analysis.reduction")
    handler = Iterations(logging.INFO)
    red_log.addHandler(handler)
    red_log.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        f_two = TwoSDR(aligned, 20, 20, 8, device=dev)[0]
        two_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        f_mpca = MPCA(aligned, 10, 10, device=dev)[0]
        mpca_s = time.perf_counter() - t0
        eda = load_example("torch_03_eda")
        out["reduction"] = {
            "twosdr_20_20_8_s": two_s, "mpca_10_10_s": mpca_s,
            "log": list(iters),
            "kmeans_purity_twosdr": purity_score(
                truth, eda.kmeans(f_two, k, seed=0)),
            "kmeans_purity_mpca": purity_score(
                truth, eda.kmeans(f_mpca, k, seed=0))}
        log(f"12d on the aligned {n} x {h} x {w} stack on the card: "
            f"TwoSDR(20,20,8) {two_s:.3f} s, MPCA(10,10) {mpca_s:.3f} s "
            f"({'; '.join(iters)}); torch_03's k-means purity against the "
            f"stack's classes (not a gate): TwoSDR "
            f"{out['reduction']['kmeans_purity_twosdr']:.4f}, MPCA "
            f"{out['reduction']['kmeans_purity_mpca']:.4f}  [{card}]")
        sep = separated_stack(N_ROT_CPU, h, 24, seed=31)
        out["reduction"]["card_vs_cpu"] = {
            "twosdr": reduction_agree(TwoSDR(sep, 20, 20, 8, device=dev),
                                      TwoSDR(sep, 20, 20, 8, device="cpu"),
                                      f"TwoSDR(20,20,8) N={N_ROT_CPU}"),
            "mpca": reduction_agree(MPCA(sep, 10, 10, device=dev),
                                    MPCA(sep, 10, 10, device="cpu"),
                                    f"MPCA(10,10) N={N_ROT_CPU}"),
            "log": iters[2:]}
    finally:
        red_log.removeHandler(handler)

    # ---- 12e. host input: the threaded native MRC reader
    mrcs = os.path.join(tmp, "stack.mrcs")
    write_mrc(mrcs, host)
    t0 = time.perf_counter()
    by_numpy = read_mrc(mrcs, native=False)
    numpy_s = time.perf_counter() - t0
    built = native.available()
    why = ("" if built else
           f"make {'found' if shutil.which('make') else 'missing'}, "
           f"g++ {'found' if shutil.which('g++') else 'missing'}")
    out["native"] = {"built": built, "numpy_s": numpy_s}
    if built:
        t0 = time.perf_counter()
        by_native = read_mrc(mrcs, native=True)
        out["native"]["native_s"] = time.perf_counter() - t0
        check(np.array_equal(by_native, by_numpy) and np.array_equal(
            by_numpy, host), "12e: the native reader differs from numpy")
    log(f"12e native MRC reader: {'built' if built else 'not built (' + why + ')'}"
        f"; {n} x {h} x {w} .mrcs read by numpy {numpy_s:.3f} s"
        + (f", natively {out['native']['native_s']:.3f} s, bitwise equal"
           if built else ""))
    return out


def bdb_phase(tmp, stack, main_path, card) -> dict:
    """12e: whether the system's libdb is present and, where it is, a
    ``bdb:`` copy of the stack through cli.reffree (2 iterations, with
    the header write-back into the container): 2 launches."""
    from cryo_ralib_tpu_torch.cli import reffree as cli_reffree
    from cryo_ralib_tpu_torch.io import bdb

    out = {"libdb": bdb._load_libdb() is not None}
    log(f"12e libdb with the DB 1.85 API: "
        f"{'present' if out['libdb'] else 'absent, no bdb: run'}")
    if not out["libdb"]:
        return out
    spec = f"bdb:{tmp}#stack"
    bdb.write_bdb_stack(spec, stack.cpu().numpy())
    outdir = os.path.join(tmp, "reffree_bdb")
    (rc, _), out["reffree_seconds"] = main_path(
        "cli reffree bdb", lambda: quietly(lambda: cli_reffree.main(
            [spec, outdir, "--ou=36", "--xr=3", "--ts=1", "--maxit=2",
             "--header_writeback", "--devices=1"])),
        {**NO_LAUNCH, "search": 2})
    check(rc == 0, f"cli reffree on bdb: exit {rc}")
    params = np.loadtxt(os.path.join(outdir, "initial2Dparams.txt"))
    headers = bdb.read_bdb_stack(spec)[1]
    check(params.shape == (stack.shape[0], 4) and np.isfinite(params).all()
          and "xform.align2d" in headers[-1], "cli reffree on bdb: outputs")
    log(f"12e cli.reffree on a bdb: stack of {stack.shape[0]}: "
        f"{out['reffree_seconds']:.2f} s for 2 iterations, params written "
        f"back into the container  [{card}]")
    return out


# ---- phase 13: two ranks (torch.distributed), a process each
MESH_RANKS = 2
MESH_MAXIT = 2
MESH_BATCH = 4096      # 13c streamed: batches of a rank's 8192
MESH_SAMPLERS = ("template", "matmul")   # 13e
MESH_BF16_TOL = 1e-2   # 13e: params of the bf16 samplers' runs, degrees/px


def mesh_rank(rank, world, store, tmp):
    """One rank of phase 13 (a process of its own, started by
    ``torch.multiprocessing.spawn``): 13a's engine iteration and
    mref_ali2d on phase 6's stack, the all-reduce and the params gather
    timed, and 13c's reffree A resident and streamed and the mref device
    loop.  Each rank writes its launch counts and times to
    ``rank<r>.json``; rank 0 writes the gathered results to
    ``mesh.npz``."""
    from cryo_ralib_tpu_torch.models import make_mref_device_loop
    from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base
    from cryo_ralib_tpu_torch.io.mrc import read_mrc
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.params import AlignParams
    from cryo_ralib_tpu_torch.parallel.mesh import (
        StackShard, all_reduce_sums, gather_params, initialize_distributed,
        shard_range, shutdown)
    from cryo_ralib_tpu_torch.utils.log import RunLogger

    t_start = time.perf_counter()
    mesh = initialize_distributed(rank=rank, world_size=world,
                                  init_method=store, device="cuda",
                                  timeout=120)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev, quiet = mesh.device, RunLogger(None, quiet=True)
        tmpl = np.load(os.path.join(tmp, "tmpl.npy"))
        refs = np.load(os.path.join(tmp, "refs.npy"))
        k, n = tmpl.shape[0], N_SLICE
        s, e = shard_range(n, mesh)
        cfg = geometry(HEADLINE)
        out, info = {}, {"backend": mesh.backend, "device": str(dev),
                         "block": [s, e], "launches": {}, "seconds": {}}

        def run(label, fn):
            fs.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            info["seconds"][label] = time.perf_counter() - t0
            info["launches"][label] = {
                key: n_l for key, n_l in fs.fused_search.launches.items()
                if n_l}
            return res

        # ---- 13a. one engine iteration on the normalised block, then
        # mref_ali2d on the raw block
        norm = np.load(os.path.join(tmp, "norm.npy"), mmap_mode="r")
        eng = AlignmentEngine(StackShard(np.array(norm[s:e]),
                                         s, n), cfg, n_classes=k, mesh=mesh)
        it = eng.iterate(refs)
        p1 = eng.params_np()
        del eng, norm
        imgs = read_mrc(os.path.join(tmp, "stack.mrcs"),
                        indices=np.arange(s, e))

        def mref():
            return mref_ali2d(
                StackShard(imgs, s, n), tmpl, ou=HEADLINE["ou"],
                xr=HEADLINE["xr"], yr=HEADLINE["xr"], ts=1,
                maxit=MESH_MAXIT, mesh=mesh, log=quiet)

        # the first call in a fresh process pays the first use of every
        # kernel, cuFFT plan and host library (scipy's fit) on its own;
        # the second is the checked and timed main path
        run("mesh mref, first call", mref)
        res = run("mesh mref", mref)
        out.update(it1_sums=it.class_sums, it1_counts=it.counts,
                   it1_params=np.stack(p1, 1), mref_params=res.params,
                   mref_assign=res.assignments)

        # the per-iteration all-reduce (one f32 buffer of class sums, one
        # f64 of counts and scalars) and the params gather, timed
        sums = torch.zeros((k, 2, HEADLINE["nx"], HEADLINE["nx"]),
                           device=dev)
        scal = torch.zeros(k + 3, dtype=torch.float64, device=dev)
        info["allreduce_bytes"] = (sums.numel() * 4 + scal.numel() * 8)
        info["allreduce_ms"] = cuda_ms(
            lambda: all_reduce_sums(mesh, sums, scal), 20)
        prm = AlignParams.zeros(e - s, dev)
        info["gather_bytes"] = n * 5 * 4
        gather_params(prm, n, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            gather_params(prm, n, mesh)
        info["gather_ms"] = 1e3 * (time.perf_counter() - t0) / 20

        # ---- 13c. reffree A, resident and streamed, and the mref loop
        stack = read_mrc(os.path.join(tmp, "stack1.mrcs"),
                         indices=np.arange(s, e))
        for mode, batch in (("resident", None), ("streamed", MESH_BATCH)):
            r = run(f"mesh reffree A {mode}", lambda: ali2d_base(
                StackShard(stack, s, n), ou=HEADLINE["ou"],
                xr=HEADLINE["xr"], yr=HEADLINE["xr"], ts=1.0, center=-1,
                dst=DST, maxit=11, mesh=mesh, batch_size=batch, log=quiet))
            out[f"reffree_{mode}"] = r.params
        loop = make_mref_device_loop(cfg, MAXIT, k, np.full(MAXIT, 0.25),
                                     mesh=mesh)
        args = (torch.as_tensor(imgs, device=dev),
                torch.as_tensor(tmpl, device=dev),
                AlignParams.zeros(e - s, dev),
                torch.arange(s, e, device=dev), torch.ones(e - s, device=dev))
        lp, lrefs = run("mesh mref loop", lambda: loop(*args))
        # under NCCL the loop, its all-reduce included, makes no host
        # sync; under gloo a CUDA tensor is staged through the host
        info["sync_checked"] = "nccl" in mesh.backend
        if info["sync_checked"]:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loop(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        out["loop_params"] = np.stack(gather_params(lp, n, mesh), 1)
        out["loop_refs"] = lrefs.cpu().numpy()

        # ---- 13e. the template engine and the matmul sampler on the
        # ranks' blocks: mref and reffree A under SHC
        for sampler in MESH_SAMPLERS:
            r = run(f"mesh mref {sampler}", lambda: mref_ali2d(
                StackShard(imgs, s, n), tmpl, ou=HEADLINE["ou"],
                xr=HEADLINE["xr"], yr=HEADLINE["xr"], ts=1,
                maxit=MESH_MAXIT, mesh=mesh, sampler=sampler, log=quiet))
            out[f"mref_{sampler}_params"] = r.params
            out[f"mref_{sampler}_assign"] = r.assignments
            r = run(f"mesh shc {sampler}", lambda: ali2d_base(
                StackShard(stack, s, n), ou=HEADLINE["ou"],
                xr=HEADLINE["xr"], yr=HEADLINE["xr"], ts=1.0,
                random_method="SHC", maxit=MESH_MAXIT, mesh=mesh,
                sampler=sampler, log=quiet))
            out[f"shc_{sampler}_params"] = r.params
        info["rank_seconds"] = time.perf_counter() - t_start
        if mesh.is_root:
            np.savez(os.path.join(tmp, "mesh.npz"), **out)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        shutdown()


def assignments_of(outdir, it, n):
    """Each particle's class from the members headers of
    ``aqm<it>.hdf``."""
    from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf

    _, headers = read_own_hdf(os.path.join(outdir, f"aqm{it:03d}.hdf"))
    assign = np.full(n, -1, np.int64)
    for j, h in enumerate(headers):
        assign[np.asarray(h["members"], np.int64)] = j
    check((assign >= 0).all(), f"{outdir}: members do not cover the stack")
    return assign


def mesh_agree(label, params, assign, want_params, want_assign,
               params_share=1.0, tol=1e-3):
    """Phase 13's rule against one process: at least 99.9% of the
    assignments equal, and where they agree the mirrors equal and the
    params within ``tol`` (1e-3; angles on the circle), for every such
    particle or, with ``params_share`` < 1, for at least that share of
    them (the others are listed)."""
    same = assign == want_assign
    a, b = params[same], want_params[same]
    d = np.abs(a[:, 0] - b[:, 0]) % 360.0
    d = np.maximum(np.minimum(d, 360.0 - d), np.abs(a[:, 1:3] - b[:, 1:3]
                                                    ).max(1, initial=0.0))
    ok = (d < tol) & (a[:, 3] == b[:, 3])
    rows = np.nonzero(same)[0]
    log(f"  {label}: {same.mean():.5f} of assignments equal to one "
        f"process's; where equal, {int((~ok).sum())} particle(s) differ "
        f"(mirror, or params by {tol:g} or more): "
        + "; ".join(f"#{rows[i]} {a[i].round(3).tolist()} against "
                    f"{b[i].round(3).tolist()}"
                    for i in np.nonzero(~ok)[0][:10])
        + f"; the others within {float(d[ok].max(initial=0.0)):.2e}"
        + f"; the largest gap {float(d.max(initial=0.0)):.2e}")
    check(same.mean() >= 0.999, f"{label}: {same.mean():.5f} equal")
    check(ok.mean() >= params_share if ok.size else True,
          f"{label}: {int((~ok).sum())} particles' params differ")
    return float(same.mean())


def mesh_phase(dev, card, tmp, imgs, tmpl, stack_a, reffree_a, loop_params,
               launches) -> dict:
    """Phase 13: two ranks, a process each (NCCL over two cards where two
    are visible, else gloo with both on cuda:0).  13a mref_ali2d on phase
    6's stack against one process; 13b cli.mref under torchrun on phase
    9's files against phase 9's run; 13c reffree A resident and streamed
    against phase 7's run, and the mref device loop against phase 8's;
    13e mref and reffree A under SHC through the template engine and the
    matmul sampler against one process's runs made here."""
    import torch.multiprocessing as mp

    from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base
    from cryo_ralib_tpu_torch.ops.masks import model_circle, normalize_mask
    from cryo_ralib_tpu_torch.utils.log import RunLogger

    t_phase = time.perf_counter()
    n_dev = torch.cuda.device_count()
    want_backend = "cpu:gloo,cuda:nccl" if n_dev >= MESH_RANKS else "gloo"
    log(f"13: {MESH_RANKS} ranks on {min(n_dev, MESH_RANKS)} card(s) of "
        f"{n_dev} visible, backend {want_backend}"
        + ("" if n_dev >= MESH_RANKS else " (both ranks on cuda:0)"))
    cfg = geometry(HEADLINE)
    k = tmpl.shape[0]
    mask = torch.as_tensor(model_circle(HEADLINE["ou"], HEADLINE["nx"]),
                           device=dev)
    norm = torch.cat([normalize_mask(imgs[i:i + 2048], mask, no_sigma=False)
                      for i in range(0, N_SLICE, 2048)])
    refs = normalize_mask(torch.as_tensor(tmpl, device=dev), mask,
                          no_sigma=True).cpu().numpy()
    np.save(os.path.join(tmp, "norm.npy"), norm.cpu().numpy())
    np.save(os.path.join(tmp, "tmpl.npy"), tmpl)
    np.save(os.path.join(tmp, "refs.npy"), refs)
    # one process at the same maxit, and its first engine iteration
    eng = AlignmentEngine(norm, cfg, n_classes=k, device=dev)
    one_it = eng.iterate(refs)
    one_p = np.stack(eng.params_np(), 1)
    del eng, norm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = mref_ali2d(imgs, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
                     yr=HEADLINE["xr"], ts=1, maxit=MESH_MAXIT, device=dev,
                     log=RunLogger(None, quiet=True))
    torch.cuda.synchronize()
    one_s_it = (time.perf_counter() - t0) / MESH_MAXIT
    quiet = RunLogger(None, quiet=True)
    one_bf16 = {}
    for sampler in MESH_SAMPLERS:
        one_bf16["mref", sampler] = mref_ali2d(
            imgs, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
            yr=HEADLINE["xr"], ts=1, maxit=MESH_MAXIT, device=dev,
            sampler=sampler, log=quiet)
        one_bf16["shc", sampler] = ali2d_base(
            stack_a, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
            yr=HEADLINE["xr"], ts=1.0, random_method="SHC",
            maxit=MESH_MAXIT, device=dev, sampler=sampler, log=quiet)

    t0 = time.perf_counter()
    mp.spawn(mesh_rank, args=(MESH_RANKS, "file://" + os.path.join(
        tmp, "store"), tmp), nprocs=MESH_RANKS, join=True)
    spawn_s = time.perf_counter() - t0
    got = dict(np.load(os.path.join(tmp, "mesh.npz")))
    infos = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(MESH_RANKS)]
    row = {"ranks": MESH_RANKS, "cards": min(n_dev, MESH_RANKS),
           "backend": infos[0]["backend"], "spawn_seconds": spawn_s}
    for r, info in enumerate(infos):
        check(info["backend"] == want_backend,
              f"rank {r}: backend {info['backend']}, not {want_backend}")
        check(info["device"] == f"cuda:{r % n_dev}",
              f"rank {r} on {info['device']}")
        log(f"13 rank {r} on {info['device']}, particles "
            f"{info['block'][0]}..{info['block'][1] - 1}: launches "
            f"{info['launches']}; {info['rank_seconds']:.2f} s in the rank")
        for label, counts in info["launches"].items():
            for variant, n_l in counts.items():
                launches.setdefault(variant, {})[f"{label} rank {r}"] = n_l
        for label in ("mesh mref, first call", "mesh mref"):
            check(info["launches"][label] == {"search": MESH_MAXIT},
                  f"rank {r}: {label} launches {info['launches'][label]}, "
                  "not one per iteration")
        check(info["launches"]["mesh mref loop"] == {"search": MAXIT},
              f"rank {r}: mesh mref loop launches")
        for mode in ("resident", "streamed"):
            want = {"search": 10, "search_masked": 1}
            if mode == "streamed":
                want = {"search": 20, "search_masked": 2}
            check(info["launches"][f"mesh reffree A {mode}"] == want,
                  f"rank {r}: reffree A {mode} launches "
                  f"{info['launches'][f'mesh reffree A {mode}']}")
        for sampler in MESH_SAMPLERS:
            for what in ("mref", "shc"):
                check(info["launches"][f"mesh {what} {sampler}"] == {},
                      f"rank {r}: mesh {what} {sampler} launched the kernel")

    # ---- 13a against one process
    check(np.array_equal(got["it1_params"][:, 3:], one_p[:, 3:]),
          "13a: iteration 1's winners (class, mirror) differ")
    d = np.abs(got["it1_params"][:, 0] - one_p[:, 0]) % 360.0
    it1_angle = float(np.minimum(d, 360.0 - d).max())
    check(np.array_equal(got["it1_counts"], one_it.counts), "13a: counts")
    rel = float(np.abs(got["it1_sums"] - one_it.class_sums).max()
                / np.abs(one_it.class_sums).max())
    log(f"13a iteration 1: winners equal, angles within {it1_angle:.2e}, "
        f"class sums within {rel:.2e} of their largest")
    check(it1_angle < 1e-4, f"13a: iteration 1's angles differ by {it1_angle}")
    check(rel <= 1e-5, f"13a: class sums differ by {rel:.3e} relative")
    row["mref_assign_equal"] = mesh_agree(
        f"13a mref_ali2d maxit={MESH_MAXIT}", got["mref_params"],
        got["mref_assign"], one.params, one.assignments)
    info = infos[0]
    mesh_s_it = info["seconds"]["mesh mref"] / MESH_MAXIT
    cold_s_it = info["seconds"]["mesh mref, first call"] / MESH_MAXIT
    row.update(s_per_iteration=mesh_s_it,
               first_call_s_per_iteration=cold_s_it,
               one_process_s_per_iteration=one_s_it,
               allreduce_ms=info["allreduce_ms"],
               allreduce_bytes=info["allreduce_bytes"],
               gather_ms=info["gather_ms"], gather_bytes=info["gather_bytes"])
    log(f"13a mref_ali2d N={N_SLICE} K={k} on {MESH_RANKS} ranks: "
        f"{mesh_s_it:.4f} s/iteration ({cold_s_it:.4f} in a rank's first "
        f"call) against {one_s_it:.4f} in one process;"
        f" all-reduce {info['allreduce_ms']:.3f} ms for "
        f"{info['allreduce_bytes']} bytes (CUDA events, mean of 20), params "
        f"gather {info['gather_ms']:.3f} ms for {info['gather_bytes']} bytes "
        f"(host clock, mean of 20)  [{card}]")

    # ---- 13b. cli.mref under torchrun on phase 9's files
    out_b = os.path.join(tmp, "mref_torchrun")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(MESH_RANKS), "-m",
         "cryo_ralib_tpu_torch.cli.mref", os.path.join(tmp, "stack.mrcs"),
         os.path.join(tmp, "refs.mrcs"), out_b, f"--ou={HEADLINE['ou']}",
         f"--xr={HEADLINE['xr']:g}", "--ts=1", f"--maxit={MAXIT}"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    row["torchrun_seconds"] = time.perf_counter() - t0
    check(proc.returncode == 0, "13b torchrun cli.mref exit "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    with open(os.path.join(out_b, "logfile.txt")) as f:
        text = f.read()
    check(f"{MESH_RANKS} ranks, backend {want_backend}" in text,
          "13b: the log does not name the ranks and the backend")
    out_m = os.path.join(tmp, "mref")
    row["torchrun_assign_equal"] = mesh_agree(
        f"13b torchrun cli.mref maxit={MAXIT} against phase 9's cli.mref",
        np.loadtxt(os.path.join(out_b, "final2Dparams.txt")),
        assignments_of(out_b, MAXIT - 1, N_SLICE),
        np.loadtxt(os.path.join(out_m, "final2Dparams.txt")),
        assignments_of(out_m, MAXIT - 1, N_SLICE), params_share=0.999)
    log(f"13b torchrun --nproc_per_node {MESH_RANKS} cli.mref: "
        f"{row['torchrun_seconds']:.2f} s (two processes' start, the stack "
        f"read by blocks and the outputs included)  [{card}]")

    # ---- 13c. reffree A on two ranks, and the mref device loop
    # (phase 4b's rule for two reffree runs that differ by rounding: at
    # least 99% of particles with the same mirror and params within 1e-3)
    for mode in ("resident", "streamed"):
        params = got[f"reffree_{mode}"]
        d = np.abs(params[:, 0] - reffree_a.params[:, 0]) % 360.0
        ok = ((params[:, 3] == reffree_a.params[:, 3])
              & (np.minimum(d, 360.0 - d) < 1e-3)
              & (np.abs(params[:, 1:3] - reffree_a.params[:, 1:3])
                 < 1e-3).all(1))
        row[f"reffree_{mode}_agree"] = float(ok.mean())
        seconds = infos[0]["seconds"][f"mesh reffree A {mode}"]
        log(f"13c reffree A on {MESH_RANKS} ranks, {mode}"
            + (f" (batches of {MESH_BATCH})" if mode == "streamed" else "")
            + f": {ok.mean():.5f} of particles with phase 7's mirror and "
            f"params within 1e-3; {seconds:.2f} s for 11 iterations  [{card}]")
        check(ok.mean() >= 0.99, f"13c reffree A {mode}: {ok.mean()}")
    lp = np.stack([f.cpu().numpy() for f in loop_params], 1)
    row["mref_loop_assign_equal"] = float(
        (got["loop_params"][:, 4] == lp[:, 4]).mean())
    log(f"13c mref device loop on {MESH_RANKS} ranks, {MAXIT} iterations: "
        f"{row['mref_loop_assign_equal']:.5f} of assignments equal to "
        f"phase 8's; the sync-debug check "
        + ("ran (NCCL): no host sync" if infos[0]["sync_checked"] else
           "does not apply under gloo, which stages CUDA tensors through "
           "the host"))
    check(row["mref_loop_assign_equal"] >= 0.999, "13c mref loop assignments")

    # ---- 13e. the bf16 samplers on two ranks against one process: a
    # rank's block is another cuBLAS shape, summed in another order, and
    # the bf16 rows of a flat peak turn that into angles
    for sampler in MESH_SAMPLERS:
        want = one_bf16["mref", sampler]
        row[f"mref_{sampler}_assign_equal"] = mesh_agree(
            f"13e mref_ali2d sampler={sampler} maxit={MESH_MAXIT}",
            got[f"mref_{sampler}_params"], got[f"mref_{sampler}_assign"],
            want.params, want.assignments, tol=MESH_BF16_TOL)
        want = one_bf16["shc", sampler]
        params = got[f"shc_{sampler}_params"]
        ones = np.zeros(N_SLICE, np.int64)
        row[f"shc_{sampler}_agree"] = mesh_agree(
            f"13e reffree A SHC sampler={sampler} maxit={MESH_MAXIT}",
            params, ones, want.params, ones, params_share=0.999,
            tol=MESH_BF16_TOL)
        for what in ("mref", "shc"):
            row[f"{what}_{sampler}_seconds"] = infos[0]["seconds"][
                f"mesh {what} {sampler}"]
        log(f"13e sampler={sampler} on {MESH_RANKS} ranks: mref "
            f"{row[f'mref_{sampler}_seconds']:.2f} s, SHC "
            f"{row[f'shc_{sampler}_seconds']:.2f} s for {MESH_MAXIT} "
            f"iterations, no kernel launch  [{card}]")
    row["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13: {row['seconds']:.1f} s  [{card}]")
    return row

# ---- phase 13d: the 2-D ('dp', 'ref') mesh, the references split
MESH2D_LAYOUTS = ((1, 2), (2, 2))   # (dp, ref); (2, 2) where 4 cards are
MESH2D_MAXIT = 2


def mesh2d_rank(rank, world, store, tmp, stack64, layout):
    """One rank of phase 13d (a process of its own, started by
    ``torch.multiprocessing.spawn``) on ``make_mesh_2d(*layout)``:
    mref_ali2d at K=64 on phase 6b's stack, each rank searching its
    slice of the references, timed after a first call; the merge and
    the kernel at the rank's slice, timed with the other ranks on the
    card; the mref device loop at K=8 on phase 6's stack, under sync
    debug mode "error" where NCCL carries the collectives.  Each rank
    writes ``rank2d<r>.json``; rank 0 writes ``mesh2d.npz``."""
    from cryo_ralib_tpu_torch.models import make_mref_device_loop
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.io.mrc import read_mrc
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops.search import (merge_ref_slices,
                                                 prepare_ref_spectra)
    from cryo_ralib_tpu_torch.params import AlignParams
    from cryo_ralib_tpu_torch.parallel import make_mesh_2d
    from cryo_ralib_tpu_torch.parallel.mesh import (
        StackShard, barrier, gather_params, initialize_distributed,
        ref_reduce, ref_slice, shard_range, shutdown)
    from cryo_ralib_tpu_torch.utils.log import RunLogger

    initialize_distributed(rank=rank, world_size=world, init_method=store,
                           device="cuda", timeout=120)
    try:
        mesh = make_mesh_2d(*layout)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev, quiet = mesh.device, RunLogger(None, quiet=True)
        tmpl64 = np.load(os.path.join(tmp, "tmpl64.npy"))
        k, n = tmpl64.shape[0], N_SLICE
        s, e = shard_range(n, mesh)
        k0, k1 = ref_slice(k, mesh)
        cfg = geometry(HEADLINE)
        out = {}
        info = {"backend": mesh.backend, "device": str(dev),
                "dp_rank": mesh.dp_rank, "ref_rank": mesh.ref_rank,
                "block": [s, e], "slice": [k0, k1], "launches": {},
                "seconds": {}}

        def run(label, fn):
            fs.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            info["seconds"][label] = time.perf_counter() - t0
            # by variant and K: a rank must launch at its slice's K
            info["launches"][label] = {
                f"{key} K={k_l}": n_l
                for (key, k_l), n_l in fs.fused_search.launches_by_k.items()}
            return res

        local = np.array(np.load(stack64, mmap_mode="r")[s:e])

        def mref():
            return mref_ali2d(
                StackShard(local, s, n), tmpl64, ou=HEADLINE["ou"],
                xr=HEADLINE["xr"], yr=HEADLINE["xr"], ts=1,
                maxit=MESH2D_MAXIT, mesh=mesh, log=quiet)

        run("mesh2d mref, first call", mref)
        res = run("mesh2d mref", mref)
        out.update(mref_params=res.params, mref_assign=res.assignments,
                   mref_counts=res.class_counts)

        # the kernel at the rank's slice and the merge of its winners,
        # every rank at once (they share the card where they share it)
        x = torch.as_tensor(local, device=dev)
        rfw = prepare_ref_spectra(torch.as_tensor(tmpl64[k0:k1], device=dev),
                                  cfg)
        prm = AlignParams.zeros(e - s, dev)
        barrier(mesh)
        info["kernel_ms"] = cuda_ms(lambda: fs.fused_search(x, rfw, prm,
                                                             cfg), 3)
        best = fs.fused_search(x, rfw, prm, cfg)

        def merge():
            return merge_ref_slices(best, k0, cfg.n_shifts, k,
                                    lambda t, op: ref_reduce(mesh, t, op))

        merge()
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            merge()
        torch.cuda.synchronize()
        info["merge_ms"] = 1e3 * (time.perf_counter() - t0) / 10
        # the three reductions' payloads: f32 values, int64 priorities,
        # f32 rows of L
        info["merge_bytes"] = (e - s) * (4 + 8 + 4 * L)
        del x, best

        imgs = read_mrc(os.path.join(tmp, "stack.mrcs"),
                        indices=np.arange(s, e))
        tmpl = np.load(os.path.join(tmp, "tmpl.npy"))
        loop = make_mref_device_loop(cfg, MAXIT, tmpl.shape[0],
                                     np.full(MAXIT, 0.25), mesh=mesh)
        args = (torch.as_tensor(imgs, device=dev),
                torch.as_tensor(tmpl, device=dev),
                AlignParams.zeros(e - s, dev),
                torch.arange(s, e, device=dev), torch.ones(e - s, device=dev))
        lp, _ = run("mesh2d mref loop", lambda: loop(*args))
        info["sync_checked"] = "nccl" in mesh.backend
        if info["sync_checked"]:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loop(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        out["loop_params"] = np.stack(gather_params(lp, n, mesh), 1)
        if mesh.is_root:
            np.savez(os.path.join(tmp, "mesh2d.npz"), **out)
        with open(os.path.join(tmp, f"rank2d{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        shutdown()


def mesh2d_phase(card, tmp, stack64, tmpl64, one64, one64_s_it,
                 loop_params, launches, one_label="phase 6b") -> dict:
    """Phase 13d: mref_ali2d at K=64 on the 2-D mesh (dp=1, ref=2), two
    ranks on the card(s), each searching 32 references through the
    kernel, against phase 6b's one-process run; the mref device loop at
    K=8 against phase 8's; (dp=2, ref=2) under NCCL where four cards are
    visible.  ``stack64``: phase 6b's stack as a .npy file; ``tmp``
    holds phase 9's stack.mrcs and phase 13's tmpl.npy; ``one_label``
    names the one-process run that ``one64_s_it`` timed."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    n_dev = torch.cuda.device_count()
    np.save(os.path.join(tmp, "tmpl64.npy"), tmpl64)
    rows = {}
    lp_one = np.stack([f.cpu().numpy() for f in loop_params], 1)
    for dp, ref in MESH2D_LAYOUTS:
        world, tag = dp * ref, f"{dp}x{ref}"
        if dp > 1 and n_dev < world:
            log(f"13d (dp={dp}, ref={ref}) did not run: it needs {world} "
                f"cards for NCCL with one rank on each, and {n_dev} "
                "is visible")
            continue
        want_backend = "cpu:gloo,cuda:nccl" if n_dev >= world else "gloo"
        log(f"13d: {world} ranks as (dp={dp}, ref={ref}) on "
            f"{min(n_dev, world)} card(s), backend {want_backend}")
        t0 = time.perf_counter()
        mp.spawn(mesh2d_rank, args=(world, "file://" + os.path.join(
            tmp, f"store2d_{tag}"), tmp, stack64, (dp, ref)), nprocs=world,
            join=True)
        spawn_s = time.perf_counter() - t0
        got = dict(np.load(os.path.join(tmp, "mesh2d.npz")))
        infos = [json.load(open(os.path.join(tmp, f"rank2d{r}.json")))
                 for r in range(world)]
        k = tmpl64.shape[0]
        per = k // ref
        for r, info in enumerate(infos):
            check(info["backend"] == want_backend,
                  f"13d rank {r}: backend {info['backend']}")
            check((info["dp_rank"], info["ref_rank"]) == (r // ref, r % ref),
                  f"13d rank {r}: layout {info['dp_rank'], info['ref_rank']}")
            check(info["slice"] == [per * (r % ref), per * (r % ref + 1)],
                  f"13d rank {r}: reference slice {info['slice']}")
            for label in ("mesh2d mref, first call", "mesh2d mref"):
                check(info["launches"][label]
                      == {f"search K={per}": MESH2D_MAXIT},
                      f"13d rank {r}: {label} launches "
                      f"{info['launches'][label]}, not {MESH2D_MAXIT} at "
                      f"K={per}")
            loop_k = HEADLINE["k"] // ref
            check(info["launches"]["mesh2d mref loop"]
                  == {f"search K={loop_k}": MAXIT},
                  f"13d rank {r}: mref loop launches "
                  f"{info['launches']['mesh2d mref loop']}, not {MAXIT} at "
                  f"K={loop_k}")
            log(f"13d rank {r} (dp_rank {info['dp_rank']}, ref_rank "
                f"{info['ref_rank']}) on {info['device']}: particles "
                f"{info['block'][0]}..{info['block'][1] - 1}, references "
                f"{info['slice'][0]}..{info['slice'][1] - 1}; launches "
                f"by variant and K {info['launches']}; "
                f"kernel at K={per} {info['kernel_ms']:.2f} ms with the "
                f"other ranks on the card; merge {info['merge_ms']:.3f} ms "
                f"for {info['merge_bytes']} bytes  [{card}]")
            # the K=32 record takes the launches counted at K=32; the
            # loop's K=4 launches are checked above and match no record's
            # shape
            launches.setdefault(f"search_k{per}", {})[
                f"mesh2d {tag} mref K={k} rank {r}"] = (
                info["launches"]["mesh2d mref"][f"search K={per}"])
        check(int(got["mref_counts"].sum()) == N_SLICE,
              f"13d {tag}: counts {got['mref_counts']}")
        check(bool(np.isfinite(got["mref_params"]).all()), f"13d {tag}: NaN")
        row = {"dp": dp, "ref": ref, "backend": infos[0]["backend"],
               "spawn_seconds": spawn_s}
        row["mref_assign_equal"] = mesh_agree(
            f"13d {tag} mref_ali2d K={k} maxit={MESH2D_MAXIT} against phase "
            "6b", got["mref_params"], got["mref_assign"], one64.params,
            one64.assignments)
        row["loop_assign_equal"] = float(
            (got["loop_params"][:, 4] == lp_one[:, 4]).mean())
        check(row["loop_assign_equal"] >= 0.999,
              f"13d {tag} mref loop assignments {row['loop_assign_equal']}")
        info = infos[0]
        s_it = info["seconds"]["mesh2d mref"] / MESH2D_MAXIT
        row.update(
            s_per_iteration=s_it,
            first_call_s_per_iteration=(
                info["seconds"]["mesh2d mref, first call"] / MESH2D_MAXIT),
            one_process_s_per_iteration=one64_s_it,
            kernel_ms=[i["kernel_ms"] for i in infos],
            merge_ms=[i["merge_ms"] for i in infos],
            merge_bytes=info["merge_bytes"],
            sync_checked=info["sync_checked"])
        log(f"13d {tag} mref_ali2d N={N_SLICE} K={k}: {s_it:.4f} "
            f"s/iteration ({row['first_call_s_per_iteration']:.4f} in a "
            f"rank's first call) against {one64_s_it:.4f} in one process "
            f"({one_label}); merge {max(row['merge_ms']):.3f} ms and "
            f"{row['merge_bytes']} bytes a rank per iteration (host clock, "
            f"mean of 10); kernel at K={per} "
            + ", ".join(f"{m:.2f}" for m in row["kernel_ms"])
            + f" ms by rank (CUDA events, mean of 3); mref loop K=8 "
            f"{row['loop_assign_equal']:.5f} of assignments equal to phase "
            f"8's; the sync-debug check "
            + ("ran (NCCL): no host sync" if info["sync_checked"] else
               "does not apply under gloo, which stages CUDA tensors "
               "through the host") + f"  [{card}]")
        rows[tag] = row
    rows["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13d: {rows['seconds']:.1f} s  [{card}]")
    return rows


# ---- phase 14: the template engine (sampler="template")
BF16_PEAK = 989e12   # FLOP/s, H100 SXM tensor cores, dense bf16
CHUNK_TARGETS = (2048, 4096, 8192)


def template_bound(n, cfg, k):
    """(bound_ms, bound_by) of one template search: the larger of its
    2 x N x Wpx x C operations (C = mirrors x shifts x K x 256 columns)
    over the bf16 tensor-core peak and its bytes (the images, the ref
    spectra and the splat spectra read once, the outputs written once)
    over the memory rate."""
    from cryo_ralib_tpu_torch.ops.template_search import (
        _splat_spectra_bytes, template_geometry)

    _, width, _ = template_geometry(cfg)
    n_m = 2 if cfg.mirror else 1
    flops = 2.0 * n * width * width * n_m * cfg.n_shifts * k * cfg.ring_len
    nbytes = (4 * n * cfg.img_dim ** 2 + 8 * k * cfg.ring_num * F
              + _splat_spectra_bytes(cfg) + 8 * n + n * 4 * (1 + L + 4))
    t_op, t_mem = flops / BF16_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_op, t_mem),
            "operations" if t_op >= t_mem else "bytes")


def max0(t) -> float:
    """The largest value of ``t``, 0 for an empty tensor."""
    return float(t.max()) if t.numel() else 0.0


def winners_equal(a, b):
    """(N,) bool on the host: the particles whose (ref, shift, mirror,
    angle bin) agree in two results."""
    same = torch.ones(a.best_ref.shape, dtype=torch.bool)
    for f in ("best_ref", "best_sidx", "best_mirror", "best_aidx"):
        same &= getattr(a, f).cpu() == getattr(b, f).cpu()
    return same


def template_phase(dev, card, main_path, imgs, tmpl, cls, stack_a, tmpl1,
                   tmpl64, kernel_ms, before) -> dict:
    """Phase 14: the template engine on the card.  14a the engine on the
    card against itself on the CPU (and against the kernel, a figure);
    14b its ms per search at K=8, 1 and 64 beside the kernel's and the
    bound, and by column-chunk target; 14c
    mref_ali2d, reffree A under SHC and mref under the eman2 rings
    through it, beside the phase-6/10 runs (``before``: their
    s/iteration and phase 6's assignments); 14d the mref loop through it
    under sync debug mode "error"; 14e the planner's model against one
    step's peak.  Every template path launches the search kernel 0
    times."""
    from cryo_ralib_tpu_torch.config import AlignConfig
    from cryo_ralib_tpu_torch.models import make_mref_device_loop
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base
    from cryo_ralib_tpu_torch.models.steps import align_step, resolve_route
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops import template_search as ts
    from cryo_ralib_tpu_torch.ops.search import prepare_ref_spectra
    from cryo_ralib_tpu_torch.parallel.batching import step_footprint
    from cryo_ralib_tpu_torch.params import AlignParams
    from cryo_ralib_tpu_torch.utils.log import RunLogger
    from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

    t_phase = time.perf_counter()
    out = {"card": card, "route": ts.product_route(dev)}
    quiet = dict(log=RunLogger(None, quiet=True))
    cfg = geometry(HEADLINE)
    k = tmpl.shape[0]
    sf = ts.splat_spectra_groups(cfg, dev)
    log(f"14 template products on the card: route {out['route']!r} "
        f"(bf16 = torch.mm(bf16, bf16, out_dtype=float32); tf32 = f32 "
        f"operands holding bf16 values under TF32)")

    # ---- 14a. card against CPU on 512 particles (integer and fractional
    # accumulated shifts), and against the kernel
    cfg_c, sub, rfw, prm = make_case(HEADLINE, N_CHECK, "structured", 60,
                                     dev)
    t0 = time.perf_counter()
    got = ts.template_search(sub, rfw, prm, cfg_c, sf=sf)
    want = ts.template_search(sub.cpu(), rfw.cpu(),
                              AlignParams(*[f.cpu() for f in prm]), cfg_c)
    cpu_s = time.perf_counter() - t0
    same = winners_equal(got, want)
    rel = ((got.best_val.cpu() - want.best_val).abs()
           / want.best_val.abs())
    log(f"14a template card vs CPU, {N_CHECK} particles 90px K={k}: "
        f"{float(same.float().mean()):.4f} of winners equal, the others' "
        f"peaks within {max0(rel[~same]):.2e} relative; "
        f"peaks within {float(rel.max()):.2e} relative (CPU {cpu_s:.1f} s)")
    check(float(same.float().mean()) >= 0.999,
          f"14a: {int((~same).sum())} winners differ from the CPU's")
    check(max0(rel[~same]) <= 5e-3, "14a: tie rule")
    kern = fs.fused_search(sub, rfw, prm, cfg_c)
    out["card_vs_cpu"] = float(same.float().mean())
    out["vs_kernel_n512"] = float(winners_equal(got, kern).float().mean())
    log(f"14a template vs the kernel (a figure: the window's two-stage "
        f"bf16 interpolation against the kernel's f32 bilinear samples at "
        f"fractional accumulated shifts): {out['vs_kernel_n512']:.4f} of "
        f"winners equal")

    # ---- 14b. ms per search at the main paths' shapes
    zeros = AlignParams.zeros(N_SLICE, dev)
    params = acc_params(N_SLICE, 5, dev)
    rfw8 = prepare_ref_spectra(torch.as_tensor(tmpl, device=dev), cfg)
    rfw1 = prepare_ref_spectra(torch.as_tensor(tmpl1, device=dev), cfg)
    rfw64 = prepare_ref_spectra(torch.as_tensor(tmpl64, device=dev), cfg)
    imgs64 = scattered_stack(tmpl64, N_SLICE, max_shift=2, noise=1.0,
                             seed=9, device=dev)[0]
    cases = (("k8", imgs, rfw8, k), ("k1", stack_a, rfw1, 1),
             ("k64", imgs64, rfw64, K_LARGE))
    searches = {}

    def time_all():
        for name, x, r, kk in cases:
            ms = cuda_ms(lambda: ts.template_search(x, r, params, cfg, sf=sf),
                         3)
            bound_ms, bound_by = template_bound(N_SLICE, cfg, kk)
            kms = kernel_ms[name]
            searches[name] = {"ms": ms, "kernel_ms": kms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "share": bound_ms / ms, "k": kk}
            log(f"14b template search {name} N={N_SLICE} 90px K={kk}: "
                f"{ms:.2f} ms (CUDA events, mean of 3), kernel {kms:.2f} "
                f"ms, bound {bound_ms:.2f} ms ({bound_by}), "
                f"{100 * bound_ms / ms:.1f}% of it  [{card}]")
        ref = ts.template_search(imgs, rfw8, params, cfg, sf=sf)
        for target in CHUNK_TARGETS:
            ts.COL_CHUNK_TARGET = target
            try:
                ms = cuda_ms(lambda: ts.template_search(imgs, rfw8, params,
                                                        cfg, sf=sf), 3)
                res = ts.template_search(imgs, rfw8, params, cfg, sf=sf)
            finally:
                ts.COL_CHUNK_TARGET = CHUNK_TARGETS[0]
            diff = ~winners_equal(res, ref)
            gap = max0(((res.best_val - ref.best_val).abs()
                        / ref.best_val.abs()).cpu()[diff])
            searches[f"k8_chunk{target}"] = {"ms": ms,
                                             "winners_differ": int(
                                                 diff.sum())}
            log(f"14b K=8 column chunks of <= {target}: {ms:.2f} ms; "
                f"{int(diff.sum())} winners differ from 2048's (their "
                f"peaks within {gap:.2e} relative)  [{card}]")
            check(float(diff.float().mean()) <= 1e-3 and gap <= 1e-5,
                  f"14b: the chunk target {target} moved winners")
        return ref

    ref, _ = main_path("template searches", time_all, NO_LAUNCH)

    def by_stage(mark):
        ts.build_template_blocks(rfw8, cfg, sf=sf)
        mark("build")
        win, cols_fn, c_total, chunk, route = ts._search_operands(
            imgs, rfw8, params, cfg, sf)
        mark("window_and_build")
        cols = cols_fn(0)
        with ts._product_switches(route):
            for _ in range(c_total // chunk):
                ts._scores(win, cols, route)
        mark("products")
        ts._online_argmax(win, cols_fn, c_total, chunk, cfg.ring_len, route)
        mark("products_and_fold")

    st = events_ms(by_stage)
    stages = {"template_build": st["build"],
              "window": st["window_and_build"] - st["build"],
              "products": st["products"],
              "column_fill_and_fold": st["products_and_fold"]
              - st["products"]}
    searches["k8_stages"] = stages
    log(f"14b template search K=8 by stage (CUDA events, mean of 3): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items())
        + f"  [{card}]")
    kern = fs.fused_search(imgs, rfw8, params, cfg)
    out["vs_kernel_n16384"] = float(winners_equal(ref, kern).float().mean())
    log(f"14b template vs the kernel at N={N_SLICE} K={k}: "
        f"{out['vs_kernel_n16384']:.4f} of winners equal (a figure)")
    out["searches"] = searches
    del imgs64, ref, kern

    # ---- 14c. the drivers through the template engine
    res, seconds = main_path("mref K=8 template", lambda: mref_ali2d(
        imgs, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"],
        ts=1, maxit=MAXIT, device=dev, sampler="template", **quiet),
        NO_LAUNCH)
    check(bool(np.isfinite(res.params).all()
               and np.isfinite(res.references).all()), "14c mref: NaN")
    check(int(res.class_counts.sum()) == N_SLICE, "14c mref: counts")
    pur = purity(res.assignments, cls, k)
    agree = float((res.assignments == before["mref_assign"]).mean())
    out["mref"] = mode_line(
        "14c mref template", f"mref_ali2d(sampler='template') K={k}",
        seconds, MAXIT, card, f"; phase 6 (kernel) "
        f"{before['mref_s_it']:.4f} s/iteration; purity {pur:.4f}; "
        f"assignments equal to phase 6's {agree:.4f}")
    out["mref"].update(purity=pur, agree_phase6=agree)
    check(pur >= 0.9, f"14c mref purity {pur}")

    n_shc = 4
    lines = ListLogger()
    res, seconds = main_path("reffree SHC template", lambda: ali2d_base(
        stack_a, maxit=n_shc, random_method="SHC", sampler="template",
        ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"], ts=1.0,
        center=-1, device=dev, log=lines), NO_LAUNCH)
    check(bool(np.isfinite(res.params).all()
               and np.isfinite(res.average).all()), "14c SHC: NaN")
    nope = [int(m.split()[1]) for m in lines.lines if m.startswith("SHC:")]
    check(len(nope) == n_shc and all(0 <= v <= N_SLICE for v in nope)
          and nope[0] == 0, f"14c SHC nope counts {nope}")
    out["reffree_shc"] = mode_line(
        "14c reffree SHC template", "ali2d_base(random_method='SHC', "
        "sampler='template')", seconds, n_shc, card,
        f"; phase 10b (the kernel's SHC pick) {before['shc_s_it']:.4f} "
        f"s/iteration; nope {nope}")
    out["reffree_shc"]["nope"] = nope

    n_em = 3
    cfg_e = AlignConfig(img_dim=HEADLINE["nx"], ring_num=HEADLINE["ou"],
                        ring_scheme="eman2", shift_rng_x=HEADLINE["xr"],
                        shift_rng_y=HEADLINE["xr"])
    res, seconds = main_path("mref eman2 template", lambda: mref_ali2d(
        imgs, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"],
        ts=1, maxit=n_em, ring_scheme="eman2", sampler="template",
        device=dev, **quiet), NO_LAUNCH)
    check(bool(np.isfinite(res.params).all()
               and np.isfinite(res.references).all()), "14c eman2: NaN")
    check(int(res.class_counts.sum()) == N_SLICE, "14c eman2: counts")
    pur = purity(res.assignments, cls, k)
    out["mref_eman2"] = mode_line(
        "14c mref eman2 template", f"mref_ali2d(ring_scheme='eman2', "
        f"sampler='template') K={k}, maxrin {cfg_e.ring_len}", seconds, n_em,
        card, f"; phase 10d (PyTorch search) {before['eman2_s_it']:.4f} "
        f"s/iteration; purity {pur:.4f}")
    out["mref_eman2"]["purity"] = pur
    check(pur >= 0.9, f"14c eman2 purity {pur}")

    # ---- 14d. the mref loop through the template engine, no host sync
    gidx = torch.arange(N_SLICE, device=dev)
    valid = torch.ones(N_SLICE, device=dev)
    refs0 = torch.as_tensor(tmpl, device=dev)
    loop = make_mref_device_loop(cfg, MAXIT, k, np.full(MAXIT, 0.25),
                                 device=dev, sampler="template")
    (p_loop, refs_loop), _ = main_path(
        "mref loop template", lambda: loop(imgs, refs0, zeros, gidx, valid),
        NO_LAUNCH)
    loop_checks("14d mref loop template", p_loop, refs_loop, k, cls)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop(imgs, refs0, zeros, gidx, valid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["mref_loop"] = loop_line("14d mref loop template K=8",
                                 float(np.median(times)), MAXIT,
                                 before["mref_s_it"], card)
    out["mref_loop"]["kernel_loop_s_per_iteration"] = before["loop_s_it"]
    log(f"14d the kernel's mref loop (phase 8): {before['loop_s_it']:.4f} "
        f"s/iteration")

    # ---- 14e. the planner's model against one template step's peak
    align_step(imgs, refs0, zeros, gidx, None, cfg, n_classes=k,
               sampler="template", sf=sf)
    torch.cuda.synchronize()
    held = (imgs.nbytes + refs0.nbytes + gidx.nbytes
            + sum(f.nbytes for f in zeros)
            + sum(t.nbytes for t in sf))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    align_step(imgs, refs0, zeros, gidx, None, cfg, n_classes=k,
               sampler="template", sf=sf)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + held
    model = step_footprint(N_SLICE, resolve_route("template", dev, cfg,
                                                  n_refs=k), cfg).total
    out["footprint"] = {"peak_bytes": peak, "model_bytes": model}
    log(f"14e template align_step N={N_SLICE} K={k}: peak "
        f"{peak / 2**30:.3f} GiB (with its images, refs, params and splat "
        f"spectra), the planner's model {model / 2**30:.3f} GiB (ratio "
        f"{model / peak:.3f})  [{card}]")
    check(model >= peak, f"14e: the model {model} is below the peak {peak}")
    check(model <= 2 * peak, f"14e: the model {model} is over twice the "
          f"peak {peak}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14: {out['seconds']:.1f} s  [{card}]")
    return out


# ---- phase 15: the FFT-shear warp and the matmul sampler
def matmul_bound(n, cfg, k):
    """(bound_ms, bound_by, flops, nbytes) of the matmul sampler's
    formulation of one search: its products' operations, for every dy of
    the grid the y contraction 2 x N x Q x H x W and the x contraction
    2 x N x Q x W x n_dx (Q = rings x 256 sample points), over the bf16
    tensor-core peak, against the bytes of its bf16 intermediate ``t``
    (N x Q x W per dy, written once) over the memory rate."""
    n_dy, n_dx = len(cfg.shift_y_vals), len(cfg.shift_x_vals)
    q, h = cfg.ring_num * cfg.ring_len, cfg.img_dim
    flops = float(n_dy * (2 * n * q * h * h + 2 * n * q * h * n_dx))
    nbytes = float(n_dy * n * q * h * 2)
    t_op, t_mem = flops / BF16_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_op, t_mem),
            "operations" if t_op >= t_mem else "bytes", flops, nbytes)


def rel_max(got, want) -> float:
    """Largest difference over the largest value of ``want`` (host)."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    return float((got - want).abs().max() / want.abs().max())


def step_peak(fn, held) -> int:
    """Peak device bytes of one call of ``fn`` (after a warm-up call),
    plus ``held``, the bytes of its inputs."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base + held


def matmul_phase(dev, card, main_path, imgs, tmpl, cls, stack_a, tmpl1,
                 tmpl64, before) -> dict:
    """Phase 15: the FFT-shear warp and the matmul sampler on the card.
    15a the FFT-shear class sums beside the bilinear ones, and the card
    against the CPU port; 15b rot_shift2d(engine="shear") beside quadri;
    15c the Fourier variance by both engines, and the drivers' figures
    that now run through the shear (``before``); 15d the matmul search at
    K=8, 1 and 64 with its two bounds, and the card's winners against the
    CPU's; 15e the drivers through sampler="matmul"; 15f a matmul step's
    peak against the planner's model; 15g reffree's iteration-0 sums
    against numpy's, bit for bit.  No path launches the search kernel."""
    from cryo_ralib_tpu_torch.config import AlignConfig
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import _even_odd_sums, ali2d_base
    from cryo_ralib_tpu_torch.models.steps import (_finish_step, align_step,
                                                   resolve_route)
    from cryo_ralib_tpu_torch.ops import search as srch
    from cryo_ralib_tpu_torch.ops.classavg import class_sum_transform_mm
    from cryo_ralib_tpu_torch.ops.fourvar import fourier_variance
    from cryo_ralib_tpu_torch.ops.masks import model_circle
    from cryo_ralib_tpu_torch.ops.polar_mm import product_route
    from cryo_ralib_tpu_torch.ops.transform import rot_shift2d
    from cryo_ralib_tpu_torch.parallel.batching import (shear_sum_bytes,
                                                        step_footprint)
    from cryo_ralib_tpu_torch.params import AlignParams, params_from_numpy
    from cryo_ralib_tpu_torch.utils.log import RunLogger
    from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

    t_phase = time.perf_counter()
    out = {"card": card, "route": product_route(dev)}
    quiet = dict(log=RunLogger(None, quiet=True))
    cfg = geometry(HEADLINE)
    k, n = tmpl.shape[0], N_SLICE
    rng = np.random.default_rng(15)
    acc = np.array([0.0, 1.0, -1.0, 0.5, -0.25, 0.75], np.float32)
    prm = params_from_numpy({
        "angle": rng.uniform(0, 360, n).astype(np.float32),
        "shift_x": rng.choice(acc, n), "shift_y": rng.choice(acc, n),
        "mirror": rng.integers(0, 2, n).astype(np.int32),
        "ref_id": rng.integers(0, k, n).astype(np.int32)}, dev)
    gidx = torch.arange(n, device=dev)
    peak = torch.zeros(n, device=dev)
    cpu = AlignParams(*[f[:N_CHECK].cpu() for f in prm])
    sub = imgs[:N_CHECK].contiguous()

    # ---- 15a. the FFT-shear class sums beside the bilinear ones
    def sums_of(route):
        return lambda: _finish_step(imgs, prm, peak, gidx, None, k, route)

    shear_ms = cuda_ms(sums_of("shear"), 3)
    bilinear_ms = cuda_ms(sums_of("kernel"), 3)
    held = imgs.nbytes + gidx.nbytes + sum(f.nbytes for f in prm)
    shear_peak = step_peak(sums_of("shear"), held)
    bilinear_peak = step_peak(sums_of("kernel"), held)
    model = shear_sum_bytes(n, k, HEADLINE["nx"]) + held
    got, counts = class_sum_transform_mm(sub, AlignParams(
        *[f[:N_CHECK] for f in prm]), k, fast=True)
    want, want_c = class_sum_transform_mm(sub.cpu(), cpu, k, fast=True)
    sums_err = rel_max(got, want)
    out["class_sums"] = {
        "shear_ms": shear_ms, "bilinear_ms": bilinear_ms,
        "shear_peak_bytes": shear_peak, "bilinear_peak_bytes": bilinear_peak,
        "shear_model_bytes": model, "card_vs_cpu_n512": sums_err}
    log(f"15a class sums N={n} 90px K={k} by blocks: FFT shear "
        f"(class_sum_transform_mm, bf16 DFTs) {shear_ms:.2f} ms, peak "
        f"{shear_peak / 2**30:.3f} GiB (model {model / 2**30:.3f}); "
        f"bilinear (the class-sum kernel) {bilinear_ms:.2f} ms, peak "
        f"{bilinear_peak / 2**30:.3f} GiB (CUDA events, mean of 3); card vs "
        f"CPU on {N_CHECK}: {sums_err:.2e} of the largest sum  [{card}]")
    check(bool(torch.equal(counts.cpu(), want_c)), "15a: counts")
    check(sums_err <= 5e-3, f"15a: class sums card vs CPU {sums_err}")
    check(shear_peak <= model <= 2 * shear_peak,
          f"15a: shear sums model {model} against peak {shear_peak}")

    # ---- 15b. rot_shift2d through the FFT shear beside quadri
    args = (prm.angle, prm.shift_x, prm.shift_y, prm.mirror)
    rs_shear = cuda_ms(lambda: rot_shift2d(imgs, *args, engine="shear"), 3)
    rs_quadri = cuda_ms(lambda: rot_shift2d(imgs, *args), 3)
    rs_err = rel_max(
        rot_shift2d(sub, *[a[:N_CHECK] for a in args], engine="shear"),
        rot_shift2d(sub.cpu(), *[a[:N_CHECK].cpu() for a in args],
                    engine="shear"))
    out["rot_shift2d"] = {"shear_ms": rs_shear, "quadri_ms": rs_quadri,
                          "card_vs_cpu_n512": rs_err}
    log(f"15b rot_shift2d N={n} 90px: shear (f32 FFTs) {rs_shear:.2f} ms, "
        f"quadri {rs_quadri:.2f} ms (CUDA events, mean of 3); shear card vs "
        f"CPU on {N_CHECK}: {rs_err:.2e} of the largest value  [{card}]")
    check(rs_err <= 1e-4, f"15b: rot_shift2d shear card vs CPU {rs_err}")

    # ---- 15c. the Fourier variance by both engines; the figures of the
    # drivers whose sums or variance now run through the shear
    mask = torch.as_tensor(model_circle(HEADLINE["ou"], HEADLINE["nx"]),
                           dtype=torch.float32, device=dev)
    fv = {e: cuda_ms(lambda: fourier_variance(stack_a, prm, mask=mask,
                                              engine=e), 3)
          for e in ("shear", "exact")}
    out["fourier_variance_ms"] = fv
    out["drivers_through_shear"] = {
        "fourvar_s_per_iteration": before["fourvar_s_it"],
        "template_mref_s_per_iteration": before["template_mref_s_it"]}
    log(f"15c fourier_variance N={n} 90px: shear (bf16 DFTs, the default) "
        f"{fv['shear']:.2f} ms, exact (bilinear) {fv['exact']:.2f} ms (CUDA "
        f"events, mean of 3); through the shear in this run: ali2d_base("
        f"Fourvar=True) {before['fourvar_s_it']:.4f} s/iteration (10f), "
        f"mref_ali2d(sampler='template') {before['template_mref_s_it']:.4f} "
        f"s/iteration (14c)  [{card}]")

    # ---- 15d. the matmul search: ms, two bounds, card against CPU
    acc_prm = acc_params(n, 5, dev)
    sub_prm = AlignParams(*[f[:N_CHECK] for f in acc_prm])
    rfw8 = srch.prepare_ref_spectra(torch.as_tensor(tmpl, device=dev), cfg)
    got = srch.rotational_shift_search_mm(sub, rfw8, sub_prm, cfg)
    t0 = time.perf_counter()
    want = srch.rotational_shift_search_mm(
        sub.cpu(), rfw8.cpu(), AlignParams(*[f.cpu() for f in sub_prm]), cfg)
    cpu_s = time.perf_counter() - t0
    same = winners_equal(got, want)
    gap = ((got.best_val.cpu() - want.best_val).abs() / want.best_val.abs())
    out["search_card_vs_cpu"] = float(same.float().mean())
    log(f"15d matmul search card vs CPU, {N_CHECK} particles 90px K={k}: "
        f"{float(same.float().mean()):.4f} of winners equal, the others' "
        f"peaks within {max0(gap[~same]):.2e} relative; peaks within "
        f"{float(gap.max()):.2e} (CPU {cpu_s:.1f} s)")
    check(float(same.float().mean()) >= 0.999,
          f"15d: {int((~same).sum())} winners differ from the CPU's")
    check(max0(gap[~same]) <= 5e-3, "15d: tie rule")
    imgs64 = scattered_stack(tmpl64, n, max_shift=2, noise=1.0, seed=9,
                             device=dev)[0]
    cases = (("k8", imgs, tmpl), ("k1", stack_a, tmpl1),
             ("k64", imgs64, tmpl64))
    searches = {}

    def time_all():
        for name, x, t in cases:
            rfw = srch.prepare_ref_spectra(torch.as_tensor(t, device=dev),
                                           cfg)
            kk = t.shape[0]
            ms = cuda_ms(lambda: srch.rotational_shift_search_mm(
                x, rfw, acc_prm, cfg), 2 if kk > 8 else 3)
            own_ms, own_by = search_bound(n, HEADLINE["nx"], HEADLINE["ou"],
                                          cfg.n_shifts, kk, 2)
            f_ms, f_by, flops, nbytes = matmul_bound(n, cfg, kk)
            searches[name] = {
                "ms": ms, "k": kk, "block": srch.mm_block(n, kk, cfg),
                "search_bound_ms": own_ms, "search_bound_by": own_by,
                "search_share": own_ms / ms, "formulation_bound_ms": f_ms,
                "formulation_bound_by": f_by, "formulation_share": f_ms / ms,
                "product_flops": flops, "t_bytes": nbytes,
                "kernel_ms": before["kernel_ms"][name],
                "template_ms": before["template_ms"][name]}
            log(f"15d matmul search {name} N={n} 90px K={kk} (blocks of "
                f"{searches[name]['block']}): {ms:.2f} ms (CUDA events); "
                f"the search's bound {own_ms:.3f} ms ({own_by}, "
                f"{100 * own_ms / ms:.2f}%); the formulation's bound "
                f"{f_ms:.2f} ms ({f_by}: {flops / 1e12:.2f} TFLOP of products"
                f" at 989 TFLOP/s against {nbytes / 1e9:.1f} GB of bf16 t at "
                f"3.35 TB/s, {100 * f_ms / ms:.1f}%); kernel "
                f"{before['kernel_ms'][name]:.2f} ms, template "
                f"{before['template_ms'][name]:.2f} ms  [{card}]")

    main_path("matmul searches", time_all, NO_LAUNCH)
    out["searches"] = searches
    del imgs64

    # ---- 15e. the drivers through the matmul sampler
    n_it = 2
    mm_kw = dict(ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"],
                 device=dev, sampler="matmul")
    res, seconds = main_path("mref K=8 matmul", lambda: mref_ali2d(
        imgs, tmpl, ts=1, maxit=n_it, **mm_kw, **quiet), NO_LAUNCH)
    check(bool(np.isfinite(res.params).all()
               and np.isfinite(res.references).all()), "15e mref: NaN")
    check(int(res.class_counts.sum()) == n, "15e mref: counts")
    pur = purity(res.assignments, cls, k)
    out["mref"] = mode_line(
        "15e mref matmul", f"mref_ali2d(sampler='matmul') K={k}", seconds,
        n_it, card, f"; phase 6 (kernel) {before['mref_s_it']:.4f} "
        f"s/iteration; purity {pur:.4f}")
    check(pur >= 0.9, f"15e mref purity {pur}")
    runs = (("reffree_a", "reffree A", dict(center=-1, dst=DST), "phase 7",
             "reffree_a_s_it"),
            ("reffree_shc", "reffree SHC", dict(center=-1,
                                                random_method="SHC"),
             "phase 10b", "shc_s_it"),
            ("reffree_scf", "reffree SCF", dict(center=-1,
                                                random_method="SCF"),
             "phase 10c", "scf_s_it"))
    for key, label, kw, where, bkey in runs:
        res, seconds = main_path(f"{label} matmul", lambda: ali2d_base(
            stack_a, ts=1.0, maxit=n_it, **mm_kw, **kw, **quiet), NO_LAUNCH)
        check(bool(np.isfinite(res.params).all()
                   and np.isfinite(res.average).all()), f"15e {label}: NaN")
        out[key] = mode_line(
            f"15e {label} matmul", f"ali2d_base({kw}, sampler='matmul')",
            seconds, n_it, card, f"; {where} {before[bkey]:.4f} "
            f"s/iteration")
    cfg_e = AlignConfig(img_dim=HEADLINE["nx"], ring_num=HEADLINE["ou"],
                        ring_scheme="eman2", shift_rng_x=HEADLINE["xr"],
                        shift_rng_y=HEADLINE["xr"])
    res, seconds = main_path("mref eman2 matmul", lambda: mref_ali2d(
        imgs, tmpl, ts=1, maxit=n_it, ring_scheme="eman2", **mm_kw,
        **quiet), NO_LAUNCH)
    check(int(res.class_counts.sum()) == n, "15e eman2: counts")
    pur = purity(res.assignments, cls, k)
    out["mref_eman2"] = mode_line(
        "15e mref eman2 matmul", f"mref_ali2d(ring_scheme='eman2', "
        f"sampler='matmul') K={k}, maxrin {cfg_e.ring_len}", seconds, n_it,
        card, f"; phase 10d {before['eman2_s_it']:.4f} s/iteration; purity "
        f"{pur:.4f}")
    check(pur >= 0.9, f"15e eman2 purity {pur}")

    # ---- 15f. a matmul step's peak against the planner's model
    refs0 = torch.as_tensor(tmpl, device=dev)
    zeros = AlignParams.zeros(n, dev)
    held = (imgs.nbytes + refs0.nbytes + gidx.nbytes
            + sum(f.nbytes for f in zeros))
    step_p = step_peak(lambda: align_step(imgs, refs0, zeros, gidx, None,
                                          cfg, n_classes=k,
                                          sampler="matmul"), held)
    model = step_footprint(n, resolve_route("matmul", dev, cfg, n_refs=k),
                           cfg).total
    out["footprint"] = {"peak_bytes": step_p, "model_bytes": model}
    log(f"15f matmul align_step N={n} K={k}: peak {step_p / 2**30:.3f} GiB "
        f"(with its images, refs and params), the planner's model "
        f"{model / 2**30:.3f} GiB (ratio {model / step_p:.3f})  [{card}]")
    check(step_p <= model <= 2 * step_p,
          f"15f: the model {model} against the peak {step_p}")

    # ---- 15g. reffree's iteration-0 sums: added in stack order in f32,
    # the card's equal numpy's (the JAX driver's) bit for bit
    host = stack_a.cpu().numpy()
    eo_ms = cuda_ms(lambda: _even_odd_sums(stack_a, dev), 3)
    eo = _even_odd_sums(stack_a, dev)
    eo_same = bool(np.array_equal(eo[0, 0], host[0::2].sum(0))
                   and np.array_equal(eo[0, 1], host[1::2].sum(0)))
    out["even_odd_sums"] = {"ms": eo_ms, "equal_numpy": eo_same}
    log(f"15g reffree iteration-0 even/odd sums N={n} 90px: {eo_ms:.2f} ms "
        f"(CUDA events, mean of 3), equal to numpy's: {eo_same}  [{card}]")
    check(eo_same, "15g: iteration-0 sums against numpy's")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['seconds']:.1f} s  [{card}]")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on an NVIDIA GPU only")
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cryo_ralib_tpu_torch import kernels
    from cryo_ralib_tpu_torch.models import (make_device_loop,
                                             make_mref_device_loop,
                                             ref_free_alignment_2d)
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base
    from cryo_ralib_tpu_torch.ops import classavg as ca
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops.ctf_ops import CtfContext
    from cryo_ralib_tpu_torch.ops.search import (
        delta_angle_mask, prepare_ref_spectra, rotational_shift_search_shc)
    from cryo_ralib_tpu_torch.params import AlignParams
    from cryo_ralib_tpu_torch.utils.log import RunLogger
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      scattered_stack,
                                                      unit_sigma_blobs)

    # ---- 2. build
    lib = fs.build()
    info = kernels.build_log["search"]
    log(f"build: search kernel in {info['seconds']:.2f} s "
        f"(cached={info['cached']})")
    for line in info["ptxas"].splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or "entry function" in line):
            log("  ptxas: " + line.strip())
    ca.build()
    cs_info = kernels.build_log["class_sums"]
    cs_regs = class_sums_ptxas(cs_info["ptxas"])
    log(f"build: class-sum kernel in {cs_info['seconds']:.2f} s "
        f"(cached={cs_info['cached']}); registers, spill bytes: {cs_regs}")
    check(len(cs_regs) == 3, f"ptxas reports {len(cs_regs)} class-sum "
          "kernels")
    regs = ptxas_table(info["ptxas"])
    log(f"  registers, spill bytes by (NMIRR, MASK, KG, STAGE, PICK): "
        f"{regs}")
    check(len(regs) == 16, f"ptxas reports {len(regs)} instantiations")
    for geom in (HEADLINE, BIG_BOX):
        n_shifts = geometry(geom).n_shifts
        for mirror in (1, 0):
            for k in (geom["k"], 1):
                log(f"  launch plan at {geom['nx']}px ou={geom['ou']}, "
                    f"{n_shifts} shifts, mirror={mirror}, K={k}: "
                    + json.dumps(fs.kernel_plan(geom["ou"], mirror, k,
                                                n_shifts, geom["nx"],
                                                geom["nx"])))

    # ---- 3. kernel vs plain at N=512
    log("kernel vs plain, N=%d" % N_CHECK)
    errs = []
    for gi, geom in enumerate((HEADLINE, BIG_BOX)):
        for kind in ("structured", "noise"):
            case = make_case(geom, N_CHECK, kind, seed=10 + gi, dev=dev)
            label = f"{geom['nx']}px ou={geom['ou']} K={geom['k']} {kind}"
            err = compare(*case, kind, label)
            if geom is HEADLINE and kind == "structured":
                errs.append(err)

    # ---- 3b. the variants at K=1, and K=64, against plain at N=512
    mask = torch.as_tensor(delta_angle_mask(L, DST), device=dev)
    var_errs = {name: [] for name in VARIANT_REPLACES}
    for gi, geom in enumerate((HEADLINE, BIG_BOX)):
        geom1 = dict(geom, k=1)
        for mirror in (True, False):
            for masked in (False, True):
                name = fs.variant(geometry(geom1, mirror), masked)
                for kind in ("structured", "noise"):
                    case = make_case(geom1, N_CHECK, kind, seed=20 + gi,
                                     dev=dev, mirror=mirror)
                    label = f"{name} {geom['nx']}px ou={geom['ou']} K=1 {kind}"
                    err = compare(*case, kind, label,
                                  mask=mask if masked else None)
                    if kind == "structured":
                        var_errs[name].append(err)
    # K=64: asymmetric_templates repeat themselves beyond ~40 classes
    # (template i+44 is template i turned by ~1 degree), so their
    # winners are near-ties and their peaks can be flat: they take the
    # noise rule and the fit's conditioning (compare kind "flat").
    # Seeded random blobs are distinct and take the structured rule.
    tmpl64 = unit_sigma_blobs(K_LARGE, HEADLINE["nx"])
    geom64 = dict(HEADLINE, k=K_LARGE)
    var_errs["search_k64"].append(compare(
        *make_case(geom64, N_CHECK, "structured", seed=30, dev=dev,
                   refs=tmpl64),
        "structured", f"90px ou=36 K={K_LARGE} blob templates structured"))
    var_errs["search_k64"].append(compare(
        *make_case(geom64, N_CHECK, "structured", seed=30, dev=dev),
        "flat", f"90px ou=36 K={K_LARGE} asymmetric_templates"))

    # ---- 3c. the SNR sweep, no CTF
    tmpl = asymmetric_templates(HEADLINE["k"], HEADLINE["nx"])
    cfg = geometry(HEADLINE)
    rfw = prepare_ref_spectra(torch.as_tensor(tmpl, device=dev), cfg)
    zero = AlignParams.zeros(N_CHECK, dev)
    for snr in SNRS:
        imgs, cls, _, _, mir = scattered_stack(
            tmpl, N_CHECK, max_shift=2, noise=float(np.sqrt(1.0 / snr)),
            seed=40, device=dev)
        label = f"SNR {snr:g} (no CTF) 90px K=8"
        compare(cfg, imgs.contiguous(), rfw, zero, "noise", label)
        got = fs.fused_search(imgs.contiguous(), rfw, zero, cfg)
        truth = ((got.best_ref.cpu().numpy() == cls)
                 & (got.best_mirror.cpu().numpy() == mir))
        log(f"  {label}: {truth.mean():.4f} of winners match the known "
            f"class and mirror")
    del imgs

    # ---- 3d. half rings (mode H), and the SNR sweep with CTF
    mask_h = torch.as_tensor(delta_angle_mask(L, DST, "H"), device=dev)
    for k_h in (HEADLINE["k"], 1):
        for masked in (False, True):
            for kind in ("structured", "noise"):
                case = make_case(dict(HEADLINE, k=k_h), N_CHECK, kind,
                                 seed=50, dev=dev, mode="H")
                name = fs.variant(case[0], masked)
                err = compare(*case, kind,
                              f"mode H {name} 90px ou=36 K={k_h} {kind}",
                              mask=mask_h if masked else None)
                if kind == "structured":
                    (errs if name == "search" and k_h > 1
                     else var_errs[name]).append(err)
    # SCF's rotation stage: K=1, one shift, half rings
    case = make_case(dict(HEADLINE, k=1, xr=0.0), N_CHECK, "structured",
                     seed=51, dev=dev, mode="H")
    var_errs["search"].append(compare(
        *case, "structured", "mode H search 90px ou=36 K=1 one shift"))
    for snr in SNRS:
        imgs, cls, mir, ctfp = ctf_stack(tmpl, N_CHECK,
                                         float(np.sqrt(1.0 / snr)), 40, dev)
        imgs = CtfContext(HEADLINE["nx"], ctfp,
                          device=dev).premultiply(imgs).contiguous()
        label = f"SNR {snr:g} with CTF (premultiplied) 90px K=8"
        compare(cfg, imgs, rfw, zero, "noise", label)
        got = fs.fused_search(imgs, rfw, zero, cfg)
        truth = ((got.best_ref.cpu().numpy() == cls)
                 & (got.best_mirror.cpu().numpy() == mir))
        log(f"  {label}: {truth.mean():.4f} of winners match the known "
            f"class and mirror")
    del imgs

    # ---- 4. mref_ali2d: kernel path vs plain path on a small stack
    small = scattered_stack(tmpl, N_CHECK, max_shift=2, noise=0.1, seed=3,
                            device=dev)[0]
    runs = {}
    for sampler in ("kernel", "plain"):
        runs[sampler] = mref_ali2d(
            small, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
            yr=HEADLINE["xr"], ts=1, maxit=2, device=dev, sampler=sampler,
            log=RunLogger(None, quiet=True))
    a, b = runs["kernel"], runs["plain"]
    check(np.array_equal(a.assignments, b.assignments), "mref: assignments")
    check(np.array_equal(a.params[:, 3], b.params[:, 3]), "mref: mirrors")
    d = np.abs(a.params[:, 0] - b.params[:, 0])
    check(np.minimum(d, 360.0 - d).max() < 1e-3, "mref: angles")
    check(np.abs(a.params[:, 1:3] - b.params[:, 1:3]).max() < 1e-3,
          "mref: shifts")
    log("mref_ali2d: kernel and plain paths agree on %d particles, 2 "
        "iterations" % N_CHECK)

    # ---- 4b. ali2d_base: kernel path vs plain path on a small stack
    tmpl1 = asymmetric_templates(1, HEADLINE["nx"])
    rf_kw = dict(ou=HEADLINE["ou"], xr=HEADLINE["xr"], ts=1.0, dst=DST,
                 device=dev)
    for mirror in (True, False):
        stack = scattered_stack(tmpl1, N_CHECK, max_shift=2, noise=1.0,
                                seed=4, device=dev, mirror=mirror)[0]
        runs = {sampler: ali2d_base(stack, maxit=11, nomirror=not mirror,
                                    sampler=sampler,
                                    log=RunLogger(None, quiet=True), **rf_kw)
                for sampler in ("kernel", "plain")}
        reffree_agree(runs["kernel"], runs["plain"],
                      f"ali2d_base N={N_CHECK} maxit=11 dst={DST:g} "
                      f"{'mirror' if mirror else 'nomirror'}")

    # ---- 5. the main path's input and shape: compare and time.  The
    # noisy stack may hold a rare rounding-level near-tie, so it is held
    # to the noise rule.  Asymmetric templates: the dihedral
    # class_templates make the mirror flag a near-tie for every particle.
    imgs, cls, _, _, _ = scattered_stack(tmpl, N_SLICE, max_shift=2,
                                         noise=1.0, seed=7, device=dev)
    cfg = geometry(HEADLINE)
    params = acc_params(N_SLICE, 5, dev)
    rfw = prepare_ref_spectra(torch.as_tensor(tmpl, device=dev), cfg)
    errs.append(compare(cfg, imgs, rfw, params, "noise",
                        f"90px K=8 N={N_SLICE}"))
    small_params = params._replace(
        shift_x=params.shift_x[:N_CHECK].contiguous(),
        shift_y=params.shift_y[:N_CHECK].contiguous())
    times = {}   # name -> (ms, plain_ms, ms at N=512, plain_ms at N=512)

    def time_search(name, cfg, imgs, rfw, mask=None):
        sub = imgs[:N_CHECK].contiguous()
        times[name] = (
            cuda_ms(lambda: fs.fused_search(imgs, rfw, params, cfg,
                                            angle_mask=mask), 3),
            cuda_ms(lambda: fs.search_plain(imgs, rfw, params, cfg,
                                            shift_chunk=1,
                                            angle_mask=mask), 1),
            cuda_ms(lambda: fs.fused_search(sub, rfw, small_params, cfg,
                                            angle_mask=mask), 10),
            cuda_ms(lambda: fs.search_plain(sub, rfw, small_params, cfg,
                                            angle_mask=mask), 3))
        log(f"time {name} {imgs.shape[1]}px K={rfw.shape[0]} "
            f"S={cfg.n_shifts}: kernel {times[name][0]:.2f} ms, plain "
            f"{times[name][1]:.2f} ms at N={imgs.shape[0]}; kernel "
            f"{times[name][2]:.3f} ms, plain {times[name][3]:.3f} ms at "
            f"N={N_CHECK}  [{card}]")

    time_search("search", cfg, imgs, rfw)
    # the reference-free shape: K=1, with and without mirrors and mask
    imgs1 = scattered_stack(tmpl1, N_SLICE, max_shift=2, noise=1.0, seed=8,
                            device=dev)[0]
    for mirror in (True, False):
        cfg1 = geometry(HEADLINE, mirror)
        rfw1 = prepare_ref_spectra(torch.as_tensor(tmpl1, device=dev), cfg1)
        for masked in (False, True):
            m = mask if masked else None
            name = fs.variant(cfg1, masked)
            errs_n = compare(cfg1, imgs1, rfw1, params, "noise",
                             f"{name} 90px K=1 N={N_SLICE}", mask=m)
            var_errs[name].append(errs_n)
            time_search(name + "_k1", cfg1, imgs1, rfw1, m)
    # ---- 5b. the kernel's SHC pick against the plain one on that stack
    shc_runs = {}   # previousmax -> {"ms", "plain_ms", "group_share"}
    for mirror in (True, False):
        cfg1 = geometry(HEADLINE, mirror)
        rfw1 = prepare_ref_spectra(torch.as_tensor(tmpl1, device=dev), cfg1)
        name = fs.variant(cfg1, False, shc=True)
        peak = fs.fused_search(imgs1, rfw1, params, cfg1).best_val
        peaks = shc_candidate_peaks(imgs1, rfw1, params, cfg1)
        for tag, pm in (("1e-23", torch.full_like(peak, 1e-23)),
                        ("0.98 x peak", 0.98 * peak),
                        ("3e38", torch.full_like(peak, 3e38))):
            err, share = compare_shc(
                cfg1, imgs1, rfw1, params, pm, peaks,
                f"{name} 90px K=1 N={N_SLICE} previousmax {tag}")
            var_errs[name].append(err)
            if not mirror:
                continue
            shc_runs[tag] = {
                "ms": cuda_ms(lambda: fs.fused_search_shc(
                    imgs1, rfw1, params, cfg1, pm), 3),
                "plain_ms": cuda_ms(lambda: rotational_shift_search_shc(
                    imgs1, rfw1, params, cfg1, pm), 1),
                "group_share": share}
            log(f"time {name}_k1 previousmax {tag}: kernel "
                f"{shc_runs[tag]['ms']:.2f} ms, plain "
                f"{shc_runs[tag]['plain_ms']:.2f} ms at N={N_SLICE}, "
                f"{share:.4f} of the shift groups run  [{card}]")
        if mirror:
            sub, pm = imgs1[:N_CHECK].contiguous(), 0.98 * peak[:N_CHECK]
            times["search_shc_k1"] = (
                shc_runs["0.98 x peak"]["ms"],
                shc_runs["0.98 x peak"]["plain_ms"],
                cuda_ms(lambda: fs.fused_search_shc(
                    sub, rfw1, small_params, cfg1, pm), 10),
                cuda_ms(lambda: rotational_shift_search_shc(
                    sub, rfw1, small_params, cfg1, pm), 3))
        del peaks
    imgs64 = scattered_stack(tmpl64, N_SLICE, max_shift=2, noise=1.0,
                             seed=9, device=dev)[0]
    rfw64 = prepare_ref_spectra(torch.as_tensor(tmpl64, device=dev), cfg)
    var_errs["search_k64"].append(compare(
        cfg, imgs64, rfw64, params, "noise", f"90px K={K_LARGE} N={N_SLICE}"))
    time_search("search_k64", cfg, imgs64, rfw64)
    # a rank's slice of the K=64 references on phase 13d's 2-D mesh
    rfw32 = rfw64[:K_SPLIT].contiguous()
    var_errs["search_k32"].append(compare(
        cfg, imgs64, rfw32, params, "noise", f"90px K={K_SPLIT} N={N_SLICE}"))
    time_search("search_k32", cfg, imgs64, rfw32)
    del rfw32

    # half rings: the same instantiations on other tables; and the K=1,
    # one-shift launch of SCF's rotation stage
    cfg_h = geometry(HEADLINE, mode="H")
    errs.append(compare(cfg_h, imgs, prepare_ref_spectra(
        torch.as_tensor(tmpl, device=dev), cfg_h), params, "noise",
        f"mode H 90px K=8 N={N_SLICE}"))
    time_search("search_mode_h", cfg_h, imgs, prepare_ref_spectra(
        torch.as_tensor(tmpl, device=dev), cfg_h))
    rfw1_h = prepare_ref_spectra(torch.as_tensor(tmpl1, device=dev), cfg_h)
    time_search("search_mode_h_k1", cfg_h, imgs1, rfw1_h)
    cfg_s1 = geometry(dict(HEADLINE, xr=0.0), mode="H")
    time_search("search_mode_h_k1_one_shift", cfg_s1, imgs1,
                prepare_ref_spectra(torch.as_tensor(tmpl1, device=dev),
                                    cfg_s1))

    def stage_times(imgs, rfw):
        row = {"full": cuda_ms(lambda: fs.fused_search(imgs, rfw, params,
                                                       cfg), 3)}
        for stage in fs.STAGES:
            row[stage] = cuda_ms(lambda: fs.fused_search_stage(
                imgs, rfw, params, cfg, stage), 3)
        return row

    ablation = {"stage_ablation": {
        "n": N_SLICE, "k8": stage_times(imgs, rfw),
        "k64": stage_times(imgs64, rfw64), "card": card}}
    tmpl64a = asymmetric_templates(K_LARGE, HEADLINE["nx"])
    imgs64 = scattered_stack(tmpl64a, N_SLICE, max_shift=2, noise=1.0,
                             seed=9, device=dev)[0]
    var_errs["search_k64"].append(compare(
        cfg, imgs64, prepare_ref_spectra(torch.as_tensor(tmpl64a, device=dev),
                                         cfg), params,
        "flat", f"90px K={K_LARGE} asymmetric_templates N={N_SLICE}"))
    del imgs1, imgs64
    ms, plain_ms = times["search"][:2]

    launches = {}   # kernel entry -> {main path: launches}
    sums_launches = {}   # main path -> class-sum kernel launches

    def main_path(label, fn, expect, entry=None):
        """Run one main path between a reset and a read of the launch
        counters; ``entry`` names the record its default-variant
        launches belong to (the K=64 shape has its own)."""
        fs.reset_launches()
        sums0 = ca.fused_class_sums.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(fs.fused_search.launches)
        n_sums = ca.fused_class_sums.launches - sums0
        if n_sums:
            sums_launches[label] = n_sums
        log(f"{label}: launches {got}, class sums {n_sums}")
        for key, want in expect.items():
            check(got[key] == want, f"{label}: {key} launched {got[key]} "
                  f"times, not {want}")
        for key, n_l in got.items():
            if n_l:
                name = entry if entry and key == "search" else key
                launches.setdefault(name, {})[label] = n_l
        return res, seconds

    # ---- 6. the main path
    res, seconds = main_path("mref K=8", lambda: mref_ali2d(
        imgs, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"],
        ts=1, maxit=MAXIT, device=dev, log=RunLogger(None, quiet=True)),
        {"search": MAXIT})
    check(res.params.shape == (N_SLICE, 4), f"params {res.params.shape}")
    check(bool(np.isfinite(res.params).all()
               and np.isfinite(res.references).all()), "NaN in the outputs")
    check(int(res.class_counts.sum()) == N_SLICE,
          f"counts {res.class_counts}")
    pur = purity(res.assignments, cls, HEADLINE["k"])
    log(f"slice: mref_ali2d N={N_SLICE} 90px K=8 ou=36 xr=yr=3 maxit={MAXIT}:"
        f" {seconds:.2f} s, {seconds / MAXIT:.3f} s/iteration, "
        f"{N_SLICE * MAXIT / seconds:.0f} particles/s, purity {pur:.4f}, "
        f"counts {res.class_counts.tolist()}  [{card}]")
    check(pur >= 0.9, f"class purity {pur}")
    mref_s_it = seconds / MAXIT
    mref_params, mref_assign = res.params, res.assignments

    # ---- 6b. mref at K=64
    imgs64, cls64 = scattered_stack(tmpl64, N_SLICE, max_shift=2, noise=1.0,
                                    seed=11, device=dev)[:2]
    res, seconds = main_path(f"mref K={K_LARGE}", lambda: mref_ali2d(
        imgs64, tmpl64, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
        yr=HEADLINE["xr"], ts=1, maxit=2, device=dev,
        log=RunLogger(None, quiet=True)),
        {"search": 2}, entry="search_k64")
    check(bool(np.isfinite(res.params).all()
               and np.isfinite(res.references).all()), "K=64: NaN")
    check(int(res.class_counts.sum()) == N_SLICE, "K=64: counts")
    log(f"mref_ali2d N={N_SLICE} K={K_LARGE} maxit=2: {seconds:.2f} s, "
        f"{seconds / 2:.3f} s/iteration, {2 * N_SLICE / seconds:.0f} "
        f"particles/s, purity {purity(res.assignments, cls64, K_LARGE):.4f}"
        f"  [{card}]")
    # kept for phase 13d, which splits these 64 references over two ranks
    one64, one64_s_it = res, seconds / 2
    stack64_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_k64_")
    stack64 = os.path.join(stack64_tmp.name, "stack64.npy")
    np.save(stack64, imgs64.cpu().numpy())
    del imgs64

    # ---- 7. the reference-free main paths
    rf_kw = dict(ou=HEADLINE["ou"], xr=HEADLINE["xr"], yr=HEADLINE["xr"],
                 ts=1.0, center=-1, dst=DST, device=dev,
                 log=RunLogger(None, quiet=True))
    for label, mirror, maxit, expect in (
            ("reffree A", True, 11, {"search": 10, "search_masked": 1}),
            ("reffree B", False, 6, {"search_nomirror": 6}),
            ("reffree C", False, 11, {"search_nomirror": 10,
                                      "search_nomirror_masked": 1})):
        stack, _, _, _, mir = scattered_stack(
            tmpl1, N_SLICE, max_shift=2, noise=1.0, seed=12, device=dev,
            mirror=mirror)
        res, seconds = main_path(label, lambda: ali2d_base(
            stack, maxit=maxit, nomirror=not mirror, **rf_kw), expect)
        check(res.iterations == maxit, f"{label}: {res.iterations} iterations")
        check(bool(np.isfinite(res.params).all()
                   and np.isfinite(res.average).all()
                   and np.isfinite(res.criteria).all()), f"{label}: NaN")
        check(int(res.class_counts.sum()) == N_SLICE, f"{label}: counts")
        flip = float((res.params[:, 3] == mir).mean())
        log(f"{label}: ali2d_base N={N_SLICE} 90px ou=36 xr=yr=3 ts=1 "
            f"{'mirror' if mirror else 'nomirror'} dst={DST:g} "
            f"maxit={maxit}: {seconds:.2f} s, {seconds / maxit:.3f} "
            f"s/iteration, {N_SLICE * maxit / seconds:.0f} particles/s; "
            f"criteria {res.criteria[0]:.6e} -> {res.criteria[-1]:.6e}; "
            f"mirror flags matching the truth up to a global flip "
            f"{max(flip, 1.0 - flip):.4f}; last mirror consistency "
            f"{res.mirror_consistency[-1]:.4f}, pixel error "
            f"{res.pixel_errors[-1]:.4f}  [{card}]")
        if label == "reffree A":
            check(res.criteria[-1] >= 0.5 * res.criteria[0],
                  f"{label}: criterion fell to {res.criteria[-1]}")
            stack_a, mir_a, reffree_a = stack, mir, res
            reffree_a_s_it = seconds / maxit
        del stack

    slice_json = {"card": card, "n": N_SLICE}
    # ---- 7b. one headline align_step by stage, and the host part of
    # a phase-6 mref_ali2d iteration
    slice_json["align_step_ms"] = stage_breakdown(imgs, tmpl, cfg, dev)
    step_ms = slice_json["align_step_ms"]["align_step"]
    slice_json["mref_ali2d_s_per_iteration"] = mref_s_it
    slice_json["mref_ali2d_host_ms"] = 1e3 * mref_s_it - step_ms
    # ---- 7c. the class-sum kernel at the main paths' shapes
    sums_rows = class_sums_phase(dev, card)
    log(f"align_step N={N_SLICE} 90px K=8 by stage (CUDA events, mean of "
        f"3): {json.dumps(slice_json['align_step_ms'])}; mref_ali2d "
        f"iteration (phase 6) {1e3 * mref_s_it:.2f} ms, so its host part "
        f"(reference update, transfers, outputs) "
        f"{slice_json['mref_ali2d_host_ms']:.2f} ms  [{card}]")

    # ---- 8. the device loops
    zeros = AlignParams.zeros(N_SLICE, dev)
    gidx = torch.arange(N_SLICE, device=dev)
    valid = torch.ones(N_SLICE, device=dev)
    refs0 = torch.as_tensor(tmpl, device=dev)
    mref_loop = make_mref_device_loop(cfg, MAXIT, HEADLINE["k"],
                                      np.full(MAXIT, 0.25), device=dev)
    (p_loop, refs_loop), _ = main_path(
        "mref loop", lambda: mref_loop(imgs, refs0, zeros, gidx, valid),
        {"search": MAXIT})
    loop_checks("mref loop", p_loop, refs_loop, HEADLINE["k"], cls)
    _, med = time_loop("mref loop", mref_loop,
                       (imgs, refs0, zeros, gidx, valid), MAXIT)
    slice_json["mref_loop"] = loop_line(
        "mref loop K=8", med, MAXIT, mref_s_it, card)

    n_rf = 10
    (p_rf, avg_rf), _ = main_path(
        "reffree loop", lambda: ref_free_alignment_2d(
            stack_a, n_iter=n_rf, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
            ts=1.0, cutoff=0.25, device=dev), {"search": n_rf})
    loop_checks("reffree loop", AlignParams(*map(torch.as_tensor, p_rf)),
                torch.as_tensor(avg_rf), 1, None)
    flip = float((p_rf.mirror == mir_a).mean())
    log(f"reffree loop: mirror flags matching the truth up to a global flip "
        f"{max(flip, 1.0 - flip):.4f}")
    rf_loop = make_device_loop(cfg, n_rf, np.full(n_rf, 0.25), device=dev)
    _, med = time_loop("reffree loop", rf_loop,
                       (stack_a, stack_a.mean(0), zeros, gidx, valid), n_rf)
    slice_json["reffree_loop"] = loop_line(
        "reffree loop K=1", med, n_rf, None, card)

    # ---- 9. the command line on files (kept for phase 13)
    cli_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    slice_json["cli"] = cli_phase(cli_tmp.name, imgs, tmpl, cls, stack_a,
                                  main_path, card)

    # ---- 10. the alignment modes
    slice_json["modes"] = modes_phase(dev, card, main_path, imgs, tmpl, cls,
                                      stack_a, mir_a, tmpl1)

    # ---- 11. stacks larger than the card
    slice_json["streaming"] = streaming_phase(dev, card, main_path, imgs,
                                              tmpl, cls, stack_a)

    # ---- 12. after the alignment: nothing in 12a-12e searches
    with tempfile.TemporaryDirectory(prefix="chip_smoke_post_") as tmp:
        post, seconds = main_path("post-alignment", lambda: (
            post_alignment_phase(dev, card, tmp, imgs, tmpl, cls,
                                 mref_params, mref_assign)), NO_LAUNCH)
        post["seconds"] = seconds
        post["bdb"] = bdb_phase(tmp, stack_a, main_path, card)
    slice_json["post_alignment"] = post
    log(f"phase 12: {seconds:.1f} s without the bdb: run")

    # ---- 13. two ranks, a process each
    slice_json["mesh"] = mesh_phase(dev, card, cli_tmp.name, imgs, tmpl,
                                    stack_a, reffree_a, p_loop, launches)
    # ---- 13d. the 2-D mesh: K=64 split over two ranks
    slice_json["mesh2d"] = mesh2d_phase(card, cli_tmp.name, stack64, tmpl64,
                                        one64, one64_s_it, p_loop, launches)
    cli_tmp.cleanup()
    stack64_tmp.cleanup()

    # ---- 14. the template engine: no search-kernel launch on its paths
    modes = slice_json["modes"]
    slice_json["template"] = template_phase(
        dev, card, main_path, imgs, tmpl, cls, stack_a, tmpl1, tmpl64,
        {"k8": times["search"][0], "k1": times["search_k1"][0],
         "k64": times["search_k64"][0]},
        {"mref_s_it": mref_s_it, "mref_assign": mref_assign,
         "shc_s_it": modes["reffree_shc"]["s_per_iteration"],
         "eman2_s_it": modes["mref_eman2"]["s_per_iteration"],
         "loop_s_it": slice_json["mref_loop"]["s_per_iteration"]})

    # ---- 15. the FFT shear and the matmul sampler: no search-kernel
    # launch on their paths
    tmpl_searches = slice_json["template"]["searches"]
    slice_json["matmul"] = matmul_phase(
        dev, card, main_path, imgs, tmpl, cls, stack_a, tmpl1, tmpl64,
        {"mref_s_it": mref_s_it, "reffree_a_s_it": reffree_a_s_it,
         "shc_s_it": modes["reffree_shc"]["s_per_iteration"],
         "scf_s_it": modes["reffree_scf"]["s_per_iteration"],
         "eman2_s_it": modes["mref_eman2"]["s_per_iteration"],
         "fourvar_s_it": modes["reffree_fourvar"]["s_per_iteration"],
         "template_mref_s_it":
             slice_json["template"]["mref"]["s_per_iteration"],
         "kernel_ms": {"k8": times["search"][0], "k1": times["search_k1"][0],
                       "k64": times["search_k64"][0]},
         "template_ms": {key: tmpl_searches[key]["ms"]
                         for key in ("k8", "k1", "k64")}})
    del imgs, stack_a

    shapes = {   # entry -> (timing key, K, mirror channels, mask)
        "search": ("search", HEADLINE["k"], 2, 0),
        "search_nomirror": ("search_nomirror_k1", 1, 1, 0),
        "search_masked": ("search_masked_k1", 1, 2, 1),
        "search_nomirror_masked": ("search_nomirror_masked_k1", 1, 1, 1),
        "search_k64": ("search_k64", K_LARGE, 2, 0),
        "search_k32": ("search_k32", K_SPLIT, 2, 0),
        "search_shc": ("search_shc_k1", 1, 2, 0),
    }
    # the SHC pick runs a share of the shift groups: its bound is the K=1
    # search's times the share at the timed threshold (0.98 x each
    # particle's exhaustive peak)
    shc = {"group_share": shc_runs["0.98 x peak"]["group_share"],
           "by_previousmax": shc_runs}
    records = []
    for name, (tkey, k, n_mirr, masked) in shapes.items():
        bound_ms, bound_by = search_bound(
            N_SLICE, HEADLINE["nx"], HEADLINE["ou"], cfg.n_shifts, k, n_mirr)
        pick = int(name == "search_shc")
        if pick:
            bound_ms *= shc["group_share"]
        log(f"{name}: bound {bound_ms:.3f} ms ({bound_by})")
        by_path = launches.get(name, {})
        plan = fs.kernel_plan(HEADLINE["ou"], n_mirr == 2, k, cfg.n_shifts,
                              HEADLINE["nx"], HEADLINE["nx"])
        check(sum(by_path.values()) > 0, f"{name}: no launch on a main path")
        max_err = max(errs) if name == "search" else max(var_errs[name])
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": VARIANT_REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_err, "ms": times[tkey][0],
            "plain_ms": times[tkey][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "n": N_SLICE, "k": k,
            "ms_n512": times[tkey][2], "plain_ms_n512": times[tkey][3],
            **regs[(n_mirr, masked, 1 if k == 1 else 8, 0, pick)],
            "smem_bytes": plan["smem_bytes"], "shift_group": plan["group"],
            "image_in_smem": plan["image_in_smem"],
            **(shc if pick else {})})
    k1 = times["search_k1"]
    log(f"search default variant at K=1 (reffree unmasked iterations): "
        f"kernel {k1[0]:.2f} ms, plain {k1[1]:.2f} ms at N={N_SLICE}; "
        f"{k1[2]:.3f} / {k1[3]:.3f} ms at N={N_CHECK}  [{card}]")
    slice_json["mode_h_kernel_ms"] = {
        name: dict(zip(("ms", "plain_ms", "ms_n512", "plain_ms_n512"),
                       times[name]))
        for name in ("search_mode_h", "search_mode_h_k1",
                     "search_mode_h_k1_one_shift")}
    print(json.dumps({"slice": slice_json}))
    print(json.dumps(ablation))
    log(card)
    print(json.dumps({"kernels": records}))
    check(sum(sums_launches.values()) > 0,
          "class sums: no launch on a main path")
    print(json.dumps({"class_sums": {
        "name": "class_sums", "route": "cuda",
        "source": "cryo_ralib_tpu_torch/csrc/class_sums.cu",
        "replaces": None, "launches": sum(sums_launches.values()),
        "launches_by_path": sums_launches, "shapes": sums_rows,
        "ptxas": cs_regs,
        "smem_bytes": ca.build().cryo_class_sums_smem(HEADLINE["nx"],
                                                       HEADLINE["nx"])}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
