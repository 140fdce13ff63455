#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``cryo_ralib_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU
and the CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card, its power limit and the versions;
  2. build the search kernel (csrc/search.cu, nvcc for sm_90a);
  3. kernel vs its plain PyTorch version at 90 px / ou=36 / K=8 / xr=3
     and 160 px / ou=48 / K=4 / xr=2, 512 particles with integer and
     fractional accumulated shifts: structured stacks must give identical
     winners, pure noise may differ on at most 1% of particles, and
     then only between peaks within 1e-5 relative; peak values within
     1e-4 of the largest, decoded params within 1e-3;
  4. mref_ali2d through the kernel and through the plain search agree
     on a small stack;
  5. kernel and plain timed (CUDA events) at the main path's shape;
  6. the main path: mref_ali2d on 16384 synthetic 90 px particles, K=8,
     ou=36, xr=yr=3, 6 iterations, through the kernel (its launch count
     must rise by exactly 6); counts sum to N, nothing is NaN, class
     purity against the known labels >= 0.9.
The last two lines are the kernels' JSON record and the run's verdict.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HEADLINE = dict(nx=90, ou=36, xr=3.0, k=8)
BIG_BOX = dict(nx=160, ou=48, xr=2.0, k=4)
N_CHECK = 512
N_SLICE = 16384
MAXIT = 6
SOURCE = "cryo_ralib_tpu_torch/csrc/search.cu"
REPLACES = "cryo_ralib_tpu/ops/fused_search.py:129"


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


def geometry(geom):
    from cryo_ralib_tpu_torch.config import AlignConfig

    return AlignConfig(img_dim=geom["nx"], ring_num=geom["ou"],
                       shift_step=1.0, shift_rng_x=geom["xr"],
                       shift_rng_y=geom["xr"])


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


def make_case(geom, n, kind, seed, dev):
    from cryo_ralib_tpu_torch.ops.search import prepare_ref_spectra
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      scattered_stack)

    nx = geom["nx"]
    refs = asymmetric_templates(geom["k"], nx)
    if kind == "structured":
        imgs = scattered_stack(refs, n, max_shift=1, noise=0.1, seed=seed,
                               device=dev)[0]
    else:
        rng = np.random.default_rng(seed)
        imgs = torch.as_tensor(
            rng.standard_normal((n, nx, nx), dtype=np.float32), device=dev)
    cfg = geometry(geom)
    rfw = prepare_ref_spectra(torch.as_tensor(refs, device=dev), cfg)
    return cfg, imgs.contiguous(), rfw, acc_params(n, seed + 1, dev)


def compare(cfg, imgs, rfw, params, kind, label):
    """Kernel vs plain on one input; returns max |best_val| difference."""
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops.search import decode_params

    shift_chunk = 8 if imgs.shape[0] <= 4096 else 1
    got = fs.fused_search(imgs, rfw, params, cfg)
    want = fs.search_plain(imgs, rfw, params, cfg, shift_chunk=shift_chunk)
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
            check(float(rel.max()) <= 1e-5, f"{label}: rel {rel.max()}")
    check(err <= 1e-4 * scale, f"{label}: best_val off by {err}")
    check(bool(torch.isfinite(got.best_row).all()), f"{label}: rows")
    p_got = decode_params(got, params, cfg)
    p_want = decode_params(want, params, cfg)
    d = (p_got.angle - p_want.angle).abs()[same]
    d = torch.minimum(d, 360.0 - d)
    check(float(d.max()) < 1e-3, f"{label}: angle off by {float(d.max())}")
    for f in ("shift_x", "shift_y"):
        check(torch.equal(getattr(p_got, f)[same], getattr(p_want, f)[same]),
              f"{label}: decoded {f} differs")
    return err


def purity(assign, truth, k):
    hits = 0
    for j in range(k):
        members = truth[assign == j]
        if members.size:
            hits += np.bincount(members, minlength=k).max()
    return hits / truth.size


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
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops.search import prepare_ref_spectra
    from cryo_ralib_tpu_torch.utils.log import RunLogger
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      scattered_stack)

    # ---- 2. build
    fs.build()
    info = kernels.build_log["search"]
    log(f"build: search kernel in {info['seconds']:.2f} s "
        f"(cached={info['cached']})")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas: " + line.strip())

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

    # ---- 4. mref_ali2d: kernel path vs plain path on a small stack
    tmpl = asymmetric_templates(HEADLINE["k"], HEADLINE["nx"])
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
    ms = cuda_ms(lambda: fs.fused_search(imgs, rfw, params, cfg), 3)
    ms_small = cuda_ms(lambda: fs.fused_search(
        imgs[:N_CHECK].contiguous(), rfw, params._replace(
            shift_x=params.shift_x[:N_CHECK].contiguous(),
            shift_y=params.shift_y[:N_CHECK].contiguous()), cfg), 10)
    plain_ms = cuda_ms(lambda: fs.search_plain(imgs, rfw, params, cfg,
                                               shift_chunk=1), 1)
    plain_small = cuda_ms(lambda: fs.search_plain(
        imgs[:N_CHECK], rfw, params._replace(
            shift_x=params.shift_x[:N_CHECK],
            shift_y=params.shift_y[:N_CHECK]), cfg), 3)
    log(f"search 90px K=8 S=49: kernel {ms:.2f} ms, plain {plain_ms:.2f} ms "
        f"at N={N_SLICE}; kernel {ms_small:.3f} ms, plain "
        f"{plain_small:.3f} ms at N={N_CHECK}  [{card}]")

    # ---- 6. the main path
    fs.fused_search.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mref_ali2d(imgs, tmpl, ou=HEADLINE["ou"], xr=HEADLINE["xr"],
                     yr=HEADLINE["xr"], ts=1, maxit=MAXIT, device=dev,
                     log=RunLogger(None, quiet=True))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fs.fused_search.launches
    check(launches == MAXIT, f"kernel launched {launches} times, not {MAXIT}")
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

    print(json.dumps({"kernels": [{
        "name": "search", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
