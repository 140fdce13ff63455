#!/usr/bin/env python3
"""Time the PyTorch port's CUDA search kernel in several checkouts, one
process each, in the order given, on one GPU.

    python3 tools/torch_search_ab.py PARENT_DIR . . PARENT_DIR
    python3 tools/torch_search_ab.py --cases 160px_k4,256px_k8 A_DIR B_DIR

Each directory is a checkout of this repository (for example a parent
commit unpacked with ``git archive`` into a git-ignored directory).  Its
own ``cryo_ralib_tpu_torch`` builds the kernel and searches the same
seeded stacks, default variant (mirrored, unmasked), shift_step 1:

  k8        90 px, ou=36, xr=yr=3, K=8 asymmetric templates, N=16384
            (the headline geometry)
  k1        the same at K=1
  k64       the same at K=64, unit-sigma blob templates
  160px_k4  160 px, ou=48, xr=yr=2, K=4, N=8192 (the bench's 160 px box)
  160px_k1  the same at K=1
  256px_k8  256 px, ou=100, xr=yr=2, K=8, N=4096 (the bench's 256 px box)

The templates are made once, here, and handed to every checkout, so all
of them time the same inputs.  Prints one JSON line per run with the
card, the kernel's ptxas register lines, each case's launch plan (where
the checkout reports one) and the milliseconds per launch (CUDA events,
5 launches after a warm-up).  Compare runs only within one call of this
script.
"""

import argparse
import io
import json
import subprocess
import sys
from pathlib import Path

# name -> (img_dim, ring_num, xr, refs, templates, particles)
CASES = {
    "k8": (90, 36, 3.0, 8, "asymmetric", 16384),
    "k1": (90, 36, 3.0, 1, "asymmetric", 16384),
    "k64": (90, 36, 3.0, 64, "blobs", 16384),
    "160px_k4": (160, 48, 2.0, 4, "asymmetric", 8192),
    "160px_k1": (160, 48, 2.0, 1, "asymmetric", 8192),
    "256px_k8": (256, 100, 2.0, 8, "asymmetric", 4096),
}

CHILD = r'''
import io, json, subprocess, sys
import numpy as np
import torch
from cryo_ralib_tpu_torch import kernels
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.ops.search import prepare_ref_spectra
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

cases = json.loads(sys.argv[1])
templates = np.load(io.BytesIO(sys.stdin.buffer.read()))
dev = torch.device("cuda")
fs.build()
ptxas = [l.strip() for l in kernels.build_log["search"]["ptxas"].splitlines()
         if "registers" in l or "entry function" in l]
out = {}
for name, (nx, ou, xr, k, _, n) in cases.items():
    cfg = AlignConfig(img_dim=nx, ring_num=ou, shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr)
    tmpl = templates[name]
    imgs = scattered_stack(tmpl, n, max_shift=2, noise=1.0, seed=7,
                           device=dev)[0].contiguous()
    params = AlignParams.zeros(n, dev)
    rfw = prepare_ref_spectra(torch.as_tensor(tmpl, device=dev), cfg)
    if hasattr(fs, "kernel_plan"):
        out["plan_" + name] = fs.kernel_plan(ou, True, k, cfg.n_shifts, nx, nx)
    fs.fused_search(imgs, rfw, params, cfg)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        fs.fused_search(imgs, rfw, params, cfg)
    b.record()
    torch.cuda.synchronize()
    out["ms_" + name] = a.elapsed_time(b) / 5
    del imgs
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(json.dumps({"card": card, "ptxas": ptxas, **out}))
'''


def templates(cases) -> bytes:
    """The cases' templates as one .npz, from this checkout's package."""
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      unit_sigma_blobs)

    arrays = {}
    for name, (nx, _, _, k, kind, _) in cases.items():
        arrays[name] = (unit_sigma_blobs(k, nx) if kind == "blobs"
                        else asymmetric_templates(k, nx))
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated case names (default: all)")
    ap.add_argument("dirs", nargs="+", help="checkouts, timed in this order")
    args = ap.parse_args(argv)
    names = args.cases.split(",")
    unknown = sorted(set(names) - set(CASES))
    if unknown:
        raise SystemExit(f"unknown cases {unknown}; known: {sorted(CASES)}")
    cases = {name: CASES[name] for name in names}
    data = templates(cases)
    for d in args.dirs:
        root = Path(d).resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(cases)],
                              cwd=root, input=data, capture_output=True,
                              timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stderr.decode()[-4000:]}")
        rec = json.loads(proc.stdout.decode().strip().splitlines()[-1])
        print(json.dumps({"checkout": str(d), **rec}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
