#!/usr/bin/env python3
"""Time the PyTorch port's CUDA search kernel in several checkouts, one
process each, in the order given, on one GPU.

    python3 tools/torch_search_ab.py PARENT_DIR . . PARENT_DIR

Each directory is a checkout of this repository (for example a parent
commit unpacked with ``git archive`` into a git-ignored directory).  Its
own ``cryo_ralib_tpu_torch`` builds the kernel and searches the same
seeded stack: the headline geometry (90 px, ou=36, xr=yr=3, ts=1) at K=8
and at K=1, N=16384, default variant (mirrored, unmasked).  Prints one
JSON line per run with the card, the kernel's ptxas register lines and
the milliseconds per launch (CUDA events, 5 launches after a warm-up).
Compare runs only within one call of this script.
"""

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, re, subprocess
import numpy as np
import torch
from cryo_ralib_tpu_torch import kernels
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.ops.search import prepare_ref_spectra
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack)

dev = torch.device("cuda")
fs.build()
ptxas = [l.strip() for l in kernels.build_log["search"]["ptxas"].splitlines()
         if "registers" in l or "entry function" in l]
cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0, shift_rng_x=3.0,
                  shift_rng_y=3.0)
out = {}
for k in (8, 1):
    tmpl = asymmetric_templates(k, 90)
    imgs = scattered_stack(tmpl, 16384, max_shift=2, noise=1.0, seed=7,
                           device=dev)[0].contiguous()
    params = AlignParams.zeros(16384, dev)
    rfw = prepare_ref_spectra(torch.as_tensor(tmpl, device=dev), cfg)
    fs.fused_search(imgs, rfw, params, cfg)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        fs.fused_search(imgs, rfw, params, cfg)
    b.record()
    torch.cuda.synchronize()
    out["ms_k%d" % k] = a.elapsed_time(b) / 5
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(json.dumps({"card": card, "ptxas": ptxas, **out}))
'''


def main(dirs):
    if not dirs:
        raise SystemExit(__doc__)
    for d in dirs:
        root = Path(d).resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": str(d), **rec}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
