#!/usr/bin/env python3
"""Time the PyTorch port's alignment drivers and one alignment step in
several checkouts, one process each, in the order given, on one GPU.

    python3 tools/torch_driver_ab.py PARENT_DIR . . PARENT_DIR

Each directory is a checkout of this repository (for example a parent
commit unpacked with ``git archive`` into a git-ignored directory).  Its
own ``cryo_ralib_tpu_torch`` builds the kernel and runs, on the same
seeded 90 px stacks of 16384 particles (ou=36, xr=yr=3, ts=1; the
templates are made once, here, and handed to every checkout):

  step     one ``align_step`` at K=8: CUDA-event ms (mean of 3 after a
           warm-up) and its peak device memory (``max_memory_allocated``
           over the step, the images, refs and params included)
  mref     ``mref_ali2d`` K=8, maxit=6: s/iteration, median of 3 calls
  reffree  ``ali2d_base`` K=1, center=-1, dst=15, maxit=11 (reffree A
           of chip_smoke.py): s/iteration, median of 3 calls

Each driver is called once to warm up before it is timed.  Prints one
JSON line per checkout with the card.  Compare runs only within one call
of this script.
"""

import io
import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import io, json, subprocess, sys, time
import numpy as np
import torch
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.models.reffree import ali2d_base
from cryo_ralib_tpu_torch.models.steps import align_step
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import scattered_stack

N = 16384
tmpl = np.load(io.BytesIO(sys.stdin.buffer.read()))
tmpl8, tmpl1 = tmpl["k8"], tmpl["k1"]
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
fs.build()
imgs = scattered_stack(tmpl8, N, max_shift=2, noise=1.0, seed=7,
                       device=dev)[0].contiguous()
stack_a = scattered_stack(tmpl1, N, max_shift=2, noise=1.0, seed=12,
                          device=dev)[0].contiguous()
cfg = AlignConfig(img_dim=90, ring_num=36, shift_step=1.0, shift_rng_x=3.0,
                  shift_rng_y=3.0)
out = {}

refs = torch.as_tensor(tmpl8, device=dev)
zeros = AlignParams.zeros(N, dev)
gidx = torch.arange(N, device=dev)
def step():
    return align_step(imgs, refs, zeros, gidx, None, cfg, n_classes=8)
step()
torch.cuda.synchronize()
held = (imgs.nbytes + refs.nbytes + gidx.nbytes
        + sum(f.nbytes for f in zeros))
base = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
step()
torch.cuda.synchronize()
out["step_peak_bytes"] = torch.cuda.max_memory_allocated() - base + held
a = torch.cuda.Event(enable_timing=True)
b = torch.cuda.Event(enable_timing=True)
a.record()
for _ in range(3):
    step()
b.record()
torch.cuda.synchronize()
out["step_ms"] = a.elapsed_time(b) / 3

def timed(fn, n_iter):
    fn(1)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n_iter)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / n_iter)
    return float(np.median(times)), times

quiet = RunLogger(None, quiet=True)
out["mref_s_per_iteration"], out["mref_runs"] = timed(
    lambda it: mref_ali2d(imgs, tmpl8, ou=36, xr=3.0, yr=3.0, ts=1,
                          maxit=it, device=dev, log=quiet), 6)
out["reffree_s_per_iteration"], out["reffree_runs"] = timed(
    lambda it: ali2d_base(stack_a, ou=36, xr=3.0, yr=3.0, ts=1.0,
                          center=-1, dst=15.0, maxit=it, device=dev,
                          log=quiet), 11)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(json.dumps({"card": card, **out}))
'''


def templates() -> bytes:
    """The K=8 and K=1 templates as one .npz, from this checkout's
    package."""
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from cryo_ralib_tpu_torch.utils.synthetic import asymmetric_templates

    buf = io.BytesIO()
    np.savez(buf, k8=asymmetric_templates(8, 90),
             k1=asymmetric_templates(1, 90))
    return buf.getvalue()


def main(argv):
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit(__doc__)
    data = templates()
    for d in argv:
        root = Path(d).resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                              input=data, capture_output=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stderr.decode()[-4000:]}")
        rec = json.loads(proc.stdout.decode().strip().splitlines()[-1])
        print(json.dumps({"checkout": str(d), **rec}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
