#!/usr/bin/env python3
"""Stage ablation of the PyTorch port's CUDA search kernel, in several
checkouts, one process each, in the order given, on one GPU.

    python3 tools/torch_search_ablate.py PARENT_DIR . . PARENT_DIR

The counterpart of ``tools/fused_ablate.py`` (the TPU kernel's).  Each
directory is a checkout of this repository whose
``cryo_ralib_tpu_torch/ops/fused_search.py`` has ``fused_search_stage``.
Its own package builds the kernel and searches the same seeded stacks at
the headline geometry (90 px, ou=36, xr=yr=3, ts=1, 49 shifts), N=16384,
at K=8 (asymmetric templates), K=64 (unit-sigma blob templates) and K=1
(one asymmetric template: the reference-free shape, ref groups of one
and four shifts a group): the production search ("full") and each
ablated stage, milliseconds per launch from CUDA events (3 launches
after a warm-up).  A checkout whose stages refuse K=1 reports them as
null there.  Stages:

  no_ccf       skips the forward DFT and the ccf; the inverse DFT and the
               argmax run on zero spectra;
  sample_only  the polar samples only, with a max-only dummy output;
  no_yred      bilinear reads from the top row only (x interpolation,
               no second pair of gathers).

Deltas rank the stages; they do not add up, since stages overlap on the
card.  The templates are made once, here, and handed to every checkout.
After the checkouts, the script times ``torch.fft.rfft`` over the
same (N x 49 x 36, 256) rings in chunks, the forward DFT's library
yardstick (the port never calls it).  One JSON line per run, with the
card and its power limit; compare runs only within one call.
"""

import io
import json
import subprocess
import sys
from pathlib import Path

N, NX, OU, XR = 16384, 90, 36, 3.0

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

templates = np.load(io.BytesIO(sys.stdin.buffer.read()))
N, NX, OU, XR = %d, %d, %d, %r
dev = torch.device("cuda")
fs.build()
ptxas = [l.strip() for l in kernels.build_log["search"]["ptxas"].splitlines()
         if "registers" in l or "spill" in l or "entry function" in l]
cfg = AlignConfig(img_dim=NX, ring_num=OU, shift_step=1.0, shift_rng_x=XR,
                  shift_rng_y=XR)
params = AlignParams.zeros(N, dev)


def ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


out = {}
for k in (8, 64, 1):
    tmpl = templates["k%%d" %% k]
    imgs = scattered_stack(tmpl, N, max_shift=2, noise=1.0, seed=7,
                           device=dev)[0].contiguous()
    rfw = prepare_ref_spectra(torch.as_tensor(tmpl, device=dev), cfg)
    row = {"full": ms(lambda: fs.fused_search(imgs, rfw, params, cfg))}
    for stage in ("no_ccf", "sample_only", "no_yred"):
        before = dict(fs.fused_search.launches)
        try:
            row[stage] = ms(lambda: fs.fused_search_stage(imgs, rfw, params,
                                                           cfg, stage))
        except ValueError:   # a checkout whose stages take K > 1 only
            row[stage] = None
        assert fs.fused_search.launches == before, "a stage counted as search"
    out["k%%d" %% k] = row
    del imgs
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(json.dumps({"card": card, "ptxas": ptxas, "n": N, **out}))
''' % (N, NX, OU, XR)


def templates() -> bytes:
    """The K=8, K=64 and K=1 templates as one .npz, from this checkout's
    package, so that every checkout times the same inputs."""
    import numpy as np

    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      unit_sigma_blobs)

    buf = io.BytesIO()
    np.savez(buf, k8=asymmetric_templates(8, NX),
             k64=unit_sigma_blobs(64, NX), k1=asymmetric_templates(1, NX))
    return buf.getvalue()


def rfft_ms(chunk_rings=1 << 20):
    """Milliseconds of torch.fft.rfft over N x S x R rings of 256 f32
    samples, in chunks of ``chunk_rings`` (one buffer, reused)."""
    import torch

    from cryo_ralib_tpu_torch.config import AlignConfig

    cfg = AlignConfig(img_dim=NX, ring_num=OU, shift_step=1.0,
                      shift_rng_x=XR, shift_rng_y=XR)
    total = N * cfg.n_shifts * OU
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((chunk_rings, 256), generator=gen, device="cuda")
    chunks = [chunk_rings] * (total // chunk_rings)
    if total % chunk_rings:
        chunks.append(total % chunk_rings)

    def run():
        for c in chunks:
            torch.fft.rfft(x[:c], dim=-1)

    run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), total


def main(dirs):
    if not dirs:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    data = templates()
    for d in dirs:
        root = Path(d).resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                              input=data, capture_output=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stderr.decode()[-4000:]}")
        rec = json.loads(proc.stdout.decode().strip().splitlines()[-1])
        print(json.dumps({"checkout": str(d), **rec}), flush=True)
    ms, rings = rfft_ms()
    print(json.dumps({"library": "torch.fft.rfft", "rings": rings,
                      "ring_len": 256, "chunk_rings": 1 << 20, "ms": ms}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
