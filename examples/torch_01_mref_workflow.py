"""End-to-end multireference alignment on the PyTorch/CUDA port
(notebook 00 equivalent).

The port's counterpart of ``examples/01_mref_workflow.py``: generates a
synthetic particle stack from known class templates, writes EMAN2-HDF
files (the port's own HDF5 writer, no h5py), runs ``mref_ali2d`` and
scores class recovery.  ``--sampler`` picks the search: ``auto`` (the
CUDA kernel on the GPU, its plain PyTorch version on the CPU),
``template`` (the search as bf16 matrix products) or ``matmul`` (the
polar samples as bf16 tent products); the last two sum their classes by
the FFT shear, as the JAX package does with them.

    python examples/torch_01_mref_workflow.py [outdir]          # on the GPU
    python examples/torch_01_mref_workflow.py --sampler=matmul
    python examples/torch_01_mref_workflow.py --device=cpu --n=48 --nx=48
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from cryo_ralib_tpu_torch.analysis import purity_score
from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf, write_hdf_stack
from cryo_ralib_tpu_torch.models.engine import resolve_device
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (class_templates,
                                                  scattered_stack)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("outdir", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sampler", default="auto",
                   choices=["auto", "kernel", "plain", "template", "matmul"])
    p.add_argument("--n", type=int, default=512, help="particles")
    p.add_argument("--nx", type=int, default=90, help="box size")
    p.add_argument("--k", type=int, default=4, help="classes")
    p.add_argument("--maxit", type=int, default=4)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    outdir = args.outdir or tempfile.mkdtemp(prefix="torch_mref_")
    os.makedirs(outdir, exist_ok=True)
    k, nx, n = args.k, args.nx, args.n
    ou = min(36, nx // 2 - 6)

    print(f"generating {n} particles from {k} templates ...")
    refs = class_templates(k, nx)
    imgs, cls, angs = scattered_stack(refs, n, max_shift=3, seed=11)[:3]
    imgs = imgs.numpy()
    write_hdf_stack(f"{outdir}/stack.hdf", imgs)
    write_hdf_stack(f"{outdir}/refs.hdf", refs)

    print(f"aligning on {dev} (sampler={args.sampler}) ...")
    res = mref_ali2d(imgs, refs.copy(), outdir=f"{outdir}/run", ou=ou, xr=3,
                     yr=3, ts=1, maxit=args.maxit, device=dev,
                     sampler=args.sampler, log=RunLogger(None, quiet=True))

    purity = purity_score(cls, res.assignments)
    print(f"class purity: {purity:.3f}")
    # class-k templates are (2+k)-fold rotationally symmetric, so angles
    # are recoverable only modulo 360/(2+k)
    period = 360.0 / (2.0 + cls)
    d = np.abs(res.params[:, 0] - (360.0 - angs) % 360.0) % period
    d = np.minimum(d, period - d)
    print(f"median |angle error| (mod template symmetry): "
          f"{np.median(d):.2f} deg")
    print(f"class counts: {res.class_counts}")

    last = f"{outdir}/run/aqm{args.maxit - 1:03d}.hdf"
    avgs, _ = read_own_hdf(last)
    print(f"final class averages: {avgs.shape} -> {last}")
    return res, purity, avgs


if __name__ == "__main__":
    main()
