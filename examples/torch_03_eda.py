"""Exploratory analysis of alignment results on the PyTorch/CUDA port
(notebook 03).

The port's counterpart of ``examples/03_eda.py``: aligns a synthetic
stack with ``mref_ali2d``, applies the params with ``rot_shift2d``,
reduces the aligned images with TwoSDR and MPCA and clusters the factors
with a small k-means, reporting purity against the generating classes.
Everything runs on ``--device`` (the GPU by default).

    python examples/torch_03_eda.py
    python examples/torch_03_eda.py --device=cpu --n=120
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from cryo_ralib_tpu_torch.analysis import (MPCA, TwoSDR, c_purity_score,
                                           purity_score)
from cryo_ralib_tpu_torch.io.dataset import aligned_stack
from cryo_ralib_tpu_torch.models import mref_ali2d
from cryo_ralib_tpu_torch.models.engine import resolve_device
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (class_templates,
                                                  scattered_stack)


def kmeans(x, k, iters=50, seed=0):
    """Tiny k-means (no sklearn dependency)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        lab = d.argmin(1)
        for j in range(k):
            if (lab == j).any():
                centers[j] = x[lab == j].mean(0)
    return lab


def reduce_and_cluster(aligned, cls, k, device):
    """TwoSDR(20, 20, 8) and MPCA(10, 10) of the aligned stack, each
    clustered by k-means; returns the purities."""
    factors, *_ = TwoSDR(aligned, 20, 20, 8, device=device)
    lab = kmeans(factors, k, seed=0)
    core, *_ = MPCA(aligned, 10, 10, device=device)
    lab2 = kmeans(core, k, seed=0)
    return {"twosdr": purity_score(cls, lab),
            "twosdr_class": c_purity_score(cls, lab),
            "mpca": purity_score(cls, lab2)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=600, help="particles")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    nx, k = 64, 3
    refs = class_templates(k, nx)
    imgs, cls = scattered_stack(refs, args.n, max_shift=2, seed=21,
                                device=dev)[:2]
    res = mref_ali2d(imgs, refs.copy(), ou=24, xr=2, yr=2, ts=1, maxit=3,
                     device=dev, log=RunLogger(None, quiet=True))
    print(f"alignment purity: {purity_score(cls, res.assignments):.3f}")

    # the aligned stack from the params (notebook 03's cell flow)
    aligned = aligned_stack(imgs.cpu().numpy(), *res.params.T, device=dev)
    pur = reduce_and_cluster(aligned, cls, k, dev)
    print(f"TwoSDR(20,20,8) k-means purity:  {pur['twosdr']:.3f}")
    print(f"                class purity:    {pur['twosdr_class']:.3f}")
    print(f"MPCA(10,10)     k-means purity:  {pur['mpca']:.3f}")
    return aligned, pur


if __name__ == "__main__":
    main()
