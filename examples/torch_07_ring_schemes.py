"""Ring conventions on the PyTorch/CUDA port: the CUDA uniform scheme
against EMAN2 Numrinit rings.

The port's counterpart of ``examples/07_ring_schemes.py``: aligns one
synthetic stack with ``mref_ali2d`` under both ring schemes
(``ring_scheme="cuda"``: uniform 256-sample rings; ``"eman2"``: the
variable power-of-two ring lengths of ``Numrinit`` with ``ringwe``
weights) and says how often they agree on (class, mirror) and how far
their angles differ.  The eman2 scheme runs twice: through the PyTorch
search (``sampler="plain"``, what ``"auto"`` runs for it) and through the
template engine (``sampler="template"``, the search as bf16 matrix
products), and the two are compared as well.

    python examples/torch_07_ring_schemes.py            # on the GPU
    python examples/torch_07_ring_schemes.py --device=cpu
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from cryo_ralib_tpu_torch.models.engine import resolve_device
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.rings import numrinit, ringwe
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack)


def agreement(a, b):
    """(class agreement, mirror agreement, largest angle difference in
    degrees where both agree) of two ``mref_ali2d`` results."""
    same = (a.assignments == b.assignments) & (a.params[:, 3]
                                               == b.params[:, 3])
    d = np.abs(a.params[same, 0] - b.params[same, 0])
    d = np.minimum(d, 360.0 - d)
    return (float((a.assignments == b.assignments).mean()),
            float((a.params[:, 3] == b.params[:, 3]).mean()),
            float(d.max(initial=0.0)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=48, help="particles")
    p.add_argument("--nx", type=int, default=64, help="box size")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    nx, k, n, ou = args.nx, 3, args.n, 20
    base = asymmetric_templates(k, nx)
    imgs, true_cls = scattered_stack(base, n, max_shift=2, seed=11)[:2]
    imgs = imgs.numpy()

    plan = numrinit(1, ou)
    print("Numrinit plan (radius, ring_len):", plan[:4], "...", plan[-2:])
    print("maxrin =", plan[-1][1], " ringwe[0..3] =",
          np.round(ringwe(plan)[:4], 3))

    results = {}
    for label, scheme, sampler in (("cuda", "cuda", "auto"),
                                   ("eman2", "eman2", "plain"),
                                   ("eman2 template", "eman2", "template")):
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            res = mref_ali2d(
                imgs, base, outdir=os.path.join(td, "out"), ou=ou, xr=2.0,
                ts=1.0, maxit=1, ring_scheme=scheme, sampler=sampler,
                user_func_name="ref_ali2d_no_filter", device=dev)
            seconds = time.perf_counter() - t0
        results[label] = res
        acc = float((res.assignments == true_cls).mean())
        print(f"{label:14s}: class recovery vs ground truth = {acc:.3f} "
              f"({seconds:.2f} s, sampler={sampler!r}) [{dev}]")

    cls, mir, ang = agreement(results["cuda"], results["eman2"])
    print(f"scheme agreement: class {cls:.3f}, mirror {mir:.3f}, "
          f"angle max|d| (same winner) = {ang:.2f} deg")
    assert cls >= 0.9, "schemes should agree on well-separated data"
    cls_t, mir_t, ang_t = agreement(results["eman2 template"],
                                    results["eman2"])
    print(f"eman2 template engine against the PyTorch search: class "
          f"{cls_t:.3f}, mirror {mir_t:.3f}, angle max|d| = {ang_t:.3f} deg")
    assert cls_t >= 0.9, "the template engine should agree with the search"
    print("OK")
    return results


if __name__ == "__main__":
    main()
