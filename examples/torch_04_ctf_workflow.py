"""CTF-aware multireference alignment on the PyTorch/CUDA port.

The port's counterpart of ``examples/04_ctf_workflow.py``: simulates a
defocus-series particle stack (each particle imaged under its own CTF,
so a plain average cancels structure at the zero crossings), writes the
defocus table, and runs ``mref_ali2d`` twice, plain and with ``--CTF``
semantics (CTF premultiplication and Wiener-restored references,
``ops/ctf_ops.py``), then compares each run's references with the
ground-truth templates.

    python examples/torch_04_ctf_workflow.py [outdir]          # on the GPU
    python examples/torch_04_ctf_workflow.py --device=cpu --n=64 --nx=48
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from cryo_ralib_tpu_torch.models.engine import resolve_device
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.ops.ctf_ops import ctf_rfft2, filt_ctf
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack)


def corr(a, b):
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("outdir", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sampler", default="auto",
                   choices=["auto", "kernel", "plain", "template", "matmul"])
    p.add_argument("--n", type=int, default=256, help="particles")
    p.add_argument("--nx", type=int, default=64, help="box size")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    outdir = args.outdir or tempfile.mkdtemp(prefix="torch_ctf_")
    os.makedirs(outdir, exist_ok=True)
    k, nx, n, apix = 2, args.nx, args.n, 1.5

    print(f"simulating {n} particles from {k} templates under a "
          "defocus series ...")
    refs = asymmetric_templates(k, nx)
    imgs = scattered_stack(refs, n, max_shift=2, seed=7)[0]
    rng = np.random.default_rng(7)
    dfu = rng.uniform(8000.0, 25000.0, n)          # 0.8-2.5 um defocus
    ctf = ctf_rfft2(nx, apix, torch.as_tensor(dfu), torch.as_tensor(dfu),
                    torch.zeros(n, dtype=torch.float64))
    data = filt_ctf(imgs, ctf).numpy()
    data = (data + rng.normal(0, 0.05, data.shape)).astype(np.float32)
    np.savetxt(f"{outdir}/defocus.txt", dfu[:, None])
    print(f"wrote {outdir}/defocus.txt (CLI: --CTF --ctf_file ... "
          f"--apix {apix})")

    kw = dict(ou=min(24, nx // 2 - 4), xr=2, yr=2, ts=1, maxit=4,
              device=dev, sampler=args.sampler,
              log=RunLogger(None, quiet=True))
    print(f"aligning WITHOUT CTF correction on {dev} ...")
    plain = mref_ali2d(data, refs.copy(), outdir=f"{outdir}/plain", **kw)
    print("aligning WITH CTF correction (premultiply + Wiener) ...")
    ctfres = mref_ali2d(data, refs.copy(), outdir=f"{outdir}/ctf", CTF=True,
                        snr=10.0, ctf_params=dict(dfu=dfu, apix=apix), **kw)

    out = {}
    for name, res in (("plain", plain), ("CTF", ctfres)):
        cs = [max(corr(res.references[j], refs[i]) for j in range(k))
              for i in range(k)]
        out[name] = cs
        print(f"  {name:5s}: reference-vs-template correlation "
              + "  ".join(f"{c:.3f}" for c in cs))
    print(f"artifacts in {outdir}/plain and {outdir}/ctf")
    return out


if __name__ == "__main__":
    main()
