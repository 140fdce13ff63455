"""Batch rotate/shift transforms on the PyTorch/CUDA port (notebook 02).

The port's counterpart of ``examples/02_batch_transform.py``: applies
``rot_shift2d`` (EMAN2's quadri interpolation, the notebook's CuPy
kernel) to a synthetic stack, times it beside the bilinear
``transform_batch`` that the alignment step uses on the same transforms,
prints how far the two interpolators differ inside the particle disc,
and reconstructs the class averages from the known parameters.  The JAX
example's second engine (FFT shear) is a TPU work-around and is not
ported.

    python examples/torch_02_batch_transform.py            # on the GPU
    python examples/torch_02_batch_transform.py --device=cpu
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from cryo_ralib_tpu_torch.models.engine import resolve_device
from cryo_ralib_tpu_torch.ops.transform import rot_shift2d, transform_batch
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.utils.synthetic import (class_templates,
                                                  scattered_stack)


def timed(fn, dev):
    """(result, seconds) of ``fn()`` after one warm-up call, the device
    synchronised around the timed call."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=1024, help="particles")
    p.add_argument("--nx", type=int, default=90, help="box size")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n, nx, k = args.n, args.nx, 4
    refs = class_templates(k, nx)
    imgs, cls, angs, shifts, _ = scattered_stack(refs, n, max_shift=3,
                                                 seed=3, device=dev,
                                                 mirror=False)
    # undo the generating transforms: rot_shift2d(-angle, shift) inverts
    # the stack's transform_batch(angle, shift)
    back = torch.as_tensor((360.0 - angs) % 360.0, device=dev)
    sx = torch.as_tensor(shifts[:, 0], device=dev)
    sy = torch.as_tensor(shifts[:, 1], device=dev)
    quadri, t_q = timed(lambda: rot_shift2d(imgs, back, sx, sy), dev)
    # the same map as transform_batch's inverse map: rotate by the
    # angle, shift by -R(angle) s
    rad = back * (math.pi / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    params = AlignParams(back, -(sx * c - sy * s), -(sx * s + sy * c), zero,
                         zero)
    bilinear, t_b = timed(lambda: transform_batch(imgs, params), dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"rot_shift2d (quadri):      {n / t_q:10.0f} images/s  [{where}]")
    print(f"transform_batch (bilinear): {n / t_b:10.0f} images/s  [{where}]")

    yy, xx = np.mgrid[0:nx, 0:nx]
    disc = (yy - nx // 2) ** 2 + (xx - nx // 2) ** 2 <= (nx // 2 - 4) ** 2
    q, b = quadri.cpu().numpy(), bilinear.cpu().numpy()
    print(f"quadri - bilinear inside the disc: max "
          f"{np.abs(q - b)[:, disc].max():.4f}, mean "
          f"{np.abs(q - b)[:, disc].mean():.4f}")

    avgs = np.stack([q[cls == j].mean(0) if (cls == j).any()
                     else np.zeros((nx, nx), np.float32) for j in range(k)])
    err = np.abs(avgs - refs)[:, disc].mean()
    print(f"class-average reconstruction error vs templates: {err:.4f}")
    return {"quadri": q, "bilinear": b, "averages": avgs, "error": err}


if __name__ == "__main__":
    main()
