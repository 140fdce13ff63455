"""Aligned-stack export + class-average reconstruction on the PyTorch/CUDA
port (notebook 00's tail).

The port's counterpart of ``examples/08_export_aligned.py``, the
one-command equivalent of the reference's EMAN2 glue (``sxheader.py
--params=xform.align2d --zero``, ``sxtransform2d.py``, ``e2proc2d.py``):

    params table -> aligned stack HDF (+ zeroed ``xform.align2d``
    headers, ``assign`` class attr) -> per-class average HDF

The transform is the port's ``rot_shift2d`` on ``--device`` (the GPU by
default); the files are written by the port's HDF5 writer (no h5py).

Usage:
    python examples/torch_08_export_aligned.py stack.hdf params.txt outdir
    python examples/torch_08_export_aligned.py            # synthetic demo

The params table is the drivers' whitespace format ``alpha sx sy mirror
[class]`` (header convention, ``initial2Dparams.txt`` rows) or the
6-column EDA format ``idx angle_psi shift_x shift_y mirror class``; the
column count tells them apart.  With no stack it synthesizes one, runs a
short mref pass for params, then exports.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_params(path: str):
    """(alpha, sx, sy, mirror, cls_or_None) from either table format."""
    data = np.loadtxt(path, ndmin=2)
    if data.shape[1] >= 6:           # idx angle_psi sx sy mirror class
        return (data[:, 1], data[:, 2], data[:, 3],
                data[:, 4].astype(np.int32), data[:, 5].astype(np.int32))
    if data.shape[1] >= 4:           # alpha sx sy mirror [class]
        cls = data[:, 4].astype(np.int32) if data.shape[1] >= 5 else None
        return (data[:, 0], data[:, 1], data[:, 2],
                data[:, 3].astype(np.int32), cls)
    raise SystemExit(f"params table {path!r} has {data.shape[1]} columns; "
                     "expected >=4 (alpha sx sy mirror [class]) or 6 "
                     "(idx angle_psi sx sy mirror class)")


def export_aligned(images: np.ndarray, alpha, sx, sy, mirror, cls,
                   outdir: str, device="cuda"):
    """Apply header-convention params to the raw stack on ``device`` and
    write ``aligned.hdf`` (transformed particles, zeroed
    ``xform.align2d`` + ``assign`` headers) and ``class_avgs.hdf`` (with
    ``members`` counts); returns (stack path, averages path or None,
    aligned stack)."""
    from cryo_ralib_tpu_torch.io.dataset import aligned_stack
    from cryo_ralib_tpu_torch.io.eman_hdf import write_hdf_stack

    aligned = aligned_stack(images, alpha, sx, sy, mirror, device=device)
    os.makedirs(outdir, exist_ok=True)
    n = images.shape[0]

    # sxheader-zeroed transforms: the exported stack is already aligned,
    # so its headers carry the identity (plus the class assignment)
    zero_xf = {"alpha": 0.0, "tx": 0.0, "ty": 0.0, "mirror": 0,
               "scale": 1.0}
    headers = []
    for i in range(n):
        h = {"xform.align2d": zero_xf}
        if cls is not None:
            h["assign"] = int(cls[i])
        headers.append(h)
    stack_path = os.path.join(outdir, "aligned.hdf")
    write_hdf_stack(stack_path, aligned, headers=headers)

    avg_path = None
    if cls is not None:
        k = int(cls.max()) + 1 if n else 0
        counts = np.bincount(cls, minlength=k)
        avgs = np.zeros((k,) + images.shape[1:], np.float32)
        np.add.at(avgs, cls, aligned)
        avgs /= np.maximum(counts, 1)[:, None, None]
        avg_path = os.path.join(outdir, "class_avgs.hdf")
        write_hdf_stack(avg_path, avgs,
                        headers=[{"members": int(c)} for c in counts])
    return stack_path, avg_path, aligned


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("files", nargs="*",
                   help="stack params outdir (none: synthetic demo)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=256,
                   help="particles of the synthetic demo")
    args = p.parse_args(argv)
    if len(args.files) == 3:
        from cryo_ralib_tpu_torch.cli.common import load_stack

        images, _ = load_stack(args.files[0])
        alpha, sx, sy, mirror, cls = load_params(args.files[1])
        if alpha.shape[0] != images.shape[0]:
            raise SystemExit(f"params rows ({alpha.shape[0]}) != stack "
                             f"size ({images.shape[0]})")
        outdir = args.files[2]
    elif not args.files:
        # synthetic demo: generate -> align (mref driver) -> export
        import tempfile

        from cryo_ralib_tpu_torch.models.mref import mref_ali2d
        from cryo_ralib_tpu_torch.utils.synthetic import (class_templates,
                                                          scattered_stack)

        nx, k = 64, 3
        refs = class_templates(k, nx)
        imgs, true_cls = scattered_stack(refs, args.n, max_shift=2,
                                         seed=8)[:2]
        images = imgs.numpy()
        outdir = tempfile.mkdtemp(prefix="export_aligned_")
        res = mref_ali2d(images, refs, outdir=os.path.join(outdir, "mref"),
                         ou=nx // 2 - 4, xr=2.0, ts=1.0, maxit=2,
                         device=args.device)
        alpha, sx, sy = res.params[:, 0], res.params[:, 1], res.params[:, 2]
        mirror = res.params[:, 3].astype(np.int32)
        cls = res.assignments.astype(np.int32)
        agree = (cls == true_cls).mean()
        print(f"mref pass done; class agreement vs truth: {agree:.3f}")
    else:
        raise SystemExit(__doc__)

    stack_path, avg_path, aligned = export_aligned(
        np.asarray(images, np.float32), np.asarray(alpha),
        np.asarray(sx), np.asarray(sy),
        np.asarray(mirror, np.int32), cls, outdir, device=args.device)
    print(f"aligned stack:  {stack_path}  ({aligned.shape[0]} particles)")
    if avg_path:
        print(f"class averages: {avg_path}")

    # round trip: the exported stack reads back with zeroed transforms
    # and the class assignment intact
    from cryo_ralib_tpu_torch.io.eman_hdf import read_hdf_stack

    back, headers = read_hdf_stack(stack_path)
    if back.shape != aligned.shape or not np.array_equal(back, aligned):
        raise SystemExit("aligned.hdf does not read back as written")
    if cls is not None and int(headers[0].get("assign", -1)) != int(cls[0]):
        raise SystemExit("aligned.hdf lost the class assignment")
    print("round-trip check ok")
    return stack_path, avg_path, aligned


if __name__ == "__main__":
    main()
