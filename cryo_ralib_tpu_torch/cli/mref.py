"""Multireference 2D alignment CLI on one GPU (counterpart of
``cryo_ralib_tpu/cli/mref.py``): the same positional arguments (stack,
refs, outdir, optional maskfile), flags and output files
(``aqm%03d.hdf`` with ``members``/``ave_n`` headers, ``drm*`` FSC files,
``final2Dparams.txt``, ``checkpoint.npz``, ``logfile.txt``).

Usage:
    python -m cryo_ralib_tpu_torch.cli.mref stack.hdf refs.hdf outdir \
        --ou=36 --xr=3 --yr=3 --ts=1 --maxit=6
"""

from __future__ import annotations

import argparse
import os

from .common import (SAMPLERS, add_common_flags, check_outdir, cli_device,
                     load_ctf_params, load_mask, load_stack, print_device_info,
                     reject_unported, writeback_headers)


def build_parser():
    p = argparse.ArgumentParser(
        prog="cryo-ralib-torch-mref",
        description="multireference 2D alignment on one NVIDIA GPU "
                    "(PyTorch/CUDA port of cryo_ralib_tpu)")
    p.add_argument("stack", help="particle stack (.hdf/.mrcs/bdb:)")
    p.add_argument("refs", help="initial references (.hdf/.mrcs)")
    p.add_argument("outdir", help="output directory (must not exist)")
    p.add_argument("maskfile", nargs="?", default=None,
                   help="optional mask image replacing the default "
                        "model_circle(ou)")
    return add_common_flags(p)


def main(argv=None, device="cuda"):
    """Run the CLI; ``device`` (not a flag) is where the alignment runs,
    the GPU unless a caller such as a test passes ``device="cpu"``."""
    args = build_parser().parse_args(argv)
    if args.gpu_info:
        print_device_info()
        return 0
    reject_unported(args)
    device = cli_device(device)
    if args.resume:
        os.makedirs(args.outdir, exist_ok=True)
    else:
        check_outdir(args.outdir)

    from ..models.mref import mref_ali2d
    from ..utils.log import RunLogger

    log = RunLogger(args.outdir)
    log.print_begin_msg("mref_ali2d")
    images, _headers = load_stack(args.stack)
    refs, _ = load_stack(args.refs)
    mask = load_mask(args.maskfile, images.shape[-1])
    ctf_params = load_ctf_params(args, images.shape[0])
    res = mref_ali2d(
        images, refs, outdir=args.outdir, maskfile=mask,
        ir=args.ir, ou=args.ou, rs=args.rs,
        xr=args.xr, yr=args.yr, ts=args.ts,
        center=args.center, maxit=args.maxit,
        CTF=ctf_params is not None, snr=args.snr, ctf_params=ctf_params,
        user_func_name=args.function, rand_seed=args.rand_seed, log=log,
        resume=args.resume, ring_scheme=args.ring_scheme, device=device,
        sampler=SAMPLERS[args.sampler])
    if args.header_writeback:
        writeback_headers(args.stack, res.params, res.assignments)
    log.print_end_msg("mref_ali2d")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
