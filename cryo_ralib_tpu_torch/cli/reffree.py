"""Reference-free 2D alignment CLI on one or more GPUs (counterpart of
``cryo_ralib_tpu/cli/reffree.py``): the same arguments (stack, outdir,
optional maskfile), flags (``--dst``, ``--nomirror``, ``--center``,
``--mode``, ``--random_method``, ``--CTF``, ``--Fourvar``,
``--ring_scheme`` among them) and output files (``aqc.hdf``, ``aqf.hdf``,
``aqfinal.hdf``, ``resolution%03d``, ``initial2Dparams.txt``,
``checkpoint.npz``, ``logfile.txt``, and ``varf.hdf`` under
``--Fourvar``).

Usage (``--devices`` and ``torchrun`` as in ``cli.mref``):
    python -m cryo_ralib_tpu_torch.cli.reffree stack.hdf outdir --ou=36 \
        --xr=2 --ts=1
"""

from __future__ import annotations

import argparse

from .common import (SAMPLERS, add_common_flags, cli_device, launch,
                     load_ctf_params, load_mask, load_stack, print_device_info,
                     rank_log, reject_unported, validate_reffree_flags,
                     writeback_headers)


def build_parser():
    p = argparse.ArgumentParser(
        prog="cryo-ralib-torch-reffree",
        description="reference-free 2D alignment on NVIDIA GPUs "
                    "(PyTorch/CUDA port of cryo_ralib_tpu)")
    p.add_argument("stack", help="particle stack (.hdf/.mrcs/bdb:)")
    p.add_argument("outdir", help="output directory (must not exist)")
    p.add_argument("maskfile", nargs="?", default=None,
                   help="optional mask image replacing the default "
                        "model_circle(ou)")
    return add_common_flags(p, reffree=True)


def main(argv=None, device="cuda"):
    """Run the CLI; ``device`` (not a flag) is where the alignment runs,
    the GPU unless a caller such as a test passes ``device="cpu"``."""
    args = build_parser().parse_args(argv)
    if args.gpu_info:
        print_device_info()
        return 0
    validate_reffree_flags(args)
    reject_unported(args)
    return launch(run, args, cli_device(device))


def run(args, device, mesh=None):
    """One rank's run (the whole run without a ``mesh``); the output
    directory is prepared.  Rank 0 logs and writes the headers back."""
    from ..models.reffree import ali2d_base

    log = rank_log(args.outdir, mesh)
    log.print_begin_msg("ali2d_base")
    images, _headers = load_stack(args.stack, mesh)
    mask = load_mask(args.maskfile, images.shape[-1])
    ctf_params = load_ctf_params(args, images.shape[0])
    res = ali2d_base(
        images, outdir=args.outdir, maskfile=mask,
        ir=args.ir, ou=args.ou, rs=args.rs,
        xr=args.xr, yr=args.yr, ts=args.ts,
        dst=args.dst, center=args.center, maxit=args.maxit,
        CTF=ctf_params is not None, ctf_params=ctf_params,
        Fourvar=args.Fourvar, snr=args.snr,
        user_func_name=args.function, random_method=args.random_method,
        nomirror=args.nomirror, mode=args.mode, log=log,
        resume=args.resume, ring_scheme=args.ring_scheme, device=device,
        sampler=SAMPLERS[args.sampler], mesh=mesh)
    if args.header_writeback and (mesh is None or mesh.is_root):
        writeback_headers(args.stack, res.params)
    log.print_end_msg("ali2d_base")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
