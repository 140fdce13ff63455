"""Multireference 2D alignment CLI on one or more GPUs (counterpart of
``cryo_ralib_tpu/cli/mref.py``): the same positional arguments (stack,
refs, outdir, optional maskfile), flags and output files
(``aqm%03d.hdf`` with ``members``/``ave_n`` headers, ``drm*`` FSC files,
``final2Dparams.txt``, ``checkpoint.npz``, ``logfile.txt``).

Usage (``--devices=2`` runs two ranks, one process per card; under
``torchrun`` each process is one rank):
    python -m cryo_ralib_tpu_torch.cli.mref stack.hdf refs.hdf outdir \
        --ou=36 --xr=3 --yr=3 --ts=1 --maxit=6
    python -m torch.distributed.run --nproc_per_node 2 \
        -m cryo_ralib_tpu_torch.cli.mref stack.mrcs refs.mrcs outdir --ou=36
"""

from __future__ import annotations

import argparse

from .common import (SAMPLERS, add_common_flags, cli_device, launch,
                     load_ctf_params, load_mask, load_stack, print_device_info,
                     rank_log, writeback_headers)


def build_parser():
    p = argparse.ArgumentParser(
        prog="cryo-ralib-torch-mref",
        description="multireference 2D alignment on NVIDIA GPUs "
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
    return launch(run, args, cli_device(device))


def run(args, device, mesh=None):
    """One rank's run (the whole run without a ``mesh``); the output
    directory is prepared.  Rank 0 logs and writes the headers back."""
    from ..models.mref import mref_ali2d

    log = rank_log(args.outdir, mesh)
    log.print_begin_msg("mref_ali2d")
    images, _headers = load_stack(args.stack, mesh)
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
        sampler=SAMPLERS[args.sampler], mesh=mesh)
    if args.header_writeback and (mesh is None or mesh.is_root):
        writeback_headers(args.stack, res.params, res.assignments)
    log.print_end_msg("mref_ali2d")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
