#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone (ranks as processes of their
own), with what it is compared with, made here at the same size: one
process's ``cli.mref`` on the headline stack, reffree A, the mref device
loop and, for 13d, ``mref_ali2d`` at K=64 on phase 6b's stack, timed
before the ranks run and again after them, whole and in the engine's
``iterate`` alone: the rest of an iteration is host work (the
reference update, reference by reference), whose time varies with the
host's load, so the ranks are read against both.

    python3 tools/torch_mesh_check.py              # 13a-13e
    python3 tools/torch_mesh_check.py --only 13d   # the 2-D mesh alone

On a machine with two or more cards the ranks take one card each and
NCCL carries the class sums (the backend rule of
``cryo_ralib_tpu_torch/parallel/mesh.py``), and the loops run under
``torch.cuda.set_sync_debug_mode("error")``; on one card the ranks share
it under gloo, as in ``chip_smoke.py``.  13d runs the 2-D mesh (dp=1,
ref=2), and (dp=2, ref=2) where four cards are visible.  Prints the
phases' lines and their JSON rows (s/iteration against one process, the
collectives' ms and bytes, agreement shares) beside the card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import chip_smoke as cs


def one_process(imgs64, tmpl64, kw):
    """One process's mref_ali2d at K=64 (phase 6b's run): its result and
    its s/iteration, whole and in the engine's ``iterate`` alone (the
    rest is the host's work between iterations, the reference update
    among it, which varies with the host's load)."""
    from cryo_ralib_tpu_torch.models import engine
    from cryo_ralib_tpu_torch.models import mref_ali2d

    spent = []
    iterate = engine.AlignmentEngine.iterate

    def timed(self, refs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = iterate(self, refs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    engine.AlignmentEngine.iterate = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mref_ali2d(imgs64, tmpl64, maxit=cs.MESH2D_MAXIT, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        engine.AlignmentEngine.iterate = iterate
    return res, {"s_per_iteration": seconds / cs.MESH2D_MAXIT,
                 "iterate_s": sum(spent) / len(spent)}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", choices=("13", "13d"), default=None,
                        help="run phase 13a-13e or 13d alone")
    args = parser.parse_args()
    from cryo_ralib_tpu_torch.cli import mref as cli_mref
    from cryo_ralib_tpu_torch.io.mrc import write_mrc
    from cryo_ralib_tpu_torch.models import make_mref_device_loop, mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base
    from cryo_ralib_tpu_torch.params import AlignParams
    from cryo_ralib_tpu_torch.utils.log import RunLogger
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      scattered_stack,
                                                      unit_sigma_blobs)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    H, n = cs.HEADLINE, cs.N_SLICE
    quiet = RunLogger(None, quiet=True)
    tmpl = asymmetric_templates(H["k"], H["nx"])
    imgs = scattered_stack(tmpl, n, max_shift=2, noise=1.0, seed=7,
                           device=dev)[0]
    tmpl1 = asymmetric_templates(1, H["nx"])
    stack_a = scattered_stack(tmpl1, n, max_shift=2, noise=1.0, seed=12,
                              device=dev, mirror=True)[0]
    launches, rows = {}, {}
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        write_mrc(os.path.join(tmp, "stack.mrcs"), imgs.cpu().numpy())
        write_mrc(os.path.join(tmp, "refs.mrcs"), tmpl)
        write_mrc(os.path.join(tmp, "stack1.mrcs"), stack_a.cpu().numpy())
        np.save(os.path.join(tmp, "tmpl.npy"), tmpl)
        loop = make_mref_device_loop(cs.geometry(H), cs.MAXIT, H["k"],
                                     np.full(cs.MAXIT, 0.25), device=dev)
        p_loop, _ = loop(imgs, torch.as_tensor(tmpl, device=dev),
                         AlignParams.zeros(n, dev),
                         torch.arange(n, device=dev),
                         torch.ones(n, device=dev))
        if args.only in (None, "13"):
            rc, _ = cs.quietly(lambda: cli_mref.main(
                [os.path.join(tmp, "stack.mrcs"),
                 os.path.join(tmp, "refs.mrcs"), os.path.join(tmp, "mref"),
                 "--ou=36", "--xr=3", "--ts=1", f"--maxit={cs.MAXIT}",
                 "--devices=1"]))
            cs.check(rc == 0, "one-process cli.mref")
            ra = ali2d_base(stack_a, ou=H["ou"], xr=H["xr"], yr=H["xr"],
                            ts=1.0, center=-1, dst=cs.DST, maxit=11,
                            device=dev, log=quiet)
            rows["mesh"] = cs.mesh_phase(dev, card, tmp, imgs, tmpl, stack_a,
                                         ra, p_loop, launches)
        if args.only in (None, "13d"):
            tmpl64 = unit_sigma_blobs(cs.K_LARGE, H["nx"])
            imgs64 = scattered_stack(tmpl64, n, max_shift=2, noise=1.0,
                                     seed=11, device=dev)[0]
            kw = dict(ou=H["ou"], xr=H["xr"], yr=H["xr"], ts=1, device=dev,
                      log=quiet)
            mref_ali2d(imgs64, tmpl64, maxit=1, **kw)   # the first use
            stack64 = os.path.join(tmp, "stack64.npy")
            np.save(stack64, imgs64.cpu().numpy())
            one64, before = one_process(imgs64, tmpl64, kw)
            del imgs64
            rows["mesh2d"] = cs.mesh2d_phase(
                card, tmp, stack64, tmpl64, one64, before["s_per_iteration"],
                p_loop, launches, one_label="this tool's one process, before")
            imgs64 = torch.as_tensor(np.load(stack64), device=dev)
            _, after = one_process(imgs64, tmpl64, kw)
            rows["mesh2d"]["one_process"] = {"before": before, "after": after}
            cs.log("13d one process, mref_ali2d K=64 (s/iteration; the "
                   "engine's iterate; the rest is host work): before the "
                   f"ranks {before['s_per_iteration']:.4f}"
                   f" ({before['iterate_s']:.4f}), after them "
                   f"{after['s_per_iteration']:.4f} "
                   f"({after['iterate_s']:.4f})  [{card}]")
    print(json.dumps(dict(rows, launches=launches, card=card)))


if __name__ == "__main__":
    main()
