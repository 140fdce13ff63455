#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone (two ranks, a process each), with
what it is compared with, made here at the same size: one process's
``cli.mref`` on the headline stack, reffree A and the mref device loop.

    python3 tools/torch_mesh_check.py

On a machine with two or more cards the ranks take one card each and
NCCL carries the class sums (the backend rule of
``cryo_ralib_tpu_torch/parallel/mesh.py``), and 13c runs the loop under
``torch.cuda.set_sync_debug_mode("error")``; on one card both ranks
share it under gloo, as in ``chip_smoke.py``.  Prints phase 13's lines
and its JSON row (s/iteration against one process, the all-reduce's
and the gather's ms and bytes, agreement shares) beside the card.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import chip_smoke as cs


def main():
    from cryo_ralib_tpu_torch.cli import mref as cli_mref
    from cryo_ralib_tpu_torch.io.mrc import write_mrc
    from cryo_ralib_tpu_torch.models import make_mref_device_loop
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base
    from cryo_ralib_tpu_torch.params import AlignParams
    from cryo_ralib_tpu_torch.utils.log import RunLogger
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      scattered_stack)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    H, n = cs.HEADLINE, cs.N_SLICE
    tmpl = asymmetric_templates(H["k"], H["nx"])
    imgs = scattered_stack(tmpl, n, max_shift=2, noise=1.0, seed=7,
                           device=dev)[0]
    tmpl1 = asymmetric_templates(1, H["nx"])
    stack_a = scattered_stack(tmpl1, n, max_shift=2, noise=1.0, seed=12,
                              device=dev, mirror=True)[0]
    with tempfile.TemporaryDirectory(prefix="nccl_") as tmp:
        write_mrc(os.path.join(tmp, "stack.mrcs"), imgs.cpu().numpy())
        write_mrc(os.path.join(tmp, "refs.mrcs"), tmpl)
        write_mrc(os.path.join(tmp, "stack1.mrcs"), stack_a.cpu().numpy())
        rc, _ = cs.quietly(lambda: cli_mref.main(
            [os.path.join(tmp, "stack.mrcs"), os.path.join(tmp, "refs.mrcs"),
             os.path.join(tmp, "mref"), "--ou=36", "--xr=3", "--ts=1",
             f"--maxit={cs.MAXIT}", "--devices=1"]))
        cs.check(rc == 0, "one-process cli.mref")
        ra = ali2d_base(stack_a, ou=H["ou"], xr=H["xr"], yr=H["xr"], ts=1.0,
                        center=-1, dst=cs.DST, maxit=11, device=dev,
                        log=RunLogger(None, quiet=True))
        loop = make_mref_device_loop(cs.geometry(H), cs.MAXIT, H["k"],
                                     np.full(cs.MAXIT, 0.25), device=dev)
        p_loop, _ = loop(imgs, torch.as_tensor(tmpl, device=dev),
                         AlignParams.zeros(n, dev),
                         torch.arange(n, device=dev),
                         torch.ones(n, device=dev))
        launches = {}
        row = cs.mesh_phase(dev, card, tmp, imgs, tmpl, ra, p_loop, launches)
        print(json.dumps({"mesh": row, "launches": launches}))


if __name__ == "__main__":
    main()
