#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone (the FFT-shear warp and the matmul
sampler on the card), on the same stacks, with the kernel's and the
template engine's search times at K=8, 1 and 64 measured here beside it;
the other phases' driver figures it prints beside its own are not
measured here (nan).

    python3 tools/torch_matmul_check.py

Prints phase 15's lines and its JSON row beside the card; exits
non-zero if a check fails.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs


def main():
    from cryo_ralib_tpu_torch.ops import fused_search as fs
    from cryo_ralib_tpu_torch.ops import template_search as ts
    from cryo_ralib_tpu_torch.ops.search import prepare_ref_spectra
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      scattered_stack,
                                                      unit_sigma_blobs)

    if not torch.cuda.is_available():
        raise SystemExit("torch_matmul_check: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    H, n = cs.HEADLINE, cs.N_SLICE
    tmpl = asymmetric_templates(H["k"], H["nx"])
    imgs, cls = scattered_stack(tmpl, n, max_shift=2, noise=1.0, seed=7,
                                device=dev)[:2]
    tmpl1 = asymmetric_templates(1, H["nx"])
    stack_a = scattered_stack(tmpl1, n, max_shift=2, noise=1.0, seed=12,
                              device=dev, mirror=True)[0]
    tmpl64 = unit_sigma_blobs(cs.K_LARGE, H["nx"])
    imgs64 = scattered_stack(tmpl64, n, max_shift=2, noise=1.0, seed=9,
                             device=dev)[0]
    cfg = cs.geometry(H)
    params = cs.acc_params(n, 5, dev)
    sf = ts.splat_spectra_groups(cfg, dev)
    kernel_ms, template_ms = {}, {}
    for name, x, t in (("k8", imgs, tmpl), ("k1", stack_a, tmpl1),
                       ("k64", imgs64, tmpl64)):
        rfw = prepare_ref_spectra(torch.as_tensor(t, device=dev), cfg)
        kernel_ms[name] = cs.cuda_ms(
            lambda: fs.fused_search(x, rfw, params, cfg), 3)
        template_ms[name] = cs.cuda_ms(
            lambda: ts.template_search(x, rfw, params, cfg, sf=sf), 3)
    del imgs64, sf

    def main_path(label, fn, expect):
        fs.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(fs.fused_search.launches)
        cs.log(f"{label}: launches {got}")
        for key, want in expect.items():
            cs.check(got[key] == want, f"{label}: {key} launched "
                     f"{got[key]} times, not {want}")
        return res, seconds

    nan = float("nan")
    before = dict.fromkeys(("mref_s_it", "reffree_a_s_it", "shc_s_it",
                            "scf_s_it", "eman2_s_it", "fourvar_s_it",
                            "template_mref_s_it"), nan)
    before.update(kernel_ms=kernel_ms, template_ms=template_ms)
    row = cs.matmul_phase(dev, card, main_path, imgs, tmpl, cls, stack_a,
                          tmpl1, tmpl64, before)
    print(json.dumps({"matmul": row}))
    cs.log(card)


if __name__ == "__main__":
    main()
