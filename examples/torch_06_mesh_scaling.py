"""Alignment on several ranks with ``torch.distributed`` (the port's
counterpart of ``examples/06_mesh_scaling.py``).

The reference scales with ``mpirun -np N``; the JAX package shards the
particles over a ``dp`` mesh; the port runs one process per rank
(``cryo_ralib_tpu_torch/parallel/mesh.py``).  Each rank holds its block
of the stack with the particles' global indices and aligns it; the
class sums and counts are all-reduced, so every rank sees the whole
stack's.  This script starts ``--ranks`` processes itself
(``torch.multiprocessing.spawn``, meeting through a file store) and in
each runs one sharded ``align_step`` and three ``AlignmentEngine``
iterations, then checks the class purity of the gathered assignments.

    python examples/torch_06_mesh_scaling.py                  # every card
    python examples/torch_06_mesh_scaling.py --device=cpu --ranks=2

On a CUDA device each rank takes ``cuda:{rank % device_count}``: NCCL
carries the sums where every rank has a card of its own, gloo where
ranks share one (and on the CPU).
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def rank_main(rank, world, store, device, n, result):
    """One rank: the sharded step and the engine iterations; rank 0
    writes the purities to ``result`` (JSON)."""
    from cryo_ralib_tpu_torch.analysis import purity_score
    from cryo_ralib_tpu_torch.config import AlignConfig
    from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
    from cryo_ralib_tpu_torch.models.steps import align_step
    from cryo_ralib_tpu_torch.params import AlignParams
    from cryo_ralib_tpu_torch.parallel.mesh import (all_reduce_sums,
                                                    gather_rows,
                                                    initialize_distributed,
                                                    shard_stack, shutdown)
    from cryo_ralib_tpu_torch.utils.synthetic import (class_templates,
                                                      scattered_stack)

    mesh = initialize_distributed(rank=rank, world_size=world,
                                  init_method=store, device=device,
                                  timeout=120)
    try:
        k, nx = 4, 64
        refs = class_templates(k, nx)
        imgs, cls = scattered_stack(refs, n, max_shift=2, seed=3)[:2]
        cfg = AlignConfig(img_dim=nx, ring_num=24, ring_len=256,
                          shift_step=1.0, shift_rng_x=2.0, shift_rng_y=2.0)
        if rank == 0:
            print(f"{world} ranks, backend {mesh.backend}, rank 0 on "
                  f"{mesh.device}", flush=True)

        # --- one sharded step: each rank its block, the sums all-reduced
        local, gidx = shard_stack(imgs, mesh)
        local = local.to(mesh.device).contiguous()
        out = align_step(local, torch.as_tensor(refs, device=mesh.device),
                         AlignParams.zeros(local.shape[0], mesh.device),
                         gidx.to(mesh.device), None, cfg, n_classes=k)
        counts = out.counts.long()
        all_reduce_sums(mesh, out.class_sums, counts)
        rid = gather_rows(out.params.ref_id, n, mesh).numpy()
        step_purity = purity_score(cls, rid)
        if rank == 0:
            print(f"one sharded step: counts={counts.tolist()}, "
                  f"purity={step_purity:.3f}", flush=True)

        # --- three iterations through the engine (each rank its block)
        eng = AlignmentEngine(imgs, cfg, n_classes=k, mesh=mesh)
        cur = refs.copy()
        for _ in range(3):
            res = eng.iterate(cur)
            safe = np.maximum(res.counts, 1)[:, None, None]
            cur = ((res.class_sums[:, 0] + res.class_sums[:, 1])
                   / safe).astype(np.float32)
        engine_purity = purity_score(cls, eng.params_np().ref_id)
        if rank == 0:
            print(f"3 engine iterations: purity={engine_purity:.3f}",
                  flush=True)
            with open(result, "w") as f:
                json.dump({"ranks": world, "backend": mesh.backend,
                           "step_counts": counts.tolist(),
                           "step_purity": step_purity,
                           "engine_purity": engine_purity}, f)
    finally:
        shutdown()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (a card per rank, shared where there are "
                        "fewer cards) or cpu")
    p.add_argument("--ranks", type=int, default=0,
                   help="processes (0: every visible card; 2 on the CPU)")
    p.add_argument("--n", type=int, default=256, help="particles")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda needs CUDA, which is not "
                           "available here; pass --device=cpu")
    world = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="torch_06_") as tmp:
        result = os.path.join(tmp, "result.json")
        mp.spawn(rank_main, args=(world, "file://" + os.path.join(
            tmp, "store"), args.device, args.n, result), nprocs=world,
            join=True)
        with open(result) as f:
            res = json.load(f)
    assert res["engine_purity"] > 0.9, res
    print("ok")
    return res


if __name__ == "__main__":
    main()
