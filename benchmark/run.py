"""Run one cell of the benchmark of ``cryo_ralib_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints one JSON line last on standard output (``harness.py``
says what it holds) and exits 0; exits non-zero with no result where
CUDA or the cards are missing, where the port is not in the checkout,
and where a module of JAX or of the JAX package was loaded.  A cell on
several cards starts one process per card (``--rank``, given by this
launcher only), which meet over NCCL; rank 0 prints the line.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
RANK_TIMEOUT_S = 345.0
# intra-op threads of a run's process (and of each rank): with the
# default of one per core, runs on a shared 8-core host fell into a mode
# 12% slower (OpenMP workers spinning beside the alignment's host work)
THREADS = 2


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    # the control's readings (never in a benchmark run): --control 1 reads
    # the program's and the control's numbers of --seed and --more-seeds
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--more-seeds", default="")
    return ap.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def _import_port():
    """The port, from this checkout and nowhere else."""
    sys.path.insert(0, str(ROOT))
    try:
        import cryo_ralib_tpu_torch
    except ImportError as e:
        raise SystemExit(_fail(f"the port is not in this checkout ({e})"))
    where = Path(cryo_ralib_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise SystemExit(_fail(f"the port was imported from {where}, "
                               f"not from {ROOT}"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(args, world: int) -> int:
    """One process per card; returns 0 only where every rank did."""
    from cryo_ralib_tpu_torch.ops.fused_search import build

    build()    # once, before the ranks start
    init = f"tcp://localhost:{_free_port()}"
    base = [sys.executable, str(Path(__file__).resolve()),
            "--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace),
            "--world", str(world), "--init", init, "--t0", repr(T_START),
            "--control", str(args.control), "--more-seeds", args.more_seeds]
    procs = [subprocess.Popen(base + ["--rank", str(r)],
                              stdout=None if r == 0 else sys.stderr)
             for r in range(world)]
    deadline = time.time() + RANK_TIMEOUT_S
    codes = [None] * world
    try:
        while any(c is None for c in codes):
            for r, p in enumerate(procs):
                if codes[r] is None:
                    codes[r] = p.poll()
            if any(c not in (None, 0) for c in codes):
                break
            if time.time() > deadline:
                print("benchmark: ranks timed out", file=sys.stderr)
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for r, p in enumerate(procs):
            try:
                codes[r] = p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                codes[r] = p.wait()
    return 0 if all(c == 0 for c in codes) else 1


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    _import_port()
    import torch

    torch.set_num_threads(THREADS)

    import harness

    spec = harness.load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available():
        return _fail("CUDA is not available")
    if torch.cuda.device_count() < chips:
        return _fail(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} are visible")
    if chips > 1 and args.rank is None:
        return _launch(args, chips)
    mesh = None
    if args.rank is not None:
        from cryo_ralib_tpu_torch.parallel.mesh import (
            initialize_distributed, shutdown)
        mesh = initialize_distributed(rank=args.rank, world_size=args.world,
                                      local_rank=args.rank,
                                      init_method=args.init, device="cuda")
        torch.set_num_threads(THREADS)
    seeds = [args.seed] + [int(s) for s in args.more_seeds.split(",") if s]
    outs = []
    try:
        for i, seed in enumerate(seeds):
            t0 = args.t0 if args.t0 is not None else T_START
            out = harness.run_cell(spec, seed, args.seconds,
                                   bool(args.trace), "cuda", mesh,
                                   t0 if i == 0 else time.time(),
                                   control=bool(args.control))
            if out is not None:
                if args.control:
                    out["seed"] = seed
                outs.append(out)
    finally:
        if mesh is not None:
            shutdown()
    # printed last, after the process group's teardown has said its say
    for out in outs:
        harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
