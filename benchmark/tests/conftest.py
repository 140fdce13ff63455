"""Shared set-up of the benchmark's own tests (CPU; run with
``python -m pytest benchmark/tests``): the benchmark's folder and the
checkout on ``sys.path``, and a tiny cell that runs whole jobs on the
CPU in seconds."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

BIG_SEED = 2 ** 31 + 4099


def tiny_spec(driver: str = "mref_ali2d", random_method: str = "",
              n: int = 512, k: int = 3, maxit: int = 3) -> dict:
    """A cell at a size a CPU runs in seconds: 32 px, rings 1..12, a
    3 x 3 shift grid; limits at the CPU's exact agreement."""
    cfg = {"driver": driver, "n_particles": n, "box": 32,
           "n_refs": k if driver == "mref_ali2d" else 1, "ou": 12, "xr": 1,
           "yr": 1, "ts": 1, "mirror": True, "center": -1, "maxit": maxit,
           "stack_classes": k}
    traffic = {"random_method": random_method, "sampler": "auto",
               "warmup_particles": 64, "warmup_maxit": 1,
               "check_particles": 128}
    limits = {("shc_gap" if random_method else "search_gap"): 1e-5,
              "row_err": 1e-5, "param_err": 1e-3, "sums_err": 1e-5,
              "counts_err": 0, "refs_err": 1e-4}
    return {"cell": {"name": "tiny", "chips": 1}, "config": cfg,
            "traffic": traffic, "limits": limits,
            "end_to_end": [{"name": "particles_per_s", "unit": "particles/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "engine.iterate_ms", "unit": "ms"},
                          {"name": "driver.host_ms", "unit": "ms"}]}


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads, so that parallel test workers do not
    oversubscribe the host."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
