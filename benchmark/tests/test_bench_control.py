"""The control: the reference computed in TF32 in the program's place
(``reference.tf32`` on every product's operands) fails the cells'
limits, at a size a CPU test holds: the harness's own verdict on the
control's numbers (``control_correct``) reads false.  On the card it is
read at the cells' own sizes by ``benchmark/run.py --control 1`` (never
by a benchmark run)."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH, BIG_SEED, tiny_spec

import harness

KINDS = {"mref-k8": ("mref_ali2d", ""), "reffree": ("ali2d_base", ""),
         "reffree-shc": ("ali2d_base", "SHC")}


@pytest.mark.parametrize("cell", sorted(KINDS))
def test_control_fails_the_cells_limits(cell):
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    spec = tiny_spec(*KINDS[cell], n=1024, k=4)
    spec["limits"] = limits
    out = harness.run_cell(spec, BIG_SEED + 3, 0.0, False, "cpu",
                           control=True)
    assert out["correct"], out["checks"]
    ctrl = out["control"]
    assert out["control_correct"] is False, (ctrl, limits)
    failed = [k for k, v in ctrl.items() if k in limits and v > limits[k]]
    assert failed, (ctrl, limits)
    assert list(out)[-1] == "checks"
