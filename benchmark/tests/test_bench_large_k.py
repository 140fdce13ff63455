"""The K=64 deployment at sizes a CPU runs: a cell of 16 references
(two of the kernel's reference groups) is held to the plain reference
whole, a search that never sees the second group fails the check, and
the readers of the spans that came with the cell read the program's own
spans, nothing from a program that predates them, and fail loudly where
a job lacks one."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import BIG_SEED, tiny_spec

import gen
import harness
from bound import search_bound
from cryo_ralib_tpu_torch.models import steps as steps_mod
from cryo_ralib_tpu_torch.utils import profiling

NEW_METRICS = ("driver.refs_ms", "step.search_roofline_pct")
SPAN_OF = {"driver.refs_ms": "driver.refs",
           "step.search_roofline_pct": "step.search"}


def _traced(spec, *metrics):
    spec["per_layer"] += [{"name": m, "unit": "x"} for m in metrics]
    return spec


def test_the_new_cell_loads_by_name():
    k64 = harness.load_cell("mref-k64")
    assert k64["cell"]["chips"] == 1
    cfg = k64["config"]
    assert cfg["n_refs"] == cfg["stack_classes"] == 64
    assert cfg["reduced"] == [] and cfg["n_particles"] == 105247
    k8 = harness.load_cell("mref-k8")["config"]
    same = set(k8) - {"name", "source", "benchmark", "n_refs",
                      "stack_classes", "assumed", "deployment"}
    assert {key: cfg[key] for key in same} == {key: k8[key] for key in same}
    assert np.array_equal(gen.templates(64, 32)[:8], gen.templates(8, 32))
    assert set(NEW_METRICS) <= {m["name"] for m in k64["per_layer"]}


def test_two_reference_groups_are_correct():
    spec = _traced(tiny_spec(k=16, maxit=2), "driver.refs_ms",
                   "step.search_roofline_pct")
    out = harness.run_cell(spec, BIG_SEED, 0.0, True, "cpu")
    assert out["correct"], out["checks"]
    spans = profiling.last_job()
    searches = [s for s in spans if s.name == "step.search"]
    refs = [s for s in spans if s.name == "driver.refs"]
    assert len(searches) == len(refs) == 2
    assert all(s.attrs["classes"] == 16 for s in refs)
    got = {m: out["metrics"][m]["value"]
           for m in ("driver.refs_ms", "step.search_roofline_pct")}
    assert got["driver.refs_ms"] == pytest.approx(
        sum(s.host_ms for s in refs) / 2)
    bound = sum(search_bound(512, 32, 12, 9, 16, 2)[0] for _ in searches)
    assert got["step.search_roofline_pct"] == pytest.approx(
        100 * bound / sum(s.device_ms() for s in searches))


def test_a_search_blind_to_the_second_group_is_not_correct(monkeypatch):
    """References 8-15 hidden from the search: the winners stay in the
    first group, and the check, which searches all 16, sees the gap."""
    orig = steps_mod.search_plain

    def first_group(images, ref_fw, *a, **k):
        return orig(images, ref_fw[:8], *a, **k)

    def fault():
        monkeypatch.setattr(steps_mod, "search_plain", first_group)

    out = harness.run_cell(tiny_spec(k=16, maxit=2), BIG_SEED, 0.0, False,
                           "cpu", faults=fault)
    assert not out["correct"]
    assert out["checks"]["search_gap"]["value"] > 1e-2, out["checks"]


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_readers_read_nothing_from_a_program_before_them(metric,
                                                         monkeypatch):
    monkeypatch.delattr(profiling, "SPANS")
    assert harness.reader(metric)({}) is None


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_readers_fail_on_a_job_without_the_span(metric, monkeypatch):
    assert SPAN_OF[metric] in profiling.SPANS
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.job():
            with profiling.span("engine.iterate"):
                pass
    monkeypatch.setattr(profiling, "last_job", lambda: [])
    with pytest.raises(RuntimeError, match="no job was recorded"):
        harness.reader(metric)({})
    monkeypatch.undo()
    assert [s.name for s in profiling.last_job()] == ["job",
                                                      "engine.iterate"]
    with pytest.raises(RuntimeError, match="no " + SPAN_OF[metric]):
        harness.reader(metric)({})


def test_a_search_span_without_its_size_fails(monkeypatch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.job():
            with profiling.span("engine.iterate"):
                with profiling.span("step.search", N=8, K=2):
                    pass
    with pytest.raises(RuntimeError, match="lacks box"):
        harness.reader("step.search_roofline_pct")({})
