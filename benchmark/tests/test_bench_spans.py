"""The four readers of the program's spans: on a job that a tiny traced
CPU run recorded, against the spans themselves; ``RuntimeError`` where
no job was recorded; nothing where the program records no spans."""

from __future__ import annotations

import pytest

from conftest import BIG_SEED, tiny_spec

import harness
from cryo_ralib_tpu_torch.utils import profiling

SPAN_METRICS = ("driver.prepare_ms", "step.search_ms", "step.sums_ms",
                "driver.update_ms")


@pytest.mark.parametrize("driver,method", [("mref_ali2d", ""),
                                           ("ali2d_base", "SHC")])
def test_readers_on_a_recorded_job(driver, method):
    spec = tiny_spec(driver, method, n=128, maxit=2)
    spec["per_layer"] += [{"name": m, "unit": "ms"} for m in SPAN_METRICS]
    out = harness.run_cell(spec, BIG_SEED, 0.0, True, "cpu")
    assert out["correct"]
    spans = profiling.last_job()
    iterations = sum(s.name == "engine.iterate" for s in spans)
    assert iterations == 2

    def ms(name, device=True):
        return sum(s.device_ms() if device else s.host_ms
                   for s in spans if s.name == name)

    got = {m: out["metrics"][m]["value"] for m in SPAN_METRICS}
    assert got["driver.prepare_ms"] == pytest.approx(ms("driver.prepare"))
    assert got["step.search_ms"] == pytest.approx(ms("step.search") / 2)
    assert got["step.sums_ms"] == pytest.approx(ms("step.sums") / 2)
    assert got["driver.update_ms"] == pytest.approx(
        ms("driver.update", device=False) / 2)
    assert all(v > 0 for v in got.values())
    # the search and the sums lie inside the iterations
    assert got["step.search_ms"] + got["step.sums_ms"] <= (
        ms("engine.iterate", device=False) / 2)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readers_fail_on_no_recorded_job(metric, monkeypatch):
    monkeypatch.setattr(profiling, "last_job", lambda: [])
    with pytest.raises(RuntimeError, match="no job was recorded"):
        harness.reader(metric)({})


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readers_read_nothing_from_a_program_without_spans(metric,
                                                           monkeypatch):
    monkeypatch.delattr(profiling, "last_job")
    assert harness.reader(metric)({}) is None
