"""The metric readers' arithmetic on made-up observations, the frozen
bound against the figures it gave before it was frozen, and the
reduction of a synthetic device trace."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import devtrace
import harness
from bound import search_bound


def obs(**kw):
    base = {"n": 1000, "iterations": 12, "jobs": 2, "window_s": 4.0,
            "setup_s": 21.5, "iterate_s": [0.5] * 12, "memory_peak_bytes": 0,
            "world": 1,
            "job_spans": [(0.0, 2.0, [0.6, 0.9, 1.3], [(0.1, 0.5), (0.65, 0.8),
                                                        (1.0, 1.2)])]}
    base.update(kw)
    return base


def test_rate_is_work_over_the_window():
    assert harness.reader("particles_per_s")(obs()) == pytest.approx(3000.0)
    assert harness.reader("setup_s")(obs()) == 21.5


def test_iterate_mean_and_host_part():
    assert harness.reader("engine.iterate_ms")(obs()) == pytest.approx(500.0)
    # (0.9 - 0.6) - 0.15 and (1.3 - 0.9) - 0.2
    assert harness.reader("driver.host_ms")(obs()) == pytest.approx(175.0)


def test_readers_fail_loudly_on_nothing_seen():
    with pytest.raises(RuntimeError):
        harness.reader("engine.iterate_ms")(obs(iterate_s=[]))
    with pytest.raises(RuntimeError):
        harness.reader("search.roofline_pct")(obs())


def test_roofline_and_idle_and_memory():
    o = obs(search=[(7.635, 67.5), (7.635, 67.5)],
            trace={"busy_s": 1.8, "window_s": 2.0, "iterations": 6},
            memory_peak_bytes=3 * 2 ** 30)
    assert harness.reader("search.roofline_pct")(o) == pytest.approx(
        100 * 7.635 / 67.5)
    assert harness.reader("device.idle_pct")(o) == pytest.approx(10.0)
    assert harness.reader("memory.peak_gib")(o) == pytest.approx(3.0)
    assert harness.reader("device.idle_pct")(obs()) is None


@pytest.mark.parametrize("k,n_mirr,ms", [(8, 2, 7.635), (1, 2, 3.660),
                                         (64, 2, 39.435)])
def test_frozen_bound_reproduces_the_kernel_table(k, n_mirr, ms):
    bound, by = search_bound(16384, 90, 36, 49, k, n_mirr)
    assert round(bound, 3) == ms and by == "operations"


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_trace_reduction():
    events = [_ev("bench.job", 0, 100, "user_annotation"),
              _ev("bench.iterate", 10, 30, "user_annotation"),
              _ev("bench.iterate", 60, 30, "user_annotation"),
              _ev("search_kernel", 12, 20), _ev("search_kernel", 62, 20),
              _ev("ncclKernel_AllReduce", 35, 2),
              _ev("Memcpy DtoH", 36, 3, "gpu_memcpy"),
              _ev("cpu_op", 0, 50, "cpu_op"),
              _ev("outside", 150, 10)]
    t = devtrace.reduce_events(events)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(44e-6)     # 20 + 4 + 20
    assert t["iterations"] == 2
    assert t["device_ops"][0] == ["search_kernel", pytest.approx(40e-6)]
    gaps = dict((name, s) for name, s in t["idle_gaps"])
    assert gaps["driver set-up (upload, normalisation, planning)"] == \
        pytest.approx(12e-6)
    assert gaps["driver host update (after iteration 1)"] == \
        pytest.approx(23e-6)
    assert gaps["driver end (final params, result)"] == pytest.approx(18e-6)


def test_trace_without_device_work_fails():
    with pytest.raises(ValueError):
        devtrace.reduce_events([_ev("bench.job", 0, 100, "user_annotation")])


def _span(name, ms=0.0):
    return SimpleNamespace(name=name, attrs={}, device_ms=lambda: ms)


def test_collectives_per_iteration(monkeypatch):
    from cryo_ralib_tpu_torch.utils import profiling

    spans = [_span("job"), _span("engine.iterate"), _span("step.search", 9.0),
             _span("mesh.collective", 1.5), _span("mesh.collective", 0.25),
             _span("engine.iterate"), _span("mesh.collective", 2.0),
             _span("mesh.collective", 0.75)]
    monkeypatch.setattr(profiling, "last_job", lambda: spans)
    assert harness.reader("mesh.collective_ms")({}) == pytest.approx(2.25)


def test_collectives_read_nothing_where_the_span_is_not_declared(
        monkeypatch):
    from cryo_ralib_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "SPANS", tuple(
        s for s in profiling.SPANS if s != "mesh.collective"))
    monkeypatch.setattr(profiling, "last_job",
                        lambda: [_span("engine.iterate")])
    assert harness.reader("mesh.collective_ms")({}) is None


def test_collectives_fail_where_declared_and_missing(monkeypatch):
    from cryo_ralib_tpu_torch.utils import profiling

    assert "mesh.collective" in profiling.SPANS
    monkeypatch.setattr(profiling, "last_job",
                        lambda: [_span("job"), _span("engine.iterate"),
                                 _span("step.search", 9.0)])
    with pytest.raises(RuntimeError, match="no mesh.collective"):
        harness.reader("mesh.collective_ms")({})


def test_ranks_trace_never_reads_busier_than_its_window():
    """Ranks whose profiled jobs span different times: the mean busy
    time over the mean window, each rank's busy within its own."""
    traces = [{"busy_s": 0.9, "window_s": 1.0},
              {"busy_s": 1.7, "window_s": 1.9},
              {"busy_s": 1.2, "window_s": 1.3},
              {"busy_s": 1.0, "window_s": 1.2}]
    t = harness.ranks_trace(traces)
    assert t == {"busy_s": pytest.approx(1.2), "window_s": pytest.approx(1.35)}
    assert harness.reader("device.idle_pct")({"trace": t}) == pytest.approx(
        100 * (1 - 1.2 / 1.35))
