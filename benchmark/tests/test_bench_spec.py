"""BENCHMARK.json and the files it names: every cell loads by name,
every metric has its reader, and the file keeps to the contract's
shapes."""

from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    spec = harness.load_cell(cell)
    cfg, traffic = spec["config"], spec["traffic"]
    assert cfg["driver"] in ("mref_ali2d", "ali2d_base")
    assert spec["cell"]["chips"] == traffic["ranks"]
    assert traffic["random_method"] in ("", "SHC")
    names = {m["name"] for m in spec["end_to_end"]}
    assert {"setup_s", "particles_per_s"} <= names
    assert spec["per_layer"]
    gap = "shc_gap" if traffic["random_method"] else "search_gap"
    assert set(spec["limits"]) == {gap, "row_err", "param_err", "sums_err",
                                   "counts_err", "refs_err"}
    assert spec["limits"]["counts_err"] == 0


def test_unknown_cell_names_the_cells():
    with pytest.raises(KeyError, match="mref-k8"):
        harness.load_cell("no-such-cell")


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCHMARK["end_to_end"]
                                    + BENCHMARK["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_names_units_and_lengths():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCHMARK[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for w in BENCHMARK["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in BENCHMARK["workloads"])
    assert four <= max(1, len(BENCHMARK["workloads"]) // 4)


def test_configs_state_their_cuts():
    for c in BENCHMARK["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/")
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    sources = [c["source"] for c in BENCHMARK["configs"]]
    assert len(set(sources)) == len(sources)


def test_per_layer_workloads_exist():
    for m in BENCHMARK["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
