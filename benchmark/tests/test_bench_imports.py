"""Nothing the benchmark runs imports JAX or the JAX package, compared
by the whole top-level name (the port's name begins with the JAX
package's)."""

from __future__ import annotations

import subprocess
import sys
import types

import pytest

from conftest import BENCH, ROOT

import harness


def test_whole_name_match(monkeypatch):
    monkeypatch.setitem(sys.modules, "cryo_ralib_tpu_torch_extra",
                        types.ModuleType("x"))
    assert "cryo_ralib_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cryo_ralib_tpu.ops",
                        types.ModuleType("y"))
    assert harness.forbidden_modules() == ["cryo_ralib_tpu"]


def test_a_tiny_run_loads_nothing_forbidden():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_spec, BIG_SEED\n"
        "import harness\n"
        "out = harness.run_cell(tiny_spec(n=128, maxit=2), BIG_SEED, 0.0,"
        " True, 'cpu')\n"
        "bad = {m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'cryo_ralib_tpu'}\n"
        "print(sorted(bad), out['correct'])\n"
        % (str(ROOT), str(BENCH / "tests")))
    env = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"}
    done = subprocess.run([sys.executable, "-c", code], cwd=str(BENCH),
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[] True"


def test_no_source_of_the_benchmark_names_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for line in path.read_text().splitlines():
            words = line.replace("(", " ").replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax",
                                   "cryo_ralib_tpu"), (path, line)


def test_a_module_loaded_after_the_window_withholds_the_result(
        monkeypatch, capsys):
    """A forbidden module that a metric reader or the check loads after
    the window has closed still stops the result from being printed."""
    out = {"correct": True, "checks": {"x": {"value": 0.0, "limit": 1.0}}}
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        harness.print_result(out)
    assert e.value.code == 3
    got = capsys.readouterr()
    assert got.out == "" and "forbidden modules loaded: jax" in got.err
