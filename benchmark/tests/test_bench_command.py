"""The command refuses to print a result where it cannot measure: no
CUDA (this machine), and a directory that holds only BENCHMARK.json and
the benchmark's own files."""

from __future__ import annotations

import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

ARGS = ["--workload", "mref-k8", "--seed", str(2 ** 31 + 11), "--seconds",
        "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=str(cwd), capture_output=True, text=True,
                          timeout=120)


def test_no_cuda_no_result():
    done = _run(ROOT)
    assert done.returncode != 0
    assert "CUDA" in done.stderr
    assert not [l for l in done.stdout.splitlines() if l.startswith("{")]


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _run(tmp_path)
    assert done.returncode != 0
    assert "not in this checkout" in done.stderr
    assert not [l for l in done.stdout.splitlines() if l.startswith("{")]
