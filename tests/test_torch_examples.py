"""The port's examples (``examples/torch_02_batch_transform.py``,
``torch_03_eda.py``, ``torch_06_mesh_scaling.py``,
``torch_08_export_aligned.py``) run end to end on the CPU at a small
size, with their outputs checked; the export is also held to the JAX
example's files (tests/test_export_aligned.py's checks, and the same
aligned stack within ``rot_shift2d``'s 1e-4).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf
from cryo_ralib_tpu_torch.utils.synthetic import (class_templates,
                                                  scattered_stack)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_batch_transform_example(capsys):
    out = _example("torch_02_batch_transform").main(
        ["--device=cpu", "--n=24", "--nx=40"])
    text = capsys.readouterr().out
    assert "rot_shift2d (quadri)" in text and "[cpu]" in text
    assert out["quadri"].shape == (24, 40, 40)
    # the inverse transforms bring every particle back onto its template
    assert out["error"] < 0.05


def test_eda_example(capsys):
    aligned, pur = _example("torch_03_eda").main(["--device=cpu", "--n=60"])
    assert aligned.shape == (60, 64, 64) and np.isfinite(aligned).all()
    assert set(pur) == {"twosdr", "twosdr_class", "mpca"}
    assert all(0.0 < v <= 1.0 for v in pur.values())
    assert "alignment purity: 1.000" in capsys.readouterr().out


def test_mesh_scaling_example_on_two_cpu_ranks():
    """Two gloo ranks (processes the example starts, within 120 s): one
    sharded step whose all-reduced counts cover the stack, and three
    engine iterations with purity > 0.9 (the example asserts it)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_06_mesh_scaling.py"),
         "--device=cpu", "--ranks=2", "--n=64"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "2 ranks, backend gloo, rank 0 on cpu"
    counts = json.loads(lines[1].split("counts=")[1].split("],")[0] + "]")
    assert sum(counts) == 64
    assert "3 engine iterations: purity=" in lines[2] and lines[-1] == "ok"


def test_export_load_params_formats(tmp_path):
    ex = _example("torch_08_export_aligned")
    p4 = tmp_path / "p4.txt"
    np.savetxt(p4, np.asarray([[10.0, 1.0, -1.0, 0], [350.0, 0.0, 2.0, 1]]))
    a, sx, sy, m, cls = ex.load_params(str(p4))
    assert cls is None and m.dtype == np.int32
    np.testing.assert_allclose(a, [10.0, 350.0])
    p6 = tmp_path / "p6.txt"
    np.savetxt(p6, np.asarray([[0, 10.0, 1.0, -1.0, 0, 2],
                               [1, 350.0, 0.0, 2.0, 1, 0]]))
    a, sx, sy, m, cls = ex.load_params(str(p6))
    np.testing.assert_array_equal(cls, [2, 0])
    p2 = tmp_path / "p2.txt"
    np.savetxt(p2, np.asarray([[1.0, 2.0]]))
    with pytest.raises(SystemExit, match="columns"):
        ex.load_params(str(p2))


def test_export_aligned_matches_jax_example(tmp_path):
    """Undoing known rotations reconstructs the templates; the files read
    back by the port's reader (no h5py) with zeroed ``xform.align2d`` and
    ``assign`` headers and ``members`` counts, and the aligned stack is
    the JAX example's within 1e-4."""
    jax_ex = _example("08_export_aligned")
    ex = _example("torch_08_export_aligned")
    nx, n, k = 48, 32, 2
    refs = class_templates(k, nx)
    imgs, cls, angs = scattered_stack(refs, n, max_shift=0, noise=0.0,
                                      seed=4, mirror=False)[:3]
    imgs = imgs.numpy()
    alpha = (360.0 - angs) % 360.0
    zero = np.zeros(n, np.float32)
    cls = cls.astype(np.int32)
    stack_path, avg_path, aligned = ex.export_aligned(
        imgs, alpha, zero, zero, np.zeros(n, np.int32), cls,
        str(tmp_path / "port"), device="cpu")
    back, headers = read_own_hdf(stack_path)
    np.testing.assert_array_equal(back, aligned)
    xf = json.loads(headers[0]["xform.align2d"])
    assert float(xf["alpha"]) == 0.0 and int(xf["mirror"]) == 0
    assert [int(h["assign"]) for h in headers] == list(cls)
    avgs, avg_headers = read_own_hdf(avg_path)
    assert avgs.shape == (k, nx, nx)
    np.testing.assert_array_equal([int(h["members"]) for h in avg_headers],
                                  np.bincount(cls, minlength=k))
    yy, xx = np.mgrid[0:nx, 0:nx]
    mask = (yy - nx // 2) ** 2 + (xx - nx // 2) ** 2 <= (nx // 2 - 4) ** 2
    for j in range(k):
        assert np.abs((avgs[j] - refs[j]) * mask).mean() < 0.05, j

    _, _, want = jax_ex.export_aligned(imgs, alpha, zero, zero,
                                       np.zeros(n, np.int32), cls,
                                       str(tmp_path / "jax"))
    np.testing.assert_allclose(aligned, want, rtol=0, atol=1e-4)


def test_export_main_on_files(tmp_path, capsys):
    """``main stack params outdir``: a .mrcs stack and a 5-column params
    table (alpha sx sy mirror class) through the command line."""
    from cryo_ralib_tpu_torch.io.mrc import write_mrc

    ex = _example("torch_08_export_aligned")
    rng = np.random.default_rng(2)
    imgs = rng.standard_normal((6, 32, 32)).astype(np.float32)
    table = np.stack([rng.uniform(0, 360, 6), rng.uniform(-2, 2, 6),
                      rng.uniform(-2, 2, 6), rng.integers(0, 2, 6),
                      rng.integers(0, 2, 6)], 1)
    write_mrc(str(tmp_path / "s.mrcs"), imgs)
    np.savetxt(tmp_path / "p.txt", table)
    out = str(tmp_path / "out")
    stack_path, avg_path, aligned = ex.main(
        [str(tmp_path / "s.mrcs"), str(tmp_path / "p.txt"), out,
         "--device=cpu"])
    assert "round-trip check ok" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["aligned.hdf", "class_avgs.hdf"]
    assert aligned.shape == (6, 32, 32)
    with pytest.raises(SystemExit, match="params rows"):
        np.savetxt(tmp_path / "short.txt", table[:3])
        ex.main([str(tmp_path / "s.mrcs"), str(tmp_path / "short.txt"),
                 str(tmp_path / "out2"), "--device=cpu"])


def test_examples_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("torch_02_batch_transform", ["--n=4", "--nx=32"]),
                       ("torch_03_eda", ["--n=6"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(name).main(argv)
