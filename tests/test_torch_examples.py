"""The port's examples (``examples/torch_01_mref_workflow.py``,
``torch_02_batch_transform.py``, ``torch_03_eda.py``,
``torch_04_ctf_workflow.py``, ``torch_05_relion_ingest.py``,
``torch_06_mesh_scaling.py``, ``torch_07_ring_schemes.py``,
``torch_08_export_aligned.py``) run end to end on the CPU at a small
size, with their outputs checked; the export is also held to the JAX
example's files (tests/test_export_aligned.py's checks, and the same
aligned stack within ``rot_shift2d``'s 1e-4), and the RELION project the
port writes is read back by the JAX package's readers.
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


@pytest.mark.parametrize("sampler", ["auto", "matmul"])
def test_mref_workflow_example(tmp_path, capsys, sampler):
    """A small stack through ``mref_ali2d`` (the plain search, and the
    matmul sampler with its FFT-shear class sums): every class
    recovered, the last iteration's averages read back by the port's
    reader."""
    res, purity, avgs = _example("torch_01_mref_workflow").main(
        [str(tmp_path), "--device=cpu", "--n=48", "--nx=48", "--k=3",
         "--maxit=2", f"--sampler={sampler}"])
    text = capsys.readouterr().out
    assert f"sampler={sampler}" in text and "class purity" in text
    assert purity >= 0.9
    assert res.params.shape == (48, 4) and np.isfinite(res.params).all()
    assert avgs.shape == (3, 48, 48) and np.isfinite(avgs).all()
    assert {"stack.hdf", "refs.hdf", "run"} <= set(os.listdir(tmp_path))


def test_ctf_workflow_example(tmp_path, capsys):
    """With ``--CTF`` semantics the references correlate with the
    templates (measured 0.95, 0.99), where the plain run's do not
    (0.25, -0.08): a defocus series cancels structure in a plain
    average."""
    out = _example("torch_04_ctf_workflow").main(
        [str(tmp_path), "--device=cpu", "--n=32", "--nx=48"])
    assert "WITH CTF correction" in capsys.readouterr().out
    assert min(out["CTF"]) > 0.8
    assert min(out["CTF"]) > max(out["plain"])
    assert os.path.exists(tmp_path / "defocus.txt")


def test_relion_ingest_example(tmp_path):
    """The project the example writes is read the same by the JAX
    package's STAR and MRC readers (the particles bitwise, the CTF rows
    equal), and its CTF alignment gives finite params for every
    particle, apix 1.34 from the optics columns."""
    from cryo_ralib_tpu.io.star import Starfile as JaxStarfile
    from cryo_ralib_tpu.io.star import parse_ctf_star as jax_parse_ctf_star
    from cryo_ralib_tpu_torch.io.star import Starfile, parse_ctf_star

    res, apix, cls = _example("torch_05_relion_ingest").main(
        [str(tmp_path), "--device=cpu"])
    assert apix == pytest.approx(1.34)
    assert res.params.shape == (48, 4) and np.isfinite(res.params).all()
    assert int(res.class_counts.sum()) == 48 and len(cls) == 48
    star_path = str(tmp_path / "particles.star")
    port, jax_star = Starfile.load(star_path), JaxStarfile.load(star_path)
    got = np.stack(port.get_particles(datadir=str(tmp_path), lazy=False))
    want = np.stack(jax_star.get_particles(datadir=str(tmp_path),
                                           lazy=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        parse_ctf_star(port.df, d=64, angpix=None),
        jax_parse_ctf_star(jax_star.df, d=64, angpix=None))


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


def test_ring_schemes_example(capsys):
    """Both ring schemes, the eman2 one through the PyTorch search and
    through the template engine, recover the classes (the example
    asserts their agreement)."""
    res = _example("torch_07_ring_schemes").main(["--device=cpu",
                                                  "--n=24"])
    text = capsys.readouterr().out
    assert "maxrin = 128" in text and text.rstrip().endswith("OK")
    assert set(res) == {"cuda", "eman2", "eman2 template"}
    for r in res.values():
        assert r.params.shape == (24, 4) and np.isfinite(r.params).all()


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
    for name, argv in (("torch_01_mref_workflow", ["--n=4", "--nx=32"]),
                       ("torch_02_batch_transform", ["--n=4", "--nx=32"]),
                       ("torch_03_eda", ["--n=6"]),
                       ("torch_04_ctf_workflow", ["--n=4", "--nx=32"]),
                       ("torch_05_relion_ingest", []),
                       ("torch_07_ring_schemes", ["--n=6"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(name).main(argv)
