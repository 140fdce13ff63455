"""The PyTorch port's copied numpy modules against their JAX-package
originals, and the port's import boundary (no jax, no cryo_ralib_tpu)."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu.config import AlignConfig as JaxConfig
from cryo_ralib_tpu.ops.fsc import fit_tanh as jax_fit_tanh
from cryo_ralib_tpu.ops.fsc import fsc as jax_fsc
from cryo_ralib_tpu.utils import synthetic as jax_synthetic
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops.fsc import fit_tanh, fsc
from cryo_ralib_tpu_torch.utils import synthetic as port_synthetic

CONFIGS = {
    "headline": dict(img_dim=90, ring_num=36, shift_step=1.0,
                     shift_rng_x=3.0, shift_rng_y=3.0),
    "fractional_ts": dict(img_dim=64, ring_num=20, shift_step=0.5,
                          shift_rng_x=1.5, shift_rng_y=1.0),
    "mode_h": dict(img_dim=64, ring_num=20, shift_step=1.0,
                   shift_rng_x=2.0, shift_rng_y=2.0, mode="H"),
    "ir4_rs2": dict(img_dim=90, ring_num=12, first_ring=4, ring_step=2,
                    shift_step=1.0, shift_rng_x=2.0, shift_rng_y=2.0),
}
TABLES = ("polar_coords", "shifts", "shift_x_vals", "shift_y_vals",
          "ring_weights", "radii", "shift_limit", "angle_step", "n_shifts",
          "n_freq", "max_radius", "eman_rings", "eman_ring_weights")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_tables_equal_jax(name):
    port = AlignConfig(**CONFIGS[name])
    ref = JaxConfig(**CONFIGS[name])
    assert port == AlignConfig(**CONFIGS[name])
    for table in TABLES:
        got, want = getattr(port, table), getattr(ref, table)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=table)
        assert np.asarray(got).dtype == np.asarray(want).dtype, table


def test_config_rejects_like_jax():
    bad = dict(img_dim=48, ring_num=22, shift_rng_x=3.0, shift_rng_y=3.0)
    with pytest.raises(ValueError, match="crosses image boundary"):
        AlignConfig(**bad)
    with pytest.raises(ValueError, match="crosses image boundary"):
        JaxConfig(**bad)


def test_fsc_and_fit_tanh_equal_jax():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((48, 48)).astype(np.float32)
    a = base + 0.3 * rng.standard_normal((48, 48)).astype(np.float32)
    b = base + 0.3 * rng.standard_normal((48, 48)).astype(np.float32)
    got = fsc(a, b, 1.0)
    want = jax_fsc(a, b, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert fit_tanh(got) == jax_fit_tanh(want)


@pytest.mark.parametrize("name", ["class_templates", "asymmetric_templates",
                                  "blob_stack"])
def test_templates_equal_jax(name):
    np.testing.assert_array_equal(getattr(port_synthetic, name)(5, 48),
                                  getattr(jax_synthetic, name)(5, 48))


def test_unit_sigma_blobs_are_distinct_unit_sigma_templates():
    tmpl = port_synthetic.unit_sigma_blobs(12, 40)
    assert tmpl.shape == (12, 40, 40) and tmpl.dtype == np.float32
    np.testing.assert_allclose(tmpl.mean((1, 2)), 0.0, atol=1e-5)
    np.testing.assert_allclose(tmpl.std((1, 2)), 1.0, rtol=1e-5)
    # normalised jax_synthetic.blob_stack(..., blobs=6, noise=0.0) templates
    raw = jax_synthetic.blob_stack(12, 40, blobs=6, noise=0.0, seed=64)
    corr = (tmpl * (raw - raw.mean((1, 2), keepdims=True))).mean((1, 2))
    np.testing.assert_allclose(corr, raw.std((1, 2)), rtol=1e-5)
    flat = tmpl.reshape(12, -1)
    gram = flat @ flat.T / flat.shape[1]
    assert np.abs(gram[~np.eye(12, dtype=bool)]).max() < 0.99


def test_scattered_stack_shapes_and_truth():
    tmpl = port_synthetic.asymmetric_templates(3, 32)
    imgs, cls, angs, shifts, mirrors = port_synthetic.scattered_stack(
        tmpl, 6, max_shift=1, noise=0.0, seed=4)
    assert imgs.shape == (6, 32, 32) and imgs.dtype == torch.float32
    assert cls.shape == angs.shape == mirrors.shape == (6,)
    assert shifts.shape == (6, 2) and np.abs(shifts).max() <= 1
    assert set(np.unique(mirrors)) <= {0, 1}
    again = port_synthetic.scattered_stack(tmpl, 6, max_shift=1, noise=0.0,
                                           seed=4)
    assert torch.equal(imgs, again[0])
    # no mirrored copies: the same draws with every mirror flag 0
    flat = port_synthetic.scattered_stack(tmpl, 6, max_shift=1, noise=0.0,
                                          seed=4, mirror=False)
    for got, want in zip(flat[1:4], (cls, angs, shifts)):
        np.testing.assert_array_equal(got, want)
    assert (flat[4] == 0).all() and mirrors.any()
    unmirrored = mirrors == 0
    assert torch.equal(flat[0][unmirrored], imgs[unmirrored])


def test_port_imports_neither_jax_nor_jax_package():
    code = (
        "import sys, pkgutil, importlib, cryo_ralib_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'cryo_ralib_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_boundary_covers_every_module_and_chip_smoke():
    """The walk above reaches every module of the package (the modes'
    and the post-alignment modules among them), and no source file of the
    package, nor ``chip_smoke.py`` nor the port's examples and tools,
    names ``jax`` or ``cryo_ralib_tpu`` in an import, a lazy one inside a
    function included."""
    import ast
    import pathlib
    import pkgutil

    import cryo_ralib_tpu_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    assert {"cryo_ralib_tpu_torch.ops.scf",
            "cryo_ralib_tpu_torch.ops.eman_search",
            "cryo_ralib_tpu_torch.ops.ctf_ops",
            "cryo_ralib_tpu_torch.ops.fourvar",
            "cryo_ralib_tpu_torch.io.star",
            "cryo_ralib_tpu_torch.parallel.batching",
            "cryo_ralib_tpu_torch.parallel.mesh",
            "cryo_ralib_tpu_torch.utils.profiling",
            "cryo_ralib_tpu_torch.utils.oracle",
            "cryo_ralib_tpu_torch.analysis.reduction",
            "cryo_ralib_tpu_torch.analysis.plots",
            "cryo_ralib_tpu_torch.io.dataset",
            "cryo_ralib_tpu_torch.io.bdb",
            "cryo_ralib_tpu_torch.native"} <= names
    root = pathlib.Path(pkg.__file__).parent
    files = (sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
             + sorted(root.parent.glob("examples/torch_*.py"))
             + sorted(root.parent.glob("tools/torch_*.py")))
    assert len(files) > len(names)
    assert root.parent / "examples" / "torch_06_mesh_scaling.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad = [m for m in mods
                   if m.split(".")[0] in ("jax", "jaxlib", "cryo_ralib_tpu")]
            assert not bad, (path.name, bad)


def test_hdf_writers_read_back_by_jax_reader(tmp_path):
    pytest.importorskip("h5py")
    from cryo_ralib_tpu.io.eman_hdf import read_hdf_stack
    from cryo_ralib_tpu_torch.io.eman_hdf import write_hdf_stack, write_image

    rng = np.random.default_rng(2)
    imgs = rng.standard_normal((3, 8, 8)).astype(np.float32)
    path = str(tmp_path / "stack.hdf")
    write_hdf_stack(path, imgs[:2], headers=[{"ave_n": 4}, {"ave_n": 5}])
    write_hdf_stack(path, imgs[2], append=True)
    got, headers = read_hdf_stack(path)
    np.testing.assert_array_equal(got, imgs)
    assert [h.get("ave_n") for h in headers] == [4, 5, None]
    assert headers[0]["nx"] == 8
    write_image(path, imgs[0] * 2, 1, header={"members": [1.0, 3.0]})
    got, headers = read_hdf_stack(path)
    np.testing.assert_array_equal(got[1], imgs[0] * 2)
    assert headers[1]["members"] == [1.0, 3.0]
