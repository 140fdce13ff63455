"""The port's aligned-dataset bundle (``cryo_ralib_tpu_torch/io/
dataset.py::HDFfile``) against the JAX package's, on the CPU.

A stack written by the port's HDF5 writer (read by JAX through h5py) or
as ``.mrcs``, with a 6-column params table, goes through
``HDFfile.load(...).aligned_particles()`` in both packages (the port's
with ``device="cpu"``): within 1e-4 (``rot_shift2d``'s tolerance,
tests/test_torch_rot_shift.py).  ``write`` round-trips the table.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from cryo_ralib_tpu.io.dataset import HDFfile as JaxHDFfile
from cryo_ralib_tpu_torch.io.dataset import HDFfile
from cryo_ralib_tpu_torch.io.eman_hdf import write_hdf_stack
from cryo_ralib_tpu_torch.io.mrc import write_mrc
from cryo_ralib_tpu_torch.io.star import write_text_row
from cryo_ralib_tpu_torch.ops import transform


@pytest.fixture()
def bundle(tmp_path):
    rng = np.random.default_rng(12)
    n, nx = 10, 36
    imgs = rng.standard_normal((n, nx, nx)).astype(np.float32)
    table = np.stack([np.arange(n), rng.uniform(0, 360, n),
                      rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                      rng.integers(0, 2, n), rng.integers(0, 3, n)], 1)
    paths = {"params": str(tmp_path / "params.txt"),
             "hdf": str(tmp_path / "stack.hdf"),
             "mrcs": str(tmp_path / "stack.mrcs")}
    write_text_row(table, paths["params"])
    write_hdf_stack(paths["hdf"], imgs)
    write_mrc(paths["mrcs"], imgs)
    return imgs, table, paths


@pytest.mark.parametrize("fmt", ["hdf", "mrcs"])
def test_aligned_particles_match_jax(bundle, fmt, monkeypatch):
    imgs, _table, paths = bundle
    port = HDFfile.load(paths[fmt], paths["params"])
    np.testing.assert_array_equal(port.get_particles(), imgs)
    want = JaxHDFfile.load(paths[fmt], paths["params"]).aligned_particles()
    got = port.aligned_particles(device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # by blocks of 3 (host blocks, each uploaded and read back): the same
    monkeypatch.setattr(transform, "transform_block", lambda h, w: 3)
    np.testing.assert_array_equal(port.aligned_particles(device="cpu"), got)


def test_write_round_trips_the_table(bundle, tmp_path):
    _imgs, table, paths = bundle
    port = HDFfile.load(paths["hdf"], paths["params"])
    out = str(tmp_path / "again.txt")
    port.write(out)
    JaxHDFfile.load(paths["hdf"], paths["params"]).write(
        str(tmp_path / "jax.txt"))
    assert open(out).read() == open(tmp_path / "jax.txt").read()
    again = HDFfile.load(paths["hdf"], out)
    for h in port.headers:
        np.testing.assert_array_equal(np.asarray(again.df[h]),
                                      np.asarray(port.df[h]))


def test_aligned_particles_default_to_cuda(bundle, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _imgs, _table, paths = bundle
    with pytest.raises(RuntimeError, match="CUDA"):
        HDFfile.load(paths["hdf"], paths["params"]).aligned_particles()
