"""EMAN2 ``bdb:`` containers in the port (``cryo_ralib_tpu_torch/io/
bdb.py``, a copy of the JAX package's, and the CLI's ``bdb:`` input).

Every case runs on two backends of ``Db185``: the system's libdb (skipped
where there is none, as tests/test_bdb.py is) and a dict-backed stand-in
with the same interface, monkeypatched into both packages' modules, so
the container layout and the CLI path are exercised everywhere.  Images
and headers must be equal between the packages, and ``cli.reffree`` on a
``bdb:`` stack (``device="cpu"``, ``--sampler=gather``) must write the
same params as on an ``.hdf`` copy of it.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu.io import bdb as jax_bdb
from cryo_ralib_tpu_torch.io import bdb


class _StandInDb:
    """A ``Db185`` kept in a dict per file path (raw key bytes -> raw
    value bytes), creating the file on disk as libdb would."""

    files: dict = {}

    def __init__(self, path: str, create: bool = False):
        if create:
            open(path, "ab").close()
            self.files.setdefault(path, {})
        elif path not in self.files:
            raise OSError(f"cannot open Berkeley DB file {path!r}")
        self._d = self.files[path]

    def get(self, key: bytes):
        return self._d.get(key)

    def put(self, key: bytes, val: bytes):
        self._d[key] = val

    def items(self):
        yield from list(self._d.items())

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.fixture(params=["libdb", "stand_in"])
def backend(request, monkeypatch):
    if request.param == "libdb":
        if bdb._load_libdb() is None:
            pytest.skip("no libdb with the DB 1.85 API")
    else:
        monkeypatch.setattr(_StandInDb, "files", {})
        for mod in (bdb, jax_bdb):
            monkeypatch.setattr(mod, "Db185", _StandInDb)
    return request.param


def _spec(tmp_path, name="stack"):
    return f"bdb:{tmp_path}#{name}"


def test_parse_bdb_path_equals_jax():
    for spec in ("bdb:proj/particles#stack", "bdb:stack", "bdb:a/b"):
        assert bdb.parse_bdb_path(spec) == jax_bdb.parse_bdb_path(spec)
    d, f = bdb.parse_bdb_path("bdb:proj/particles#stack")
    assert d == os.path.join("proj/particles", "EMAN2DB")
    assert f.endswith("stack.bdb")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_round_trip_across_packages(backend, tmp_path, writer, reader):
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((6, 16, 12)).astype(np.float32)
    mods = {"port": bdb, "jax": jax_bdb}
    spec = _spec(tmp_path)
    mods[writer].write_bdb_stack(spec, imgs, headers=[{"apix_x": 1.5}] * 6)
    got, headers = mods[reader].read_bdb_stack(spec)
    np.testing.assert_array_equal(got, imgs)
    assert headers[0]["apix_x"] == 1.5 and headers[3]["data_n"] == 3
    assert os.path.exists(tmp_path / "EMAN2DB" / "stack_12x16x1")
    again, headers2 = bdb.read_bdb_stack(spec)
    assert headers2 == jax_bdb.read_bdb_stack(spec)[1] == headers


def test_header_writeback_equals_jax(backend, tmp_path):
    imgs = np.arange(3 * 8 * 8, dtype=np.float32).reshape(3, 8, 8)
    updates = [{"xform.align2d": {"alpha": 10.0 * i}, "assign": i}
               for i in range(3)]
    results = []
    for mod, name in ((bdb, "port"), (jax_bdb, "jax")):
        spec = _spec(tmp_path, name)
        mod.write_bdb_stack(spec, imgs)
        mod.update_bdb_headers(spec, updates)
        results.append(mod.read_bdb_stack(spec))
    (got, hp), (want, hj) = results
    np.testing.assert_array_equal(got, want)
    strip = [{k: v for k, v in h.items() if k != "data_path"}
             for h in hp + hj]
    assert strip[:3] == strip[3:]
    assert hp[2]["assign"] == 2 and hp[1]["xform.align2d"]["alpha"] == 10.0


def test_foreign_generation_keys(backend, tmp_path):
    """Keys pickled by other EMAN2 generations (py2 SHORT_BINSTRING,
    py3 protocol 4) are decoded, and write-back updates those records in
    place."""
    rng = np.random.default_rng(7)
    imgs = rng.standard_normal((3, 8, 8)).astype(np.float32)
    spec = _spec(tmp_path, "py2like")
    dbdir, dbfile = bdb.parse_bdb_path(spec)
    os.makedirs(dbdir, exist_ok=True)
    side = "py2like_8x8x1"
    with open(os.path.join(dbdir, side), "wb") as f:
        f.write(np.ascontiguousarray(imgs, "<f4").tobytes())
    py2_maxrec_key = b"\x80\x02U\x06maxrecq\x00."
    with bdb.Db185(dbfile, create=True) as db:
        for i in range(3):
            hdr = {"nx": 8, "ny": 8, "nz": 1, "data_path": side,
                   "data_n": i, "apix_x": 1.2}
            db.put(pickle.dumps(i, 4), pickle.dumps(hdr, 4))
        db.put(py2_maxrec_key, pickle.dumps(2, 4))
    got, headers = bdb.read_bdb_stack(spec)
    np.testing.assert_array_equal(got, imgs)
    assert headers[1]["apix_x"] == 1.2
    bdb.update_bdb_headers(spec, [{"assign": i} for i in range(3)])
    with bdb.Db185(dbfile) as db:
        assert sum(1 for _ in db.items()) == 4
    assert [h["assign"] for h in bdb.read_bdb_stack(spec)[1]] == [0, 1, 2]


def test_load_stack_accepts_bdb(backend, tmp_path):
    from cryo_ralib_tpu.cli.common import load_stack as jax_load_stack
    from cryo_ralib_tpu_torch.cli.common import load_stack

    imgs = np.random.default_rng(0).standard_normal((4, 12, 12)).astype(
        np.float32)
    spec = _spec(tmp_path)
    bdb.write_bdb_stack(spec, imgs)
    got, headers = load_stack(spec)
    want, jheaders = jax_load_stack(spec)
    np.testing.assert_array_equal(got, imgs)
    np.testing.assert_array_equal(got, want)
    assert len(headers) == 4 and headers == jheaders


def test_torch_bdb_to_hdf_converter(backend, tmp_path):
    import tools.torch_bdb_to_hdf as conv
    from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf

    imgs = np.random.default_rng(1).standard_normal((5, 10, 10)).astype(
        np.float32)
    spec = _spec(tmp_path)
    bdb.write_bdb_stack(spec, imgs, headers=[{"ctf_defocus": 2.1}] * 5)
    dst = str(tmp_path / "out.hdf")
    assert conv.main([spec, dst]) == 0
    got, headers = read_own_hdf(dst)
    np.testing.assert_array_equal(got, imgs)
    assert "data_path" not in headers[0]
    assert headers[0]["ctf_defocus"] == pytest.approx(2.1)
    assert conv.main(["stack.hdf", dst]) == 2


def test_reffree_cli_on_bdb_equals_hdf(backend, tmp_path):
    """``cli.reffree`` reads a ``bdb:`` stack and writes the params back
    into it (``--header_writeback``); its params equal those of the same
    run on an ``.hdf`` copy."""
    from cryo_ralib_tpu_torch.cli import reffree
    from cryo_ralib_tpu_torch.io.eman_hdf import write_hdf_stack

    rng = np.random.default_rng(9)
    nx = 32
    base = np.zeros((nx, nx), np.float32)
    base[10:22, 14:18] = 1.0
    imgs = np.stack([base + 0.05 * rng.standard_normal((nx, nx))
                     for _ in range(8)]).astype(np.float32)
    spec = _spec(tmp_path, "parts")
    bdb.write_bdb_stack(spec, imgs)
    hdf = str(tmp_path / "parts.hdf")
    write_hdf_stack(hdf, imgs)
    flags = ["--ou=12", "--xr=1", "--ts=1", "--maxit=2", "--sampler=gather",
             "--function=ref_ali2d_no_filter", "--header_writeback"]
    outs = {}
    for name, stack in (("bdb", spec), ("hdf", hdf)):
        outs[name] = str(tmp_path / f"out_{name}")
        assert reffree.main([stack, outs[name]] + flags, device="cpu") == 0
    params = [np.loadtxt(os.path.join(outs[name], "initial2Dparams.txt"))
              for name in ("bdb", "hdf")]
    np.testing.assert_array_equal(params[0], params[1])
    _got, headers = bdb.read_bdb_stack(spec)
    xf = headers[0]["xform.align2d"]
    assert xf["alpha"] == pytest.approx(params[0][0, 0])
    assert xf["mirror"] == int(params[0][0, 3])
