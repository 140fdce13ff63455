"""The port's I/O (``io/eman_hdf.py``, ``io/mrc.py``) against the JAX
package's, on the CPU.

The port writes EMAN2-layout HDF5 with a writer of its own (no h5py):
its files, read with h5py and with JAX's ``read_hdf_stack``, must give
bitwise the same images and equal headers as the JAX writer's (h5py's)
files for the same inputs, and its own reader must read them back.  A
string attribute is fixed-length in the port's files and
variable-length in h5py's: read through ``read_hdf_stack`` both are the
same text.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from cryo_ralib_tpu.io import eman_hdf as J
from cryo_ralib_tpu.io import mrc as jax_mrc
from cryo_ralib_tpu_torch.io import eman_hdf as P
from cryo_ralib_tpu_torch.io import mrc as port_mrc

HEADERS = [
    {"ave_n": 7, "members": [0.0, 3.0, 5.0], "flag": True},
    {"score": 0.125, "name": "class one", "empty": "", "unicode": "Å"},
    {"xform.align2d": {"alpha": 10.5, "tx": -1.0, "mirror": 1},
     "tags": ["a", "b"], "ids": np.arange(4), "grid": np.ones((2, 3))},
    {},
]


def _images(n, h=6, w=5, seed=0):
    return np.random.default_rng(seed).standard_normal((n, h, w)).astype(
        np.float32)


def _raw(path):
    """{slot: (image, {attr: value})} through h5py, strings decoded."""
    out = {}
    with h5py.File(path, "r") as f:
        grp = f["MDF/images"]
        out["imageid_max"] = grp.attrs["imageid_max"]
        for name in grp:
            attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                     for k, v in grp[name].attrs.items()}
            out[int(name)] = (grp[name]["image"][()], attrs)
    return out


def _assert_same_file(port_path, jax_path, indices=None):
    a, b = _raw(port_path), _raw(jax_path)
    assert a.keys() == b.keys()
    assert a.pop("imageid_max") == b.pop("imageid_max")
    for slot in b:
        ia, ha = a[slot]
        ib, hb = b[slot]
        assert ia.dtype == ib.dtype == np.float32
        assert ia.tobytes() == ib.tobytes()
        assert ha.keys() == hb.keys()
        for k in hb:
            va, vb = np.asarray(ha[k]), np.asarray(hb[k])
            if vb.dtype.kind in "if":
                assert va.dtype == vb.dtype and va.shape == vb.shape, k
            np.testing.assert_array_equal(va, vb, err_msg=k)
    got, got_h = J.read_hdf_stack(port_path, indices)
    want, want_h = J.read_hdf_stack(jax_path, indices)
    assert got.tobytes() == want.tobytes() and got_h == want_h
    own, own_h = P.read_own_hdf(port_path, indices)
    assert own.tobytes() == want.tobytes() and own_h == want_h


def _both(tmp_path, write, indices=None):
    """Run ``write(module, path)`` with both packages' writers."""
    paths = {}
    for name, mod in (("port", P), ("jax", J)):
        paths[name] = str(tmp_path / f"{name}.hdf")
        write(mod, paths[name])
    _assert_same_file(paths["port"], paths["jax"], indices)
    return paths


def test_lookup3_vectors():
    """Bob Jenkins' published hashlittle values, and the checksum that
    HDF5 stored in a superblock that h5py wrote."""
    assert P.lookup3(b"") == 0xDEADBEEF
    assert P.lookup3(b"Four score and seven years ago") == 0x17770551


def test_lookup3_matches_hdf5(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_group("g").attrs["x"] = np.arange(40, dtype=np.float32)
    buf = open(path, "rb").read()
    assert buf[8] >= 2       # a checksummed superblock
    assert P.lookup3(buf[:44]) == int.from_bytes(buf[44:48], "little")


def test_write_hdf_stack_matches_jax(tmp_path):
    imgs = _images(4)
    _both(tmp_path, lambda m, p: m.write_hdf_stack(p, imgs, HEADERS))


def test_write_single_image_and_no_headers(tmp_path):
    imgs = _images(3, 8, 8, seed=1)
    _both(tmp_path, lambda m, p: m.write_hdf_stack(p, imgs))
    _both(tmp_path, lambda m, p: m.write_hdf_stack(p, imgs[0], [HEADERS[0]]))


def test_append_matches_jax(tmp_path):
    imgs = _images(5, seed=2)

    def write(m, p):
        m.write_hdf_stack(p, imgs[:2], HEADERS[:2])
        m.write_hdf_stack(p, imgs[2:4], HEADERS[2:4], append=True)
        m.write_hdf_stack(p, imgs[4], append=True)
    paths = _both(tmp_path, write)
    assert P.get_image_count(paths["port"]) == 5


def test_write_image_past_the_end_and_over_a_slot(tmp_path):
    """A slot past the end leaves a gap (``imageid_max`` moves, no
    groups in between); a slot written over keeps the header attributes
    that the new header does not set."""
    imgs = _images(4, seed=3)

    def write(m, p):
        m.write_image(p, imgs[0], header=HEADERS[0])       # slot 0
        m.write_image(p, imgs[1])                          # slot 1
        m.write_image(p, imgs[2], 5, header={"ave_n": 9})  # past the end
        m.write_image(p, imgs[3], 0, header={"ave_n": 2})  # over slot 0
        m.write_image(p, imgs[1], 1, header={"members": [1.0]})
    paths = _both(tmp_path, write, indices=[0, 1, 5])
    raw = _raw(paths["port"])
    assert sorted(k for k in raw if k != "imageid_max") == [0, 1, 5]
    assert raw["imageid_max"] == 5
    assert raw[0][1]["EMAN.ave_n"] == 2
    np.testing.assert_array_equal(raw[0][1]["EMAN.members"], [0.0, 3.0, 5.0])
    got, hdr = P.read_own_hdf(paths["port"], indices=[5, 0])
    assert hdr[0]["ave_n"] == 9 and got[1].tobytes() == imgs[3].tobytes()


def test_k64_stack_matches_jax(tmp_path):
    """A K=64 class-average stack, ``members`` of up to 1000 particles."""
    imgs = _images(64, 90, 90, seed=4)
    rng = np.random.default_rng(5)
    headers = [{"ave_n": int(c), "members": sorted(
        float(v) for v in rng.choice(20000, c, replace=False))}
        for c in rng.integers(4, 1000, 64)]
    paths = _both(tmp_path, lambda m, p: m.write_hdf_stack(p, imgs, headers))
    assert P.get_image_count(paths["port"]) == 64


@pytest.mark.parametrize("n", [16364, 16365, 16366, 16383, 16384])
def test_members_limit_like_h5py(tmp_path, n):
    """One object-header message holds 64 KiB, so ``members`` of more
    than 16364 particles do not fit: from 16366 on h5py refuses to write
    them, and at 16365 it writes a file that it cannot read.  The port's
    writer raises from 16365 on, before it writes anything; below, both
    files agree."""
    imgs = _images(1, seed=6)
    hdr = [{"ave_n": n, "members": np.arange(n, dtype=np.float64)}]
    if n <= 16364:
        _both(tmp_path, lambda m, p: m.write_hdf_stack(p, imgs, hdr))
        return
    jax_path = str(tmp_path / "jax.hdf")
    with pytest.raises(Exception, match="message is too large|not aligned"):
        J.write_hdf_stack(jax_path, imgs, hdr)
        J.read_hdf_stack(jax_path)
    path = str(tmp_path / "port.hdf")
    with pytest.raises(ValueError, match="members"):
        P.write_hdf_stack(path, imgs, hdr)
    assert not [f for f in os.listdir(tmp_path) if f.startswith("port.hdf")]


def test_h5py_can_update_the_ports_files(tmp_path):
    """HDF5 itself edits a file the port wrote (h5py adds attributes and
    a group), and the port reads the result."""
    path = str(tmp_path / "port.hdf")
    P.write_hdf_stack(path, _images(3, seed=7), HEADERS[:3])
    J.update_headers(path, [{"assign": 1}, {"assign": 0}])
    with h5py.File(path, "a") as f:
        f["MDF/images/2"].attrs["EMAN.big"] = np.zeros(5000, np.float32)
    _, hdr = P.read_hdf_stack(path)
    assert [h.get("assign") for h in hdr] == [1, 0, None]
    assert len(hdr[2]["big"]) == 5000


def test_update_headers_matches_jax(tmp_path):
    """``update_headers`` on a file the port wrote (the port rewrites it)
    and on one h5py wrote (through h5py) agree with JAX's."""
    imgs = _images(3, seed=8)
    updates = [{"assign": 2, "xform.align2d": {"alpha": 1.5}},
               {"assign": 0}]
    for writer in (P, J):
        paths = {}
        for name, mod in (("port", P), ("jax", J)):
            paths[name] = str(tmp_path / f"{name}_{writer.__name__}.hdf")
            writer.write_hdf_stack(paths[name], imgs, HEADERS[:3])
            mod.update_headers(paths[name], updates, indices=[2, 0])
        assert (P.read_hdf_stack(paths["port"])[1]
                == J.read_hdf_stack(paths["jax"])[1])


def test_foreign_files_need_h5py(tmp_path, monkeypatch):
    """A file the port did not write is read through h5py, and without
    h5py the port raises ImportError naming it; its own files need none
    (read, append, write over a slot, update)."""
    imgs = _images(3, seed=9)
    foreign, own = str(tmp_path / "jax.hdf"), str(tmp_path / "port.hdf")
    J.write_hdf_stack(foreign, imgs, HEADERS[:3])
    P.write_hdf_stack(own, imgs, HEADERS[:3])
    with pytest.raises(ValueError, match="not written by this package"):
        P.read_own_hdf(foreign)
    assert P.read_hdf_stack(foreign)[1] == J.read_hdf_stack(foreign)[1]

    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: P.read_hdf_stack(foreign),
                 lambda: P.get_image_count(foreign),
                 lambda: P.write_image(foreign, imgs[0]),
                 lambda: P.write_hdf_stack(foreign, imgs, append=True),
                 lambda: P.update_headers(foreign, [{"a": 1}])):
        with pytest.raises(ImportError, match="h5py"):
            call()
    P.write_hdf_stack(own, imgs[:1], append=True)
    P.write_image(own, imgs[2], 1, header={"ave_n": 3})
    P.update_headers(own, [{"assign": 4}])
    got, hdr = P.read_hdf_stack(own)
    assert P.get_image_count(own) == 4
    assert hdr[0]["assign"] == 4 and hdr[1]["ave_n"] == 3
    assert got[1].tobytes() == imgs[2].tobytes()


def test_mrc_round_trip_matches_jax(tmp_path):
    data = _images(5, 12, 10, seed=10)
    paths = {"port": str(tmp_path / "port.mrcs"),
             "jax": str(tmp_path / "jax.mrcs")}
    port_mrc.write_mrc(paths["port"], data, apix=1.7)
    jax_mrc.write_mrc(paths["jax"], data, apix=1.7)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    for path in paths.values():
        hp, hj = port_mrc.parse_header(path), jax_mrc.parse_header(path)
        assert vars(hp) == vars(hj) and hp.D == hj.D == 10
        np.testing.assert_array_equal(port_mrc.read_mrc(path), data)
        np.testing.assert_array_equal(port_mrc.read_mrc(path, [3, 0]),
                                      jax_mrc.read_mrc(path, [3, 0],
                                                       native=False))
        # the threaded native reader where it is built, numpy elsewhere:
        # the same bits either way
        np.testing.assert_array_equal(port_mrc.read_mrc(path, native=True),
                                      port_mrc.read_mrc(path, native=False))
        np.testing.assert_array_equal(
            port_mrc.read_mrc(path, [3, 0], native=True),
            port_mrc.read_mrc(path, [3, 0], native=False))


def test_mrc_lazy_image_matches_jax(tmp_path):
    data = _images(3, 8, 8, seed=11)
    path = str(tmp_path / "s.mrcs")
    port_mrc.write_mrc(path, data)
    for i in range(3):
        off = port_mrc.HEADER_SIZE + i * 8 * 8 * 4
        got = port_mrc.LazyImage(path, (8, 8), np.float32, off).get()
        want = jax_mrc.LazyImage(path, (8, 8), np.float32, off).get()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, data[i])


# ---- io/star.py: a numpy-only copy of the JAX package's module

STAR_TEXT = (
    "# Created by a test\n\ndata_\n\nloop_\n_rlnImageName #1\n"
    "_rlnDefocusU #2\n_rlnDefocusV #3\n_rlnDefocusAngle #4\n_rlnVoltage #5\n"
    "_rlnSphericalAberration #6\n_rlnAmplitudeContrast #7\n"
    "_rlnPhaseShift #8\n_rlnDetectorPixelSize #9\n_rlnMagnification #10\n"
    "1@stack.mrcs 12000.0 11800.0 35.0 200.0 2.0 0.07 10.0 5.0 29411.76\n"
    "3@stack.mrcs 15000.0 15100.0 80.0 200.0 2.0 0.07 45.0 5.0 29411.76\n"
    "2@stack.mrcs 9000.0 9100.0 5.0 200.0 2.0 0.07 0.0 5.0 29411.76\n")
STAR_31 = ("data_optics\n\nloop_\n_rlnOpticsGroup #1\n1\n\n"
           "data_particles\n\nloop_\n_rlnDefocusU #1\n_rlnDefocusV #2\n"
           "12000.0 11000.0\n13000.0 12500.0\n")


def _star_modules():
    from cryo_ralib_tpu.io import star as jax_star
    from cryo_ralib_tpu_torch.io import star as port_star
    return port_star, jax_star


@pytest.mark.parametrize("text,relion31", [(STAR_TEXT, False),
                                           (STAR_31, True)])
def test_starfile_load_equals_jax(tmp_path, text, relion31):
    port_star, jax_star = _star_modules()
    path = tmp_path / "p.star"
    path.write_text(text)
    got = port_star.Starfile.load(str(path), relion31=relion31)
    want = jax_star.Starfile.load(str(path), relion31=relion31)
    assert got.headers == want.headers and len(got.df) == len(want.df)
    for h in want.headers:
        assert list(got.df[h]) == list(want.df[h])
    assert got.df.row(1) == want.df.row(1)
    empty = tmp_path / "empty.star"
    empty.write_text("# nothing\n")
    for load in (port_star.Starfile.load, jax_star.Starfile.load):
        with pytest.raises(ValueError, match="no data_"):
            load(str(empty))


@pytest.mark.parametrize("angpix", [None, 1.25])
def test_parse_ctf_star_equals_jax(tmp_path, angpix):
    port_star, jax_star = _star_modules()
    path = tmp_path / "p.star"
    path.write_text(STAR_TEXT)
    got = port_star.parse_ctf_star(port_star.Starfile.load(str(path)).df,
                                   d=48, angpix=angpix)
    want = jax_star.parse_ctf_star(jax_star.Starfile.load(str(path)).df,
                                   d=48, angpix=angpix)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 9) and got[1, 2] == 15000.0
    assert got[0, 1] == (angpix or 5.0 * 10000 / 29411.76)


def test_starfile_write_and_particles_equal_jax(tmp_path):
    """A written STAR file loads back; ``get_particles`` reads the images
    the rows name (``index@stack.mrcs``, 1-based) like the JAX reader."""
    port_star, jax_star = _star_modules()
    imgs = _images(3, 8, 8)
    port_mrc.write_mrc(str(tmp_path / "stack.mrcs"), imgs)
    src = tmp_path / "p.star"
    src.write_text(STAR_TEXT)
    star = port_star.Starfile.load(str(src))
    out = tmp_path / "w.star"
    star.write(str(out))
    back = jax_star.Starfile.load(str(out))
    assert back.headers == star.headers
    assert list(back.df["_rlnDefocusU"]) == list(star.df["_rlnDefocusU"])
    got = port_star.Starfile.load(str(out)).get_particles(
        datadir=str(tmp_path), lazy=False)
    want = back.get_particles(datadir=str(tmp_path), lazy=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, imgs[[0, 2, 1]])


def test_params_table_and_text_rows_equal_jax(tmp_path):
    port_star, jax_star = _star_modules()
    rows = np.array([[0, 10.5, -1.0, 2.0, 1, 3], [1, 359.9, 0.25, 0.0, 0, 0]])
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    port_star.write_text_row(rows, a)
    jax_star.write_text_row(rows, b)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    got, want = port_star.read_params_table(a), jax_star.read_params_table(a)
    assert got.headers == want.headers == port_star.PARAMS_HEADERS
    for h in want.headers:
        np.testing.assert_array_equal(got[h], want[h])
    assert "class" in got and len(got) == 2
