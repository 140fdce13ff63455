"""EMAN2 BDB container I/O (read + minimal write) via the system libdb
(a copy of ``cryo_ralib_tpu/io/bdb.py``).

The reference's third CLI reads particle stacks from EMAN2 ``bdb:``
containers and writes params back (the reference's
test_mref_cheng_yu_bdb_cuda.py:1363-1375,155-210) through
EMAN2's database runtime.  That runtime (``EMAN2db.py``) stores, per
dictionary ``name`` inside a ``EMAN2DB/`` directory:

* ``EMAN2DB/name.bdb`` — a Berkeley-DB **btree** database mapping
  ``pickle(key)`` -> ``pickle(value)``.  Image number ``i`` maps to the
  image's pickled header attribute dict; the special key ``"maxrec"``
  holds the highest image number.
* the image pixel data in a flat side file
  ``EMAN2DB/name_<nx>x<ny>x<nz>`` of raw little-endian float32 images;
  the header carries ``data_path`` (path to that file, relative to the
  EMAN2DB dir or absolute) and ``data_n`` (the image's index into it).

This module reads (and, for fixtures/conversion, writes) that layout
without EMAN2, binding the system ``libdb`` through its stable DB 1.85
compatibility API (``__db185_open`` — a flat function table, no
version-specific struct offsets).  Big-endian or encrypted databases are
not supported; the loud conversion error remains the fallback when
libdb is unavailable.

``bdb:`` path syntax (EMAN2 convention): ``bdb:dir#name`` ->
``dir/EMAN2DB/name.bdb``; ``bdb:name`` -> ``./EMAN2DB/name.bdb``.
"""

from __future__ import annotations

import ctypes
import os
import pickle

import numpy as np

_DB_BTREE = 1
_R_FIRST, _R_NEXT = 3, 7


class _DBT(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t)]


def _load_libdb():
    for name in ("libdb-5.3.so", "libdb-5.1.so", "libdb.so", "libdb-18.1.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            # getattr: a literal attribute would be class-name-mangled
            # at call sites inside Db185
            fn = getattr(lib, "__db185_open")
        except AttributeError:
            continue
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        return lib
    return None


class Db185:
    """Minimal ctypes wrapper over the DB 1.85 compat API.

    The ``struct __db185`` layout (db185.h) is: ``DBTYPE type`` (int,
    padded to 8) followed by the function pointers ``close, del, get,
    put, seq, sync`` then ``internal, fd`` — a stable public ABI since
    4.4BSD, unlike the versioned DB 4/5 handle structs.
    """

    _FN_SIGS = {
        "close": (0, (ctypes.c_int, ctypes.c_void_p)),
        "get": (2, (ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_DBT),
                    ctypes.POINTER(_DBT), ctypes.c_uint)),
        "put": (3, (ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_DBT),
                    ctypes.POINTER(_DBT), ctypes.c_uint)),
        "seq": (4, (ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_DBT),
                    ctypes.POINTER(_DBT), ctypes.c_uint)),
        "sync": (5, (ctypes.c_int, ctypes.c_void_p, ctypes.c_uint)),
    }

    def __init__(self, path: str, create: bool = False):
        lib = _load_libdb()
        if lib is None:
            raise RuntimeError(
                "no usable libdb with the DB 1.85 compat API on this "
                "system; convert the bdb: container to HDF with EMAN2's "
                "e2proc2d.py instead")
        flags = (os.O_CREAT | os.O_RDWR) if create else os.O_RDONLY
        self._h = getattr(lib, "__db185_open")(path.encode(), flags, 0o644,
                                               _DB_BTREE, None)
        if not self._h:
            raise OSError(f"cannot open Berkeley DB file {path!r}")
        self._fns = {}
        for name, (idx, sig) in self._FN_SIGS.items():
            addr = ctypes.cast(self._h + 8 + idx * 8,
                               ctypes.POINTER(ctypes.c_void_p)).contents.value
            self._fns[name] = ctypes.CFUNCTYPE(*sig)(addr)

    @staticmethod
    def _dbt(b: bytes) -> _DBT:
        buf = ctypes.create_string_buffer(b, len(b))
        d = _DBT(ctypes.cast(buf, ctypes.c_void_p), len(b))
        d._buf = buf  # keep alive
        return d

    def get(self, key: bytes) -> bytes | None:
        k = self._dbt(key)
        out = _DBT()
        rc = self._fns["get"](self._h, ctypes.byref(k), ctypes.byref(out), 0)
        if rc != 0:
            return None
        return ctypes.string_at(out.data, out.size)

    def put(self, key: bytes, val: bytes):
        k = self._dbt(key)
        v = self._dbt(val)
        rc = self._fns["put"](self._h, ctypes.byref(k), ctypes.byref(v), 0)
        if rc != 0:
            raise OSError(f"db put failed rc={rc}")

    def items(self):
        k, v = _DBT(), _DBT()
        flag = _R_FIRST
        while True:
            rc = self._fns["seq"](self._h, ctypes.byref(k), ctypes.byref(v),
                                  flag)
            if rc != 0:
                return
            yield (ctypes.string_at(k.data, k.size),
                   ctypes.string_at(v.data, v.size))
            flag = _R_NEXT

    def close(self):
        if self._h:
            self._fns["sync"](self._h, 0)
            self._fns["close"](self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_bdb_path(spec: str) -> tuple[str, str]:
    """``bdb:dir#name`` / ``bdb:name`` -> (EMAN2DB dir, db file path)."""
    assert spec.startswith("bdb:")
    body = spec[4:]
    if "#" in body:
        d, name = body.rsplit("#", 1)
    else:
        d, name = ".", body
        if "/" in body:
            d, name = body.rsplit("/", 1)
    dbdir = os.path.join(d, "EMAN2DB")
    return dbdir, os.path.join(dbdir, name + ".bdb")


def _pk(obj) -> bytes:
    return pickle.dumps(obj, 2)


def _loads(raw: bytes):
    """Unpickle a key/value written by any EMAN2 generation.

    py2-era EMAN2 pickles str keys as SHORT_BINSTRING (no protocol-2
    BINUNICODE), py3 EMAN2 uses ``dumps(key, -1)`` (protocol 4/5) — none
    of which byte-match this module's own protocol-2 py3 pickles, so keys
    can never be looked up by re-pickling; they must be DECODED.
    ``encoding='latin1'`` maps py2 ``str`` to ``str`` losslessly.
    """
    return pickle.loads(raw, encoding="latin1")


def _scan(db: Db185) -> dict:
    """One btree cursor pass -> {decoded key: (raw key bytes, raw value)}.

    Single source of truth for key matching: EMAN2 containers from
    different generations encode the same logical key with different
    pickle opcodes (see ``_loads``), so byte-exact ``db.get`` on a
    re-pickled key misses on genuine containers; scanning and decoding
    every key is protocol-agnostic (and a full read touches every record
    anyway).  Undecodable keys are skipped.
    """
    out = {}
    for kb, vb in db.items():
        try:
            k = _loads(kb)
        except Exception:  # noqa: BLE001 - foreign/corrupt key: skip
            continue
        out[k] = (kb, vb)
    return out


def read_bdb_stack(spec: str):
    """Read a ``bdb:`` particle stack -> (images (N, ny, nx) f32, headers).

    Follows the EMAN2db layout described in the module docstring; raises
    a descriptive error on headers that do not carry ``data_path`` (e.g.
    header-only dictionaries).
    """
    dbdir, dbfile = parse_bdb_path(spec)
    if not os.path.exists(dbfile):
        raise FileNotFoundError(f"{spec}: no such database ({dbfile})")
    with Db185(dbfile) as db:
        recs = _scan(db)
        if "maxrec" not in recs:
            raise ValueError(f"{spec}: no 'maxrec' key — not an EMAN2 "
                             "image database?")
        maxrec = _loads(recs["maxrec"][1])
        headers = []
        images = []
        data_files = {}
        for i in range(int(maxrec) + 1):
            if i not in recs:
                continue
            hdr = _loads(recs[i][1])
            nx, ny = int(hdr["nx"]), int(hdr["ny"])
            nz = int(hdr.get("nz", 1))
            if nz != 1:
                raise ValueError(f"{spec}[{i}]: 3-D images unsupported")
            dpath = hdr.get("data_path")
            if dpath is None:
                raise ValueError(
                    f"{spec}[{i}]: header has no data_path (keys: "
                    f"{sorted(hdr)[:8]}...); only EMAN2db flat-file image "
                    "records are supported")
            if not os.path.isabs(dpath):
                dpath = os.path.normpath(os.path.join(dbdir, dpath))
            mm = data_files.get(dpath)
            if mm is None:
                mm = np.memmap(dpath, dtype="<f4", mode="r")
                data_files[dpath] = mm
            n_idx = int(hdr.get("data_n", i))
            px = nx * ny
            img = np.asarray(mm[n_idx * px:(n_idx + 1) * px],
                             np.float32).reshape(ny, nx)
            images.append(img)
            headers.append(hdr)
    if not images:
        raise ValueError(f"{spec}: empty database")
    return np.stack(images), headers


def write_bdb_stack(spec: str, images: np.ndarray, headers=None):
    """Write a stack in the EMAN2db layout (fixtures / bdb_to_hdf round
    trips; NOT a full EMAN2 writer — no attribute caches or env files)."""
    dbdir, dbfile = parse_bdb_path(spec)
    os.makedirs(dbdir, exist_ok=True)
    n, ny, nx = images.shape
    name = os.path.splitext(os.path.basename(dbfile))[0]
    side = f"{name}_{nx}x{ny}x1"
    with open(os.path.join(dbdir, side), "wb") as f:
        f.write(np.ascontiguousarray(images, "<f4").tobytes())
    with Db185(dbfile, create=True) as db:
        for i in range(n):
            hdr = dict(headers[i]) if headers else {}
            hdr.update(nx=nx, ny=ny, nz=1, data_path=side, data_n=i)
            db.put(_pk(i), _pk(hdr))
        db.put(_pk("maxrec"), _pk(n - 1))


def update_bdb_headers(spec: str, updates: list[dict]):
    """Merge per-image attribute dicts into an existing bdb stack — the
    header write-back of the bdb CLI (``write_attr``,
    test_mref_cheng_yu_bdb_cuda.py:155-210).

    Re-uses each record's ORIGINAL raw key bytes so write-back into a
    container written by a different EMAN2 generation updates the
    existing record instead of inserting a duplicate under a
    differently-pickled key.
    """
    _dbdir, dbfile = parse_bdb_path(spec)
    with Db185(dbfile, create=True) as db:
        recs = _scan(db)
        for i, upd in enumerate(updates):
            if i not in recs:
                raise KeyError(f"{spec}: image {i} missing")
            kb, vb = recs[i]
            hdr = _loads(vb)
            hdr.update(upd)
            db.put(kb, _pk(hdr))
