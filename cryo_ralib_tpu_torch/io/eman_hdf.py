"""EMAN2-layout HDF5 particle stacks (counterpart of
``cryo_ralib_tpu/io/eman_hdf.py``).

Image ``i`` of a stack lives at ``/MDF/images/<i>/image`` with header
attributes ``EMAN.<name>`` on its group and the stack size in the
``imageid_max`` attribute of ``/MDF/images``.

Writing needs no ``h5py``: ``write_hdf_stack``, ``write_image`` and
``update_headers`` write the whole file with the small HDF5 writer
below, on numpy and ``struct``.  Its format is superblock version 2 with
version-2 object headers and compact link storage (the "new-style"
groups of HDF5 1.8): every group is one object header that holds its
links, so there is no B-tree, local heap or symbol-table node to write
(superblock 0 needs all three), at the price of the Jenkins lookup3
checksum that ends the superblock and every header.  HDF5 1.8 and later
read it.  Each image is one contiguous little-endian float32 dataset;
attributes are encoded by ``_encode_attr``, the JAX writer's rules,
except that a string is stored fixed-length (UTF-8, null-padded) where
h5py stores it variable-length: either reads back as the same text
through ``read_hdf_stack``.  An attribute that h5py could not hold in
one object-header message (64 KiB: the ``members`` of a class of more
than 16364 particles) raises ``ValueError`` before anything is written;
``header_fits`` tells beforehand.

A write into an existing file (``append=True``, ``write_image`` at a
slot, ``update_headers``) reads the stack and rewrites the file whole.
A file of this writer's layout is read by ``read_own_hdf``, a reader of
that layout; any other file (one written by h5py, such as the JAX
package's ``aqc.hdf`` on a resume) is read with ``h5py``, and without
it the call raises ``ImportError`` naming h5py.  ``read_hdf_stack``,
``get_image_count`` and ``update_headers`` take either kind the same way.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_MESSAGE_MAX = 65536     # an object-header message's size is 16 bits
_M32 = 0xFFFFFFFF

# object-header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL = 0x00, 0x01, 0x02, 0x03, 0x05
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x06, 0x08, 0x0A, 0x0B, 0x0C
_MTIME, _ATTR_INFO, _REFCOUNT = 0x12, 0x15, 0x16


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError("h5py is required to read or update an HDF5 file "
                          "that this package did not write") from err
    return h5py


class _Foreign(Exception):
    """The file is not of this writer's layout."""


# ---- the Jenkins lookup3 checksum (hashlittle, initval 0) of HDF5

def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes) -> int:
    """Bob Jenkins' ``hashlittle(data, len(data), 0)``, the checksum of
    HDF5's superblock and version-2 object headers."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & _M32
    if n == 0:
        return c
    pad = (-n) % 12
    words = np.frombuffer(bytes(data) + b"\0" * pad, "<u4").tolist()
    last = len(words) - 3
    for i in range(0, len(words), 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        if i == last:
            break
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c


# ---- attribute values

def _encode_attr(v: Any):
    if isinstance(v, bool):
        return np.int32(v)
    if isinstance(v, (int, np.integer)):
        return np.int32(v)
    if isinstance(v, (float, np.floating)):
        return np.float32(v)
    if isinstance(v, str):
        return v
    if isinstance(v, (list, tuple, np.ndarray)):
        arr = np.asarray(v)
        if arr.dtype.kind in "if":
            return arr.astype(np.float32)
        return json.dumps(list(v))
    if isinstance(v, dict):
        return json.dumps(v)
    return str(v)


def _public(v):
    """A stored attribute value as ``read_hdf_stack`` returns it."""
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _stored(v):
    """A value read from a file as this writer stores it."""
    return _encode_attr(v.decode("utf-8", "replace")
                        if isinstance(v, bytes) else v)


# ---- encoders of the messages

_INT32_TYPE = bytes([0x10, 0x08, 0, 0]) + struct.pack("<IHH", 4, 0, 32)
_F32_TYPE = (bytes([0x11, 0x20, 0x1F, 0x00]) + struct.pack("<I", 4)
             + struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127))


def _string_type(size: int) -> bytes:
    # class 3, version 1; null-padded, UTF-8
    return bytes([0x13, 0x11, 0, 0]) + struct.pack("<I", size)


def _dataspace(shape) -> bytes:
    """Dataspace message, version 2: scalar for (), else simple."""
    return (bytes([2, len(shape), 0, 1 if shape else 0])
            + b"".join(struct.pack("<Q", d) for d in shape))


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _attr_message(name: str, value) -> bytes:
    """Attribute message, version 3, of an encoded value."""
    if isinstance(value, str):
        data = value.encode("utf-8") or b"\0"
        dtype, shape = _string_type(len(data)), ()
    else:
        arr = np.asarray(value)
        types = {np.dtype(np.int32): _INT32_TYPE,
                 np.dtype(np.float32): _F32_TYPE}
        if arr.dtype not in types:
            raise TypeError(f"attribute {name!r}: no encoding for "
                            f"{arr.dtype}")
        dtype = types[arr.dtype]
        data = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        shape = arr.shape
    name_b = name.encode("utf-8") + b"\0"
    space = _dataspace(shape)
    # h5py writes a version-1 message: 8-byte header, name, datatype and
    # dataspace (with its maximum dims) each padded to 8 bytes, the whole
    # padded to 8.  At 64 KiB h5py refuses it, and just below (65532
    # bytes) it writes a file that it cannot read back; the port refuses
    # both here, before anything is written
    v1_size = _pad8(8 + _pad8(len(name_b)) + _pad8(len(dtype))
                    + (8 + 16 * len(shape)) + len(data))
    if v1_size >= _MESSAGE_MAX:
        raise ValueError(
            f"attribute {name!r} needs a {v1_size}-byte object-header "
            f"message; HDF5 reads at most {_MESSAGE_MAX - 8} bytes in one "
            "(h5py raises 'object header message is too large' here, or "
            "writes a file it cannot read)")
    return (bytes([3, 0]) + struct.pack("<HHH", len(name_b), len(dtype),
                                        len(space))
            + b"\0" + name_b + dtype + space + data)


def header_fits(key: str, value) -> bool:
    """Whether header attribute ``key`` holding ``value`` fits the one
    object-header message that HDF5 gives an attribute (``members`` of
    up to 16364 particles)."""
    try:
        _attr_message("EMAN." + key, _encode_attr(value))
    except ValueError:
        return False
    return True


def _link_message(name: str, addr: int) -> bytes:
    name_b = name.encode("utf-8")
    return bytes([1, 0, len(name_b)]) + name_b + struct.pack("<Q", addr)


def _object_header(messages) -> bytes:
    """Version-2 object header: ``messages`` is a list of (type, flags,
    body); one chunk, its size in 4 bytes, then the checksum."""
    body = b"".join(struct.pack("<BHB", t, len(m), fl) + m
                    for t, fl, m in messages)
    blob = b"OHDR" + bytes([2, 2]) + struct.pack("<I", len(body)) + body
    return blob + struct.pack("<I", lookup3(blob))


def _group_header(links, attrs=()) -> bytes:
    msgs = [(_LINK_INFO, 0, bytes([0, 0]) + struct.pack("<QQ", _UNDEF,
                                                        _UNDEF)),
            (_GROUP_INFO, 0, bytes([0, 0]))]
    msgs += [(_LINK, 0, _link_message(n, a)) for n, a in links]
    msgs += [(_ATTRIBUTE, 0, m) for m in attrs]
    return _object_header(msgs)


def _dataset_header(shape, addr: int) -> bytes:
    nbytes = 4 * int(np.prod(shape))
    return _object_header([
        (_DATASPACE, 0, _dataspace(shape)),
        (_DATATYPE, 1, _F32_TYPE),
        # fill value v3: allocated late, written only if set, none set
        (_FILL, 1, bytes([3, 0x0A])),
        # layout v3, contiguous
        (_LAYOUT, 0, bytes([3, 1]) + struct.pack("<QQ", addr, nbytes)),
    ])


# ---- the stack model: {slot: (image, {attribute name: stored value})}

def _write_stack(path: str, slots: dict, imageid_max: int):
    """Write the whole file (to a temporary beside it, then renamed)."""
    encoded = {i: (np.ascontiguousarray(img, "<f4"),
                   [_attr_message(k, v) for k, v in attrs.items()])
               for i, (img, attrs) in slots.items()}
    count_attr = _attr_message("imageid_max", np.int32(imageid_max))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"\0" * 48)           # the superblock, written last
        pos = 48

        def put(blob: bytes) -> int:
            nonlocal pos
            addr = pos
            f.write(blob)
            pos += len(blob)
            return addr

        links = []
        for i in sorted(encoded, key=str):
            img, attrs = encoded[i]
            data = put(img.tobytes())
            dset = put(_dataset_header(img.shape, data))
            links.append((str(i), put(_group_header([("image", dset)],
                                                    attrs))))
        images = put(_group_header(links, [count_attr]))
        mdf = put(_group_header([("images", images)]))
        root = put(_group_header([("MDF", mdf)]))
        sb = (_SIGNATURE + bytes([2, 8, 8, 0])
              + struct.pack("<QQQQ", 0, _UNDEF, pos, root))
        f.seek(0)
        f.write(sb + struct.pack("<I", lookup3(sb)))
    os.replace(tmp, path)


# ---- the reader of this layout

def _parse_header(buf: bytes, addr: int) -> list:
    """(type, body) of each message of a version-2 object header."""
    if buf[addr:addr + 4] != b"OHDR" or buf[addr + 4] != 2:
        raise _Foreign("not a version-2 object header")
    flags = buf[addr + 5]
    p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    size = int.from_bytes(buf[p:p + width], "little")
    p += width
    end = p + size
    if lookup3(buf[addr:end]) != struct.unpack_from("<I", buf, end)[0]:
        raise _Foreign("object header checksum mismatch")
    out = []
    while end - p >= 4:
        mtype, msize, mflags = struct.unpack_from("<BHB", buf, p)
        p += 4 + (2 if flags & 0x04 else 0)
        if mflags & 0x02:
            raise _Foreign("shared message")
        out.append((mtype, buf[p:p + msize]))
        p += msize
    return out


def _parse_datatype(m: bytes):
    """numpy dtype, or ("S", size) for a fixed-length string."""
    cls = m[0] & 0x0F
    size = struct.unpack_from("<I", m, 4)[0]
    order = ">" if m[1] & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if m[1] & 0x08 else 'u'}{size}")
    if cls == 1 and size in (4, 8):
        return np.dtype(f"{order}f{size}")
    if cls == 3:
        return ("S", size)
    raise _Foreign(f"datatype class {cls}")


def _parse_dataspace(m: bytes) -> tuple:
    version, rank, flags = m[0], m[1], m[2]
    if version == 1:
        start = 8
    elif version == 2:
        if m[3] == 2:
            raise _Foreign("null dataspace")
        start = 4
    else:
        raise _Foreign(f"dataspace version {version}")
    return struct.unpack_from(f"<{rank}Q", m, start) if rank else ()


def _parse_attribute(m: bytes):
    version = m[0]
    if version not in (1, 2, 3) or m[1]:
        raise _Foreign(f"attribute message version {version}")
    nsize, tsize, ssize = struct.unpack_from("<HHH", m, 2)
    p = 8 + (1 if version == 3 else 0)
    pad = _pad8 if version == 1 else (lambda n: n)
    name = m[p:p + nsize].split(b"\0")[0].decode("utf-8")
    p += pad(nsize)
    dtype = _parse_datatype(m[p:p + tsize])
    p += pad(tsize)
    shape = _parse_dataspace(m[p:p + ssize])
    p += pad(ssize)
    if isinstance(dtype, tuple):
        if shape:
            raise _Foreign("string array attribute")
        return name, m[p:p + dtype[1]].rstrip(b"\0").decode("utf-8")
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(m, dtype, count, p).astype(dtype.newbyteorder("="))
    return name, (arr.reshape(shape) if shape else arr[0])


def _parse_object(buf: bytes, addr: int) -> dict:
    """{"links": {name: addr}, "attrs": {name: value}, "shape", "data"}"""
    obj = {"links": {}, "attrs": {}}
    for mtype, m in _parse_header(buf, addr):
        if mtype == _LINK:
            flags = m[1]
            p = 2
            if flags & 0x08:
                if m[p] != 0:
                    raise _Foreign("soft or external link")
                p += 1
            p += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            nlen = int.from_bytes(m[p:p + width], "little")
            p += width
            name = m[p:p + nlen].decode("utf-8")
            obj["links"][name] = struct.unpack_from("<Q", m, p + nlen)[0]
        elif mtype == _ATTRIBUTE:
            name, value = _parse_attribute(m)
            obj["attrs"][name] = value
        elif mtype == _DATASPACE:
            obj["shape"] = _parse_dataspace(m)
        elif mtype == _DATATYPE:
            obj["dtype"] = _parse_datatype(m)
        elif mtype == _LAYOUT:
            if m[0] != 3 or m[1] != 1:
                raise _Foreign("not a contiguous layout")
            obj["data"] = struct.unpack_from("<QQ", m, 2)
        elif mtype == _LINK_INFO:
            if struct.unpack_from("<Q", m, 2 + (8 if m[1] & 1 else 0))[0] \
                    != _UNDEF:
                raise _Foreign("dense link storage")
        elif mtype == _ATTR_INFO:
            off = 2 + (2 if m[1] & 1 else 0)
            if struct.unpack_from("<Q", m, off)[0] != _UNDEF:
                raise _Foreign("dense attribute storage")
        elif mtype not in (_NIL, _FILL, _GROUP_INFO, _MTIME, _REFCOUNT):
            raise _Foreign(f"object header message type {mtype:#x}")
    return obj


def _read_stack(path: str):
    """(slots, imageid_max) of a file of this writer's layout; raises
    ``_Foreign`` for any other file."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE or len(buf) < 48 or buf[8] != 2:
        raise _Foreign("not a version-2 superblock")
    if lookup3(buf[:44]) != struct.unpack_from("<I", buf, 44)[0]:
        raise _Foreign("superblock checksum mismatch")
    root = _parse_object(buf, struct.unpack_from("<Q", buf, 36)[0])
    try:
        mdf = _parse_object(buf, root["links"]["MDF"])
        grp = _parse_object(buf, mdf["links"]["images"])
    except KeyError as err:
        raise _Foreign("no /MDF/images group") from err
    slots = {}
    for name, addr in grp["links"].items():
        if not name.isdigit():
            raise _Foreign(f"image group name {name!r}")
        g = _parse_object(buf, addr)
        d = _parse_object(buf, g["links"]["image"])
        if d.get("dtype") != np.dtype("<f4") or "data" not in d:
            raise _Foreign("image is not a contiguous float32 dataset")
        start, nbytes = d["data"]
        shape = d["shape"]
        if nbytes != 4 * int(np.prod(shape)):
            raise _Foreign("image size mismatch")
        img = np.frombuffer(buf, "<f4", int(np.prod(shape)), start)
        slots[int(name)] = (img.reshape(shape).astype(np.float32),
                            {k: _stored(v) for k, v in g["attrs"].items()})
    default = max(slots, default=-1)
    return slots, int(grp["attrs"].get("imageid_max", default))


def _read_foreign(path: str):
    """(slots, imageid_max) of any EMAN2-layout file, through h5py."""
    h5py = _h5py()
    slots = {}
    with h5py.File(path, "r") as f:
        grp = f["MDF"]["images"]
        for name in filter(str.isdigit, grp):
            g = grp[name]
            slots[int(name)] = (np.asarray(g["image"], np.float32),
                                {k: _stored(v) for k, v in g.attrs.items()})
        default = max(slots, default=-1)
        return slots, int(grp.attrs.get("imageid_max", default))


def _load(path: str):
    try:
        return _read_stack(path)
    except _Foreign:
        return _read_foreign(path)


def _headers_of(slots, indices):
    images, headers = [], []
    for i in indices:
        img, attrs = slots[int(i)]
        images.append(img)
        headers.append({(k[5:] if k.startswith("EMAN.") else k): _public(v)
                        for k, v in attrs.items()})
    return np.stack(images), headers


def read_own_hdf(path: str, indices=None):
    """Read a stack that this package wrote, with no h5py; raises
    ``ValueError`` for any other file.  Returns (images (N, H, W)
    float32, headers) as ``read_hdf_stack`` does."""
    try:
        slots, imageid_max = _read_stack(path)
    except _Foreign as err:
        raise ValueError(f"{path} was not written by this package's HDF5 "
                         f"writer ({err})") from err
    return _headers_of(slots, range(imageid_max + 1) if indices is None
                       else indices)


def read_hdf_stack(path: str, indices=None):
    """Read an EMAN2 HDF stack: (images (N, H, W) float32, headers as
    dicts with the ``EMAN.`` prefix stripped)."""
    slots, imageid_max = _load(path)
    return _headers_of(slots, range(imageid_max + 1) if indices is None
                       else indices)


def get_image_count(path: str) -> int:
    """EMAN2 ``EMUtil.get_image_count`` equivalent."""
    return _load(path)[1] + 1


def _with_defaults(image, header) -> dict:
    hdr = dict(header or {})
    hdr.setdefault("nx", image.shape[1])
    hdr.setdefault("ny", image.shape[0])
    hdr.setdefault("nz", 1)
    return {"EMAN." + k: _encode_attr(v) for k, v in hdr.items()}


def write_hdf_stack(path: str, images, headers=None, append: bool = False):
    """Write, or append after ``imageid_max``, an (N, H, W) or (H, W)
    stack with optional per-image header dicts."""
    images = np.asarray(images, np.float32)
    if images.ndim == 2:
        images = images[None]
    n = images.shape[0]
    headers = headers if headers is not None else [{} for _ in range(n)]
    slots, start = ({}, 0)
    if append and os.path.exists(path):
        slots, last = _load(path)
        start = last + 1
    for i in range(n):
        slot = slots.get(start + i, (None, {}))[1]
        slots[start + i] = (images[i], {**slot, **_with_defaults(images[i],
                                                                 headers[i])})
    _write_stack(path, slots, start + n - 1)


def write_image(path: str, image, index: int | None = None, header=None):
    """EMAN2 ``EMData.write_image``: write one image at a slot, creating or
    extending the stack file; a slot written over keeps the header
    attributes that the new header does not set."""
    image = np.asarray(image, np.float32)
    slots, cur = _load(path) if os.path.exists(path) else ({}, -1)
    idx = cur + 1 if index is None else int(index)
    old = slots.get(idx, (None, {}))[1]
    slots[idx] = (image, {**old, **_with_defaults(image, header)})
    _write_stack(path, slots, max(cur, idx))


def update_headers(path: str, updates: list[dict], indices=None):
    """Write-back of header attributes (``EMAN.<key>``) into an existing
    stack, image ``indices[j]`` getting ``updates[j]``."""
    if indices is None:
        indices = range(len(updates))
    try:
        slots, imageid_max = _read_stack(path)
    except _Foreign:
        h5py = _h5py()
        with h5py.File(path, "a") as f:
            grp = f["MDF"]["images"]
            for upd, i in zip(updates, indices):
                g = grp[str(int(i))]
                for k, v in upd.items():
                    g.attrs["EMAN." + k] = _encode_attr(v)
        return
    for upd, i in zip(updates, indices):
        img, attrs = slots[int(i)]
        attrs.update({"EMAN." + k: _encode_attr(v) for k, v in upd.items()})
    _write_stack(path, slots, imageid_max)
