"""MRC/MRCS stack I/O (a copy of ``cryo_ralib_tpu/io/mrc.py``, no mrcfile
dependency): the MRC2014 header, a numpy reader and writer, and the lazy
per-particle reader with the 1024-byte header offset.  ``read_mrc``
reads through the threaded native reader (``cryo_ralib_tpu_torch.native``)
where it is built, as the JAX package's does, and with numpy otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HEADER_SIZE = 1024

_MODE_DTYPES = {
    0: np.int8,
    1: np.int16,
    2: np.float32,
    6: np.uint16,
    12: np.float16,
}


@dataclass
class MRCHeader:
    nx: int
    ny: int
    nz: int
    mode: int
    apix: float = 1.0
    extended_bytes: int = 0

    @property
    def dtype(self):
        return np.dtype(_MODE_DTYPES[self.mode])

    @property
    def data_offset(self) -> int:
        return HEADER_SIZE + self.extended_bytes

    # alias matching the reference's ``mrc.parse_header(...).D`` usage
    @property
    def D(self) -> int:  # noqa: N802
        return self.nx


def parse_header(path: str) -> MRCHeader:
    with open(path, "rb") as f:
        raw = f.read(HEADER_SIZE)
    ints = np.frombuffer(raw, "<i4", count=25)
    floats = np.frombuffer(raw, "<f4", count=25)
    nx, ny, nz, mode = (int(x) for x in ints[:4])
    mx = int(ints[7]) or nx
    cella_x = float(floats[10])
    apix = cella_x / mx if mx and cella_x else 1.0
    nsymbt = int(ints[23])
    return MRCHeader(nx=nx, ny=ny, nz=nz, mode=mode, apix=apix,
                     extended_bytes=nsymbt)


def read_mrc(path: str, indices=None, native: bool | None = None) -> np.ndarray:
    """Read a full stack (or selected z-slices) as (N, H, W) float32.

    ``native=None`` uses the threaded C++ reader when it is built and the
    read is large enough to matter (64 slices); True uses it wherever it
    is available; False forces numpy.  Both give the same values.
    """
    hdr = parse_header(path)
    n_read = hdr.nz if indices is None else len(indices)
    if native is None:
        native = n_read >= 64
    if native and hdr.mode in _MODE_DTYPES:
        from .. import native as native_mod

        if native_mod.available():
            idx = np.arange(hdr.nz) if indices is None else indices
            return native_mod.read_slices(path, idx)
    item = hdr.nx * hdr.ny
    dtype = hdr.dtype
    if indices is None:
        data = np.fromfile(path, dtype=dtype, count=item * hdr.nz,
                           offset=hdr.data_offset)
        return data.reshape(hdr.nz, hdr.ny, hdr.nx).astype(np.float32)
    out = np.empty((len(indices), hdr.ny, hdr.nx), np.float32)
    stride = item * dtype.itemsize
    with open(path, "rb") as f:
        for j, i in enumerate(indices):
            f.seek(hdr.data_offset + int(i) * stride)
            out[j] = np.frombuffer(f.read(stride), dtype=dtype).reshape(
                hdr.ny, hdr.nx).astype(np.float32)
    return out


def write_mrc(path: str, data: np.ndarray, apix: float = 1.0):
    """Write (N, H, W) or (H, W) float32 data as MRC mode 2."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[None]
    nz, ny, nx = data.shape
    header = np.zeros(HEADER_SIZE // 4, "<i4")
    fheader = header.view("<f4")
    header[0:3] = (nx, ny, nz)
    header[3] = 2  # mode: float32
    header[7:10] = (nx, ny, nz)  # mx, my, mz
    fheader[10:13] = (nx * apix, ny * apix, nz * apix)  # cella
    fheader[13:16] = (90.0, 90.0, 90.0)  # cellb
    header[16:19] = (1, 2, 3)  # mapc, mapr, maps
    fheader[19] = float(data.min())
    fheader[20] = float(data.max())
    fheader[21] = float(data.mean())
    header[52] = int.from_bytes(b"MAP ", "little")  # MAP stamp
    header[53] = 0x00004144  # little-endian machine stamp
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(data.tobytes())


class LazyImage:
    """Deferred single-image read: (path, shape, dtype, byte offset) — the
    interface the reference's Starfile/.cs loaders build
    (src/utils_ralib.py:137,166)."""

    def __init__(self, fname: str, shape, dtype, offset: int):
        self.fname = fname
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.offset = int(offset)

    def get(self) -> np.ndarray:
        count = int(np.prod(self.shape))
        with open(self.fname, "rb") as f:
            f.seek(self.offset)
            buf = f.read(count * self.dtype.itemsize)
        return np.frombuffer(buf, dtype=self.dtype).reshape(self.shape).copy()
