"""EMAN2-layout HDF5 image writers (counterpart of the writers in
``cryo_ralib_tpu/io/eman_hdf.py``).

Image ``i`` of a stack lives at ``/MDF/images/<i>/image`` with header
attributes ``EMAN.<name>`` on its group and the stack size in the
``imageid_max`` attribute of ``/MDF/images``.  ``h5py`` is imported when
a file is written, not when this module is imported.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError("h5py is required for EMAN2-HDF output") from err
    return h5py


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


def _write_group(grp, idx: int, image: np.ndarray, header: dict):
    g = grp.require_group(str(idx))
    if "image" in g:
        del g["image"]
    g.create_dataset("image", data=image)
    hdr = dict(header)
    hdr.setdefault("nx", image.shape[1])
    hdr.setdefault("ny", image.shape[0])
    hdr.setdefault("nz", 1)
    for k, v in hdr.items():
        g.attrs["EMAN." + k] = _encode_attr(v)


def write_hdf_stack(path: str, images, headers=None, append: bool = False):
    """Write, or append after ``imageid_max``, an (N, H, W) or (H, W)
    stack with optional per-image header dicts."""
    h5py = _h5py()
    images = np.asarray(images, np.float32)
    if images.ndim == 2:
        images = images[None]
    n = images.shape[0]
    headers = headers if headers is not None else [{} for _ in range(n)]
    mode = "a" if (append and os.path.exists(path)) else "w"
    with h5py.File(path, mode) as f:
        grp = f.require_group("MDF").require_group("images")
        start = int(grp.attrs.get("imageid_max", -1)) + 1 if mode == "a" else 0
        for i in range(n):
            _write_group(grp, start + i, images[i], headers[i])
        grp.attrs["imageid_max"] = np.int32(start + n - 1)


def write_image(path: str, image, index: int | None = None, header=None):
    """EMAN2 ``EMData.write_image``: write one image at a slot, creating or
    extending the stack file."""
    h5py = _h5py()
    image = np.asarray(image, np.float32)
    exists = os.path.exists(path)
    with h5py.File(path, "a" if exists else "w") as f:
        grp = f.require_group("MDF").require_group("images")
        cur = int(grp.attrs.get("imageid_max", -1))
        idx = cur + 1 if index is None else int(index)
        _write_group(grp, idx, image, header or {})
        grp.attrs["imageid_max"] = np.int32(max(cur, idx))
