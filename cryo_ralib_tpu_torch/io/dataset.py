"""Aligned-dataset bundle: particle stack + 2D alignment params table.

Counterpart of ``cryo_ralib_tpu/io/dataset.py`` (the reference's
``HDFfile``, src/utils_ralib.py:22-54): pairs an EMAN2-HDF (or MRC)
particle stack with the whitespace params table ``idx angle_psi shift_x
shift_y mirror class`` of the EDA workflow (notebook 03).
``aligned_particles`` applies the table with the port's ``rot_shift2d``
(``aligned_stack``, which the export example shares) on the GPU unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from .eman_hdf import read_hdf_stack
from .mrc import read_mrc
from .star import PARAMS_HEADERS, Table, read_params_table, write_text_row


class HDFfile:
    """Stack path + params Table (pandas-free)."""

    def __init__(self, headers, df: Table, images: str):
        self.headers = headers
        self.df = df
        self.images = images

    @classmethod
    def load(cls, hdffile: str, params_file: str) -> "HDFfile":
        return cls(PARAMS_HEADERS, read_params_table(params_file), hdffile)

    def get_particles(self, lazy: bool = False) -> np.ndarray:
        """Read the full stack as (N, H, W) float32 (``lazy`` kept for the
        reference's signature; it changes nothing)."""
        del lazy
        if self.images.lower().endswith((".mrc", ".mrcs")):
            return read_mrc(self.images)
        imgs, _headers = read_hdf_stack(self.images)
        return np.asarray(imgs, np.float32)

    def aligned_particles(self, device="cuda") -> np.ndarray:
        """Apply the params table to the stack (notebook 03's step before
        MPCA/TwoSDR) with ``aligned_stack`` on ``device``."""
        df = self.df
        return aligned_stack(self.get_particles(), df["angle_psi"],
                             df["shift_x"], df["shift_y"], df["mirror"],
                             device=device)

    def write(self, out_path: str):
        """Write the params table back out."""
        cols = [np.asarray(self.df[h]) for h in self.headers if h in self.df]
        write_text_row(np.stack(cols, axis=1), out_path)


def aligned_stack(images, alpha, sx, sy, mirror, device="cuda") -> np.ndarray:
    """Apply header-convention params (N,) to a host stack (N, H, W):
    ``rot_shift2d`` on ``device`` by blocks of ``transform_block``
    particles, each uploaded, transformed and read back in turn, so the
    card holds one block; returns float32 numpy.  A CUDA device without
    CUDA raises."""
    import torch

    from ..models.engine import resolve_device
    from ..ops.transform import rot_shift2d, transform_block

    dev = resolve_device(device)
    images = np.asarray(images, np.float32)
    cols = [np.asarray(v, np.float32) for v in (alpha, sx, sy)]
    mirror = np.asarray(mirror, np.int32)
    out = np.empty_like(images)
    block = transform_block(*images.shape[1:])
    for start in range(0, images.shape[0], block):
        sl = slice(start, start + block)
        out[sl] = rot_shift2d(
            torch.as_tensor(images[sl], device=dev),
            *[torch.as_tensor(c[sl], device=dev) for c in cols],
            mirror=torch.as_tensor(mirror[sl], device=dev)).cpu().numpy()
    return out
