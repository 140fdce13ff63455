"""RELION STAR / cryoSPARC .cs / params-table readers and writers (a
copy of ``cryo_ralib_tpu/io/star.py``, numpy only): ``Starfile``,
``parse_ctf_star`` (the ``--ctf_file`` reader's source of per-particle
CTF rows), ``csparc_get_particles``, the whitespace params table and
``write_text_row`` (the ``final2Dparams.txt`` format).
pandas-free: plain dict-of-column tables.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .mrc import LazyImage, parse_header

PARAMS_HEADERS = ["idx", "angle_psi", "shift_x", "shift_y", "mirror", "class"]


@dataclass
class Table:
    """Minimal column table (stand-in for the pandas DataFrame the
    reference uses)."""

    headers: list[str]
    columns: dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self):
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, key):
        return self.columns[key]

    def __contains__(self, key):
        return key in self.columns

    def row(self, i):
        return {h: self.columns[h][i] for h in self.headers}


def read_params_table(path: str) -> Table:
    """Whitespace params table ``idx angle_psi shift_x shift_y mirror class``
    (src/utils_ralib.py:30-34)."""
    data = np.loadtxt(path, ndmin=2)
    cols = {h: data[:, i] for i, h in enumerate(PARAMS_HEADERS[: data.shape[1]])}
    return Table(PARAMS_HEADERS[: data.shape[1]], cols)


def write_text_row(rows, path: str):
    """SPHIRE ``write_text_row`` equivalent: one whitespace row per entry
    (``initial2Dparams.txt``, test_reffree_gpu_align.py:569)."""
    with open(path, "w") as f:
        for row in rows:
            f.write("  ".join("%15.5f" % float(v) if isinstance(v, (float, np.floating))
                              else "%15g" % float(v) for v in row))
            f.write("\n")


class Starfile:
    """RELION STAR parser/writer (cryodrgn lineage like the reference's,
    src/utils_ralib.py:56-140)."""

    def __init__(self, headers, table: Table):
        self.headers = headers
        self.df = table

    @classmethod
    def load(cls, path: str, relion31: bool = False) -> "Starfile":
        block = "data_particles" if relion31 else "data_"
        headers: list[str] = []
        body: list[list[str]] = []
        state = "seek_block"
        with open(path) as f:
            for line in f:
                stripped = line.strip()
                if state == "seek_block":
                    if stripped.startswith(block):
                        state = "seek_loop"
                elif state == "seek_loop":
                    if stripped.startswith("loop_"):
                        state = "headers"
                elif state == "headers":
                    if stripped.startswith("_"):
                        headers.append(stripped.split()[0])
                    elif stripped:
                        body.append(stripped.split())
                        state = "body"
                elif state == "body":
                    if not stripped:
                        break
                    body.append(stripped.split())
        if not headers:
            raise ValueError(f"no {block} loop found in {path}")
        arr = np.array(body, dtype=object)
        cols = {h: arr[:, i] for i, h in enumerate(headers)}
        return cls(headers, Table(headers, cols))

    def write(self, path: str):
        from datetime import datetime

        with open(path, "w") as f:
            f.write("# Created {}\n\n".format(datetime.now()))
            f.write("data_\n\nloop_\n")
            f.write("\n".join(self.headers))
            f.write("\n")
            n = len(self.df)
            for i in range(n):
                f.write(" ".join(str(self.df[h][i]) for h in self.headers))
                f.write("\n")

    def get_particles(self, datadir: str | None = None, lazy: bool = True):
        """Particles referenced as ``index@path.mrcs``
        (src/utils_ralib.py:116-140)."""
        entries = [str(x).split("@") for x in self.df["_rlnImageName"]]
        ind = [int(e[0]) - 1 for e in entries]
        mrcs = [e[1] for e in entries]
        if datadir is not None:
            mrcs = prefix_paths(mrcs, datadir)
        d = parse_header(mrcs[0]).D
        stride = 4 * d * d
        dataset = [LazyImage(f, (d, d), np.float32, 1024 + ii * stride)
                   for ii, f in zip(ind, mrcs)]
        if not lazy:
            dataset = np.array([x.get() for x in dataset])
        return dataset


def prefix_paths(mrcs, datadir):
    """Rebase .mrcs paths onto ``datadir`` (basename first, then full
    relative path — src/utils_ralib.py:142-153)."""
    by_base = [os.path.join(datadir, os.path.basename(x)) for x in mrcs]
    if all(os.path.exists(p) for p in set(by_base)):
        return by_base
    return [os.path.join(datadir, x) for x in mrcs]


def csparc_get_particles(csfile: str, datadir: str | None = None,
                         lazy: bool = True):
    """cryoSPARC .cs particle loader (src/utils_ralib.py:155-169)."""
    metadata = np.load(csfile)
    ind = metadata["blob/idx"]
    mrcs = metadata["blob/path"].astype(str).tolist()
    if datadir is not None:
        mrcs = prefix_paths(mrcs, datadir)
    d = int(metadata[0]["blob/shape"][0])
    stride = 4 * d * d
    dataset = [LazyImage(f, (d, d), np.float32, 1024 + ii * stride)
               for ii, f in zip(ind, mrcs)]
    if not lazy:
        dataset = np.array([x.get() for x in dataset])
    return dataset


def parse_ctf_star(table: Table, d: int, angpix: float | None = None) -> np.ndarray:
    """(N, 9) CTF param rows from STAR columns (src/utils_ralib.py:190-207)."""
    n = len(table)
    if angpix is None:
        if ("_rlnDetectorPixelSize" in table and "_rlnMagnification" in table):
            angpix = (float(table["_rlnDetectorPixelSize"][0]) * 10000
                      / float(table["_rlnMagnification"][0]))
        else:
            angpix = 1.0
    out = np.zeros((n, 9))
    out[:, 0] = d
    out[:, 1] = angpix
    for i, h in enumerate(["_rlnDefocusU", "_rlnDefocusV", "_rlnDefocusAngle",
                           "_rlnVoltage", "_rlnSphericalAberration",
                           "_rlnAmplitudeContrast", "_rlnPhaseShift"]):
        if h in table:
            out[:, i + 2] = table[h].astype(np.float64)
    return out
