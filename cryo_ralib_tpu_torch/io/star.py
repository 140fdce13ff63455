"""Parameter-table writer (counterpart of ``cryo_ralib_tpu/io/star.py::
write_text_row``, the SPHIRE ``write_text_row`` format)."""

from __future__ import annotations

import numpy as np


def write_text_row(rows, path: str):
    """One whitespace-separated row per entry (``final2Dparams.txt``)."""
    with open(path, "w") as f:
        for row in rows:
            f.write("  ".join("%15.5f" % float(v)
                              if isinstance(v, (float, np.floating))
                              else "%15g" % float(v) for v in row))
            f.write("\n")
