"""Timestamped run logging (counterpart of ``cryo_ralib_tpu/utils/log.py``):
messages go to stdout and, with an output directory, to ``logfile.txt``."""

from __future__ import annotations

import os
import sys
import time


class RunLogger:
    def __init__(self, outdir: str | None = None, quiet: bool = False):
        self.path = os.path.join(outdir, "logfile.txt") if outdir else None
        self.quiet = quiet
        if self.path:
            os.makedirs(outdir, exist_ok=True)

    def add(self, msg: str):
        line = time.strftime("%Y-%m-%d %H:%M:%S :: ") + str(msg)
        if not self.quiet:
            print(line)
            sys.stdout.flush()
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
