"""Timestamped run logging (counterpart of ``cryo_ralib_tpu/utils/log.py``,
the SPHIRE ``Logger`` + ``print_msg`` machinery of the reference drivers):
messages go to stdout and, with an output directory, to ``<name>.txt``
inside it (``logfile.txt`` by default)."""

from __future__ import annotations

import os
import sys
import time


class RunLogger:
    def __init__(self, outdir: str | None = None, name: str = "logfile",
                 quiet: bool = False):
        self.path = os.path.join(outdir, name + ".txt") if outdir else None
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

    # SPHIRE-style aliases
    def print_msg(self, msg: str):
        self.add(msg.rstrip("\n"))

    def print_begin_msg(self, name: str):
        self.add("=== BEGIN %s ===" % name)

    def print_end_msg(self, name: str):
        self.add("=== END %s ===" % name)
