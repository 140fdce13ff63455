"""Tracing and timing helpers (PyTorch).

Counterpart of ``cryo_ralib_tpu/utils/profiling.py``: ``annotate(name)``
names a phase on the device timeline (an NVTX range, as the reference's
drivers push one around every phase; nothing on the CPU), ``force`` is
a completion barrier (a device synchronise), ``DeviceTimer`` times
phases on the host clock between such barriers, and ``trace(logdir)``
records a ``torch.profiler`` trace that TensorBoard or Perfetto reads.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def annotate(name: str):
    """An NVTX range named ``name`` where CUDA is available; nothing
    else."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def force(*_tensors) -> None:
    """Completion barrier: wait for every queued device operation (the
    arguments are accepted for the JAX helper's signature)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (the CPU, and the
    card where CUDA is available) into ``logdir`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class DeviceTimer:
    """Wall-clock phase timer with completion barriers.

    Usage::

        t = DeviceTimer()
        with t.phase("align"):
            out = step(...)
            force(out)
        print(t.report())
    """

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(f"{k}: {self.times[k] * 1e3:.1f} ms"
                         f" ({self.counts[k]} calls)" for k in self.times)
