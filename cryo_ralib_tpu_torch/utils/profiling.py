"""The port's span recorder (PyTorch).

Counterpart of ``cryo_ralib_tpu/utils/profiling.py``.  The drivers, the
engine and the step name the parts of an alignment job where the work
happens:

===================  ====================================================
``job``              one call of ``mref_ali2d`` or ``ali2d_base``
``driver.prepare``   the stack's upload and normalisation (device time)
``driver.update``    an iteration's host work outside the engine
``driver.refs``      ``mref_ali2d``'s per-class reference update inside
                     ``driver.update``: reseeding, FSC, average or
                     Wiener, user function, normalisation (``classes``,
                     ``vanished``)
``driver.fourvar``   ``ali2d_base``'s Fourier variance (device time)
``driver.raw_sums``  ``ali2d_base``'s first sums of the raw stack (device)
``engine.iterate``   one ``AlignmentEngine.iterate``
``engine.step``      one step: the resident stack or one streamed batch
``step.search``      a step's search (device time; ``N``, ``K``, ``box``,
                     ``rings``, ``shifts``, ``mirrors`` and
                     ``ref_groups``, the kernel's groups of 8 references
                     a block loops over, 0 on any other search)
``step.sums``        a step's transform and class sums (device time;
                     ``shear``, and ``sums``: "kernel" where the
                     class-sum kernel ran, else "plain")
``engine.reduce``    the iteration's all-reduce and host reads
``mesh.collective``  one collective of a mesh of more than one rank:
                     the class sums' all-reduce, the params' gather, a
                     references' broadcast (device time; ``op``,
                     ``bytes``)
===================  ====================================================

``SPANS`` names them: a reader of a span can tell a program that
declares it from one that predates it.

Spans are recorded only while a ``torch.profiler`` profile records
(``trace(logdir)`` or any other): the decision is taken once, as a
``job`` opens, so a job is recorded whole or not at all.  Otherwise
opening a span costs one test and returns a shared null context.

A recorded ``Span`` holds its name, its id, its parent's id, its job's
id, its start and end on ``time.perf_counter_ns`` and its attributes
(``recording`` is True on it, False on the null context, for work done
only to fill an attribute).
It also enters ``torch.profiler.record_function(name)``, which puts it
in the profile's trace beside the kernels.  A span opened with a CUDA
``device`` records a pair of timing events on that device's current
stream and never waits for them; ``device_ms()`` reads them when asked
(elsewhere it is the host time).  ``last_job()`` returns the spans of
the last recorded job; only ``trace`` writes anything to disk.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler


SPANS = ("job", "driver.prepare", "driver.update", "driver.refs",
         "driver.fourvar", "driver.raw_sums", "engine.iterate",
         "engine.step", "step.search", "step.sums", "engine.reduce",
         "mesh.collective")


class Span:
    """One recorded span (made by ``span`` / ``job`` while a job records).

    ``parent`` is the enclosing span's ``id`` (None for the job),
    ``job`` the id shared by every span of one driver call."""

    __slots__ = ("name", "id", "parent", "job", "_attrs", "t0_ns", "t1_ns",
                 "_events", "_fn")
    recording = True

    def __init__(self, name: str, device, attrs: dict):
        self.name = name
        self._attrs = attrs
        self.id = next(_IDS)
        self.parent = self.job = None
        self.t0_ns = self.t1_ns = None
        self._events = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            self._events = (stream, torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self._fn = None

    def set(self, **attrs):
        """Add attributes known only once the span is open.  A value may
        be a one-element tensor on the device (a count the step made
        there): it becomes a Python number when ``attrs`` is first read,
        so setting it makes the host wait for nothing."""
        self._attrs.update(attrs)

    @property
    def attrs(self) -> dict:
        for key, value in list(self._attrs.items()):
            if torch.is_tensor(value):
                self._attrs[key] = value.item()
        return self._attrs

    def __enter__(self):
        if _REC.open is None:          # the outermost span: a new job
            _REC.open, _REC.spans = [], []
        self.parent = _REC.open[-1].id if _REC.open else None
        self.job = _REC.open[0].id if _REC.open else self.id
        _REC.open.append(self)
        _REC.spans.append(self)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self.t0_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._events[0])
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[2].record(self._events[0])
        self.t1_ns = time.perf_counter_ns()
        self._fn.__exit__(*exc)
        _REC.open.pop()
        if not _REC.open:
            _REC.last, _REC.open = _REC.spans, None
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    def device_ms(self) -> float:
        """Device ms between the span's events (waits for the end
        event); the host ms for a span with no CUDA device."""
        if self._events is None:
            return self.host_ms
        _, a, b = self._events
        b.synchronize()
        return a.elapsed_time(b)


class _NullSpan:
    """The shared context of every span that is not recorded."""

    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


class _Recorder:
    def __init__(self):
        self.open = None    # the recording job's open spans, or None
        self.spans = []     # the recording job's spans, in start order
        self.last = []      # the last recorded job's spans


_IDS = itertools.count(1)
_REC = _Recorder()
_NULL = _NullSpan()


def job(**attrs):
    """The span of one driver call: recorded, with every span inside it,
    where a ``torch.profiler`` profile records as it opens."""
    if _REC.open is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return Span("job", None, attrs)


def span(name: str, device=None, **attrs):
    """A span named ``name`` inside the recording job (nothing outside
    one).  ``device``: the device whose current stream the span's work
    is queued on; a CUDA device also times it with events."""
    if _REC.open is None:
        return _NULL
    return Span(name, device, attrs)


def last_job() -> list:
    """The spans of the last recorded job, in start order (empty where
    no job was recorded)."""
    return list(_REC.last)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (the CPU, and the
    card where CUDA is available), the program's spans among it, into
    ``logdir`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
