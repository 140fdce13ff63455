"""What the benchmark records of the system under test while it runs.

Wrappers, installed from here around the port's own entry points:

* ``StampLogger``, the ``log=`` of ``mref_ali2d`` and ``ali2d_base``: a
  ``perf_counter`` stamp at every ``ITERATION #`` (mref, at an
  iteration's end) or ``Iteration #`` (reffree, at its start) line; the
  port's logger stamps to the second;
* ``AlignmentEngine.iterate``: its host-clock span (the call ends in a
  host read, so it is synchronised), the references it was given and
  the result it returned; ``_batches``: the span of particles a streamed
  batch holds; ``params_np``: the whole stack's params after an
  iteration;
* ``models.steps._search`` (the standard search, whichever sampler
  runs) and every SHC search that ``models.steps`` calls by name
  (``SHC_SEARCHES``: the plain, template and matmul ones): the winners,
  rows and input params of the checked sample of particles, taken with
  ``index_select`` on the device (no host wait); in a traced run also
  CUDA events around each ``_search`` call with its shapes.

Only the last job's records are kept.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from bound import search_bound
from cryo_ralib_tpu_torch.models import engine as _engine
from cryo_ralib_tpu_torch.models import steps as _steps
from cryo_ralib_tpu_torch.utils.log import RunLogger

MARKS = ("ITERATION #", "Iteration #")
FIELDS = ("angle", "shift_x", "shift_y", "mirror", "ref_id")
WINNER = ("best_val", "best_row", "best_aidx", "best_sidx", "best_ref",
          "best_mirror")




def shc_searches() -> list:
    """The SHC searches ``align_step_shc`` can call: every function of
    ``models.steps``' namespace whose name holds ``search_shc``."""
    return sorted(name for name, f in vars(_steps).items()
                  if "search_shc" in name and callable(f))


class StampLogger(RunLogger):
    """A silent run logger that stamps each iteration line."""

    def __init__(self, marks: list):
        super().__init__(None, quiet=True)
        self.marks = marks

    def add(self, msg: str):
        if str(msg).startswith(MARKS):
            self.marks.append(time.perf_counter())


class Job:
    def __init__(self):
        self.marks: list = []
        self.spans: list = []       # iterate (t0, t1), host clock
        self.iters: list = []       # per iteration, see Recorder.iterate
        self.t0 = time.perf_counter()
        self.t1 = None
        self.result = None


class Recorder:
    """Records of the running jobs; ``sample`` the global indices of the
    particles whose answers are checked."""

    def __init__(self, sample: np.ndarray, trace: bool = False):
        self.sample = np.asarray(sample, np.int64)
        self.trace = trace
        self.active = True
        self.job: Job | None = None
        self.iterate_s: list = []     # every iterate of the window
        self.search_calls: list = []  # traced: (bound_ms, start, end)
        self.span = (0, 0)
        self._pos: dict = {}
        self._orig: dict = {}

    # -- jobs ------------------------------------------------------------
    def start_job(self) -> Job:
        self.job = Job()
        return self.job

    def end_job(self, result):
        self.job.t1 = time.perf_counter()
        self.job.result = result

    # -- sample positions ------------------------------------------------
    def positions(self, lo: int, hi: int, device):
        """(global ids, their positions in [lo, hi) on ``device``) of the
        sampled particles inside the span; the index tensor is made once
        per span and device, copied without a host wait."""
        key = (lo, hi, str(device))
        if key not in self._pos:
            a, b = np.searchsorted(self.sample, [lo, hi])
            g = self.sample[a:b]
            host = torch.from_numpy(g - lo)
            if torch.device(device).type == "cuda":
                host = host.pin_memory()
                dev = host.to(device, non_blocking=True)
            else:
                dev = host
            self._pos[key] = (g, dev, host)
        g, dev, _ = self._pos[key]
        return g, dev

    def _record(self, kind: str, entry: dict):
        if self.active and self.job is not None and self.job.iters:
            self.job.iters[-1].setdefault(kind, []).append(entry)

    # -- wrappers --------------------------------------------------------
    def install(self):
        """Wrap the port's entry points (once)."""
        if self._orig:
            return
        rec = self
        E = _engine.AlignmentEngine
        self._orig = {"iterate": E.iterate, "_batches": E._batches,
                      "params_np": E.params_np, "_search": _steps._search,
                      "shc": {name: getattr(_steps, name)
                              for name in shc_searches()}}
        orig = self._orig

        def iterate(engine, refs, discrete=False):
            lo = engine.start
            rec.span = (lo, lo + engine.n_local)
            if rec.active and rec.job is not None:
                rec.job.iters.append({"refs": np.array(refs, np.float32)})
            ctx = (torch.profiler.record_function("bench.iterate")
                   if rec.trace else nullcontext())
            t0 = time.perf_counter()
            with ctx:
                out = orig["iterate"](engine, refs, discrete)
            t1 = time.perf_counter()
            if rec.active and rec.job is not None:
                rec.job.spans.append((t0, t1))
                rec.iterate_s.append(t1 - t0)
                it = rec.job.iters[-1]
                it["result"] = out
                it["new"] = rec._new_params(engine)
            return out

        def batches(engine):
            for item in orig["_batches"](engine):
                rec.span = (engine.start + item[0], engine.start + item[1])
                yield item

        def params_np(engine):
            out = orig["params_np"](engine)
            if rec.active and rec.job is not None and rec.job.iters:
                rec.job.iters[-1]["params_full"] = out
            return out

        def search(images, refs, params, cfg, *a, **k):
            timed = rec.trace and rec.active and images.is_cuda
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            r = orig["_search"](images, refs, params, cfg, *a, **k)
            if timed:
                ev[1].record()
                ms, _ = search_bound(images.shape[0], images.shape[-1],
                                     cfg.ring_num, cfg.n_shifts,
                                     refs.shape[0], 2 if cfg.mirror else 1)
                rec.search_calls.append((ms, ev[0], ev[1]))
            rec._winners("search", images, r, params)
            return r

        def shc(fn):
            def wrapped(images, ref_fw, params, cfg, previousmax, *a, **k):
                r, found = fn(images, ref_fw, params, cfg, previousmax,
                              *a, **k)
                rec._winners("search", images, r, params,
                             previousmax=previousmax, found=found)
                return r, found
            return wrapped

        E.iterate = iterate
        E._batches = batches
        E.params_np = params_np
        _steps._search = search
        for name, fn in orig["shc"].items():
            setattr(_steps, name, shc(fn))

    def uninstall(self):
        if not self._orig:
            return
        E = _engine.AlignmentEngine
        E.iterate = self._orig["iterate"]
        E._batches = self._orig["_batches"]
        E.params_np = self._orig["params_np"]
        _steps._search = self._orig["_search"]
        for name, fn in self._orig["shc"].items():
            setattr(_steps, name, fn)
        self._orig = {}

    def _winners(self, kind, images, r, params, **extra):
        if not (self.active and self.job is not None):
            return
        g, pos = self.positions(*self.span, images.device)
        if not len(g):
            return
        entry = {"gidx": g}
        for f in WINNER:
            entry[f] = getattr(r, f).index_select(0, pos)
        for f in FIELDS:
            entry["prev_" + f] = getattr(params, f).index_select(0, pos)
        for name, t in extra.items():
            entry[name] = t.index_select(0, pos)
        self._record(kind, entry)

    def _new_params(self, engine) -> dict:
        """The sampled particles' params after the iteration (on the
        device where the stack is resident, else from the host copy)."""
        lo = engine.start
        g, pos = self.positions(lo, lo + engine.n_local,
                                engine.params.angle.device)
        return {"gidx": g, **{f: getattr(engine.params, f).index_select(0, pos)
                              for f in FIELDS}}


def to_host(job: Job) -> list:
    """The job's per-iteration records with every tensor on the host as
    numpy, the captures of one iteration concatenated: a list of dicts
    with ``refs``, ``sums``, ``counts``, ``sx_sum``, ``sy_sum``,
    ``params`` (whole stack, dict of arrays), ``new`` and ``search``
    (dicts of arrays over the sampled particles)."""
    out = []
    for it in job.iters:
        res = it["result"]
        full = it["params_full"]
        rec = {"refs": it["refs"], "sums": res.class_sums,
               "counts": res.counts, "sx_sum": res.sx_sum,
               "sy_sum": res.sy_sum,
               "params": {f: np.asarray(getattr(full, f)) for f in FIELDS},
               "new": {k: _np(v) for k, v in it["new"].items()},
               "search": _cat(it.get("search", []))}
        out.append(rec)
    return out


def _np(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _cat(entries: list) -> dict:
    if not entries:
        return {}
    return {k: np.concatenate([_np(e[k]) for e in entries])
            for k in entries[0]}


def merge_ranks(parts: list) -> list:
    """One record list from every rank's (the per-particle captures
    concatenated; the rest is the same on every rank)."""
    out = parts[0]
    for t, it in enumerate(out):
        for key in ("new", "search"):
            pieces = [p[t][key] for p in parts if p[t][key]]
            it[key] = ({k: np.concatenate([q[k] for q in pieces])
                        for k in pieces[0]} if pieces else {})
    return out
