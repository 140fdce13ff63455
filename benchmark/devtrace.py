"""Reduction of one profiled job's device trace (``torch.profiler``'s
Chrome trace) to what the per-layer metrics and the breakdown read."""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list) -> dict:
    """``events``: the trace's ``traceEvents``.  The job is the
    ``bench.job`` annotation, its iterations the ``bench.iterate`` ones.
    Returns ``busy_s`` (the union of device operations inside the job),
    ``window_s`` (the job's span), ``device_ops`` (the ten device
    operations that took most time, by name), ``idle_gaps`` (the ten
    longest gaps with no device operation, named by what the host was
    doing) and ``iterations``."""
    def ann(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("ph") == "X" and e.get("name") == name
                      and e.get("cat") == "user_annotation")

    jobs = ann("bench.job")
    if not jobs:
        raise ValueError("the trace holds no bench.job annotation")
    j0, j1 = jobs[0]
    iters = [s for s in ann("bench.iterate") if j0 <= s[0] <= j1]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS
           and e["ts"] < j1 and e["ts"] + e["dur"] > j0]
    if not dev:
        raise ValueError("the trace holds no device operation in the job")
    busy = _merge((max(j0, e["ts"]), min(j1, e["ts"] + e["dur"]))
                  for e in dev)
    busy_us = sum(b - a for a, b in busy)
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edge = j0
    for a, b in busy + [[j1, j1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    labelled = sorted(((b - a, _phase((a + b) / 2, iters)) for a, b in gaps),
                      reverse=True)[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": (j1 - j0) * 1e-6,
            "device_ops": [[name[:160], us * 1e-6] for name, us in ops],
            "idle_gaps": [[name, us * 1e-6] for us, name in labelled],
            "iterations": len(iters)}


def _phase(t: float, iters: list) -> str:
    for i, (a, b) in enumerate(iters):
        if a <= t <= b:
            return f"engine.iterate (iteration {i + 1})"
    if not iters or t < iters[0][0]:
        return "driver set-up (upload, normalisation, planning)"
    if t > iters[-1][1]:
        return "driver end (final params, result)"
    i = sum(1 for a, _ in iters if a < t)
    return f"driver host update (after iteration {i})"


def reduce_file(path) -> dict:
    with open(path) as f:
        return reduce_events(json.load(f)["traceEvents"])
