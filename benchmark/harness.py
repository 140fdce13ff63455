"""The benchmark of ``cryo_ralib_tpu_torch``: whole alignment jobs.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the deployment, its driver and sizes) and a
traffic mix (``traffic/<name>.json``: the search's mode, the ranks, the
warm-up and the checked sample); its limits are ``limits/<cell>.json``
and each metric is read by ``metrics/<metric>.py``.  Nothing here names
a cell.

One run: make the templates and the particle stack on the card from the
seed, copy the stack to host memory once (a user's job starts from a
host array), load the search kernel, warm up through the same entry on
one block of particles; then run whole jobs (one driver call of
``maxit`` iterations, from the host array to the result on the host,
``outdir=None``) back to back until the first one that ends at or after
``--seconds``.  Then the job's answers are held to the plain reference
(``check.py``) and one JSON line is printed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cryo_ralib_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell named ``workload`` with its configuration, traffic,
    limits and metrics, from ``BENCHMARK.json`` and the files it names."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(cells: {', '.join(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return {"cell": cell, "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark's process
    may not hold (compared whole: ``cryo_ralib_tpu_torch`` is not
    ``cryo_ralib_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def refuse_forbidden():
    """Exit with code 3, naming them, where forbidden modules are
    loaded; called as the window closes, after the metrics are read and
    before the result is printed."""
    found = forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        raise SystemExit(3)


def run_job(cfg: dict, traffic: dict, images, refs, device, log,
            mesh=None, maxit: int | None = None):
    """One call of the configuration's driver; the traffic's optional
    ``batch_size`` streams the stack in batches of that many particles
    (absent: the planner's choice, resident where the stack fits)."""
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.models.reffree import ali2d_base

    kw = dict(outdir=None, ou=cfg["ou"], xr=cfg["xr"], yr=cfg["yr"],
              ts=cfg["ts"], center=cfg["center"],
              maxit=maxit or cfg["maxit"], log=log, device=device,
              sampler=traffic["sampler"], mesh=mesh,
              batch_size=traffic.get("batch_size"))
    if cfg["driver"] == "mref_ali2d":
        return mref_ali2d(images, refs, **kw)
    if cfg["driver"] == "ali2d_base":
        return ali2d_base(images, random_method=traffic["random_method"],
                          **kw)
    raise ValueError(f"unknown driver {cfg['driver']!r}")


def _shard(local, start: int, n: int, mesh):
    if mesh is None:
        return local
    from cryo_ralib_tpu_torch.parallel.mesh import StackShard
    return StackShard(local, start, n)


def _warm_images(host, n_warm: int, mesh):
    """The warm-up stack: the first ``n_warm`` particles (under a mesh
    the rank's block of a stack of ``n_warm``, from its own rows)."""
    if mesh is None:
        return host[:n_warm]
    from cryo_ralib_tpu_torch.parallel.mesh import shard_range
    a, b = shard_range(n_warm, mesh)
    return _shard(host[:b - a], a, n_warm, mesh)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device="cuda", mesh=None, t_start: float | None = None,
             faults=None, control: bool = False):
    """Set up, run the window, check; returns the result line's dict on
    the root rank, None on the others.  ``faults``, for tests, is called
    with the window's first job about to start.  ``control`` also reads
    the control's numbers (the reference in TF32 in the program's place,
    from the same inputs) into the line's ``control``; the benchmark's
    own runs never do."""
    import capture
    import check
    import gen
    import reference as R

    t_start = time.time() if t_start is None else t_start
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device if mesh is None else mesh.device)
    cuda = dev.type == "cuda"
    root = mesh is None or mesh.is_root
    n, nx = int(cfg["n_particles"]), int(cfg["box"])
    if mesh is None:
        start, stop = 0, n
    else:
        from cryo_ralib_tpu_torch.parallel.mesh import shard_range
        start, stop = shard_range(n, mesh)

    # ---- set-up: inputs from the seed, on the device, to the host once
    tmpl = gen.templates(int(cfg["stack_classes"]), nx)
    refs0 = tmpl[:int(cfg["n_refs"])] if cfg["driver"] == "mref_ali2d" \
        else None
    made = gen.stack(torch.as_tensor(tmpl, device=dev), seed, start, stop,
                     dev)
    host = made.cpu().numpy()
    del made
    if cuda:
        from cryo_ralib_tpu_torch.ops.fused_search import build
        build()
    rec = capture.Recorder(gen.sample(seed, n, traffic["check_particles"]),
                           trace=trace)
    rec.install()
    marks: list = []
    log = capture.StampLogger(marks)
    images = _shard(host, start, n, mesh)
    rec.active = False
    run_job(cfg, traffic, _warm_images(host, traffic["warmup_particles"],
                                       mesh),
            refs0, dev, log, mesh, traffic["warmup_maxit"])
    rec.active = True
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    coord = _coordination(mesh)
    if mesh is not None:
        torch.distributed.barrier(group=coord)

    # ---- the window
    setup_s = time.time() - t_start
    jobs, iterations, job_spans = 0, 0, []
    prof = None
    if faults is not None:
        faults()
    w0 = time.perf_counter()
    while True:
        job = rec.start_job()
        log.marks = job.marks
        if trace and jobs == 0:
            prof = _profiler(cuda)
            prof.__enter__()
            if mesh is not None:
                # the profilers start in seconds that differ by rank: the
                # ranks' profiled jobs start together, or the first to
                # start would wait for the others in its first collective
                torch.distributed.barrier(group=coord)
            with torch.profiler.record_function("bench.job"):
                result = run_job(cfg, traffic, images, refs0, dev, log, mesh)
            prof.__exit__(None, None, None)
        else:
            result = run_job(cfg, traffic, images, refs0, dev, log, mesh)
        rec.end_job(result)
        jobs += 1
        iterations += len(job.marks)
        job_spans.append((job.t0, job.t1, list(job.marks), list(job.spans)))
        done = time.perf_counter() - w0 >= seconds
        if mesh is not None:
            flag = [done]
            torch.distributed.broadcast_object_list(flag, src=0,
                                                    group=coord)
            done = flag[0]
        if done:
            break
    w1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    refuse_forbidden()

    obs = {"n": n, "iterations": iterations, "jobs": jobs,
           "window_s": w1 - w0, "setup_s": setup_s,
           "job_spans": job_spans, "iterate_s": list(rec.iterate_s),
           "memory_peak_bytes": peak, "world": 1 if mesh is None
           else mesh.world_size}
    if trace and cuda:
        obs["search"] = [(ms, a.elapsed_time(b))
                         for ms, a, b in rec.search_calls]
        obs["trace"] = _reduce_profile(prof)
    records = capture.to_host(rec.job)
    final_refs = getattr(rec.job.result, "references", None)
    rec.uninstall()
    del result, rec, job, images
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- gather the ranks' samples and readings
    if mesh is not None:
        mine = {"records": [{"new": r["new"], "search": r["search"]}
                            for r in records],
                "peak": peak, "trace": {k: obs["trace"][k] for k in
                                        ("busy_s", "window_s")}
                if "trace" in obs else None}
        got = [None] * mesh.world_size if root else None
        torch.distributed.gather_object(mine, got, dst=0, group=coord)
        if not root:
            return None
        records = capture.merge_ranks(
            [records] + [[{**records[t], **p} for t, p in
                          enumerate(g["records"])] for g in got[1:]])
        obs["memory_peak_bytes"] = max(g["peak"] for g in got)
        if "trace" in obs:
            obs["trace"].update(ranks_trace([g["trace"] for g in got]))

    # ---- correctness: the reference, after the program's state is freed
    t_check = time.perf_counter()
    mask = R.disc(cfg["ou"], nx)
    if mesh is not None:
        host = gen.stack(torch.as_tensor(tmpl, device=dev), seed, 0, n,
                         dev).cpu().numpy()
    imgs = check.prepared(host, cfg["driver"], mask, dev)
    del host
    geo = R.Geometry(nx, cfg["ou"], cfg["xr"], cfg["yr"], cfg["ts"],
                     cfg.get("mirror", True), dev)
    numbers = {}
    numbers.update(check.search_numbers(
        records, imgs, geo, traffic["random_method"] == "SHC", dev))
    numbers.update(check.sums_numbers(records, imgs, dev))
    numbers.update(check.refs_numbers(records, final_refs, imgs,
                                      cfg["driver"], refs0, mask, n, dev))
    correct, table = check.verdict(numbers, spec["limits"])
    print(f"timing: set-up {setup_s:.2f} s, window {w1 - w0:.2f} s "
          f"({jobs} jobs), check {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)
    print("jobs (s, s before the first iteration): " + ", ".join(
        f"{t1 - t0:.3f}/{(sp[0][0] if sp else t1) - t0:.3f}"
        for t0, t1, _m, sp in job_spans), file=sys.stderr)
    ctrl = None
    if control:
        ctrl = check.search_numbers(
            records, imgs, geo, traffic["random_method"] == "SHC", dev,
            rounding=R.tf32)
        ctrl.update(check.sums_numbers(records, imgs, dev, rounding=R.tf32))
        ctrl.update(check.refs_numbers(records, final_refs, imgs,
                                       cfg["driver"], refs0, mask, n, dev,
                                       rounding=R.tf32))
        ctrl_correct, ctrl_table = check.verdict(ctrl, spec["limits"])
        for name, c in ctrl_table.items():
            print(f"control {name}: {c['value']!r} (limit {c['limit']!r})",
                  file=sys.stderr)
        print(f"control: correct {ctrl_correct}", file=sys.stderr)

    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    refuse_forbidden()
    out = {"correct": bool(correct), "attempted": jobs, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else "cpu",
                      "count": obs["world"],
                      "memory_peak_bytes": int(obs["memory_peak_bytes"])}}
    if "trace" in obs:
        t = obs["trace"]
        out["device"]["busy_s"] = t["busy_s"]
        out["device"]["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    if ctrl is not None:
        out["control"] = ctrl
        out["control_correct"] = bool(ctrl_correct)
    out["checks"] = table
    return out


def ranks_trace(traces: list) -> dict:
    """``busy_s`` and ``window_s`` of a mesh's traced job from each
    rank's own: both means over the ranks (each rank's busy time lies
    within its own profiled job, whose span differs a little by rank),
    so that the busy time never exceeds the window."""
    return {k: float(np.mean([t[k] for t in traces]))
            for k in ("busy_s", "window_s")}


_COORD: dict = {}


def _coordination(mesh):
    """A gloo group of every rank for the harness's own messages (the
    window's end, the gathered readings), made once per process group;
    None without a mesh."""
    if mesh is None:
        return None
    if mesh.world_size not in _COORD:
        _COORD[mesh.world_size] = torch.distributed.new_group(
            backend="gloo")
    return _COORD[mesh.world_size]


def _profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _reduce_profile(prof) -> dict:
    import devtrace as tr

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace: {os.path.getsize(path)} bytes", file=sys.stderr)
        return tr.reduce_file(path)


def print_result(out: dict):
    """The checks as the last lines on standard error, the result as the
    last line on standard output; nothing where a forbidden module is
    loaded."""
    refuse_forbidden()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
