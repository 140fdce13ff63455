"""The port's spans on the CPU (``utils/profiling.py``): a job is recorded
only under a ``torch.profiler`` profile, whole, with every span where
the table of the module docstring puts it, and the spans appear in the
profile's Chrome trace as user annotations."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.models import ali2d_base, mref_ali2d
from cryo_ralib_tpu_torch.utils import profiling
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack)

NX, K, N, MAXIT = 32, 2, 24, 2
PROGRAM_SPANS = ("job", "driver.prepare", "driver.update", "driver.refs",
                 "driver.fourvar", "driver.raw_sums", "engine.iterate",
                 "engine.step", "step.search", "step.sums", "engine.reduce",
                 "mesh.collective")
# a collective runs where its caller is: the sums' all-reduce in
# engine.reduce, the params' gather in driver.update and at the job's
# end, a reference broadcast in driver.update (a reseeded class inside
# driver.refs)
PARENT = {"driver.prepare": "job", "driver.update": "job",
          "driver.refs": "driver.update",
          "driver.fourvar": "driver.update",
          "driver.raw_sums": "driver.update", "engine.iterate": "job",
          "engine.step": "engine.iterate", "step.search": "engine.step",
          "step.sums": "engine.step", "engine.reduce": "engine.iterate",
          "mesh.collective": ("engine.reduce", "driver.update",
                              "driver.refs", "job")}
# the spans a one-process job of each driver records
SINGLE = {"mref": set(PROGRAM_SPANS) - {"driver.fourvar", "driver.raw_sums",
                                        "mesh.collective"},
          "reffree_fourvar": set(PROGRAM_SPANS) - {"driver.refs",
                                                   "mesh.collective"}}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _stack():
    refs = np.asarray(asymmetric_templates(K, NX), np.float32)
    imgs = np.asarray(scattered_stack(refs, N, max_shift=1)[0], np.float32)
    return imgs, refs


def _run(case: str):
    """One tiny driver call; returns its batches per iteration."""
    imgs, refs = _stack()
    kw = dict(ou=12, xr=1, ts=1, maxit=MAXIT, device="cpu",
              log=RunLogger(None, quiet=True))
    if case == "mref":
        mref_ali2d(imgs, refs, **kw)
        return 1
    if case == "mref_streamed":
        mref_ali2d(imgs, refs, batch_size=10, **kw)
        return 3
    extra = {"reffree": {}, "reffree_shc": {"random_method": "SHC"},
             "reffree_scf": {"random_method": "SCF"},
             "reffree_fourvar": {"Fourvar": True}}[case]
    ali2d_base(imgs, **kw, **extra)
    return 1


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_no_profiler_records_no_job(tmp_path):
    with _profile():
        _run("mref")
    before = profiling.last_job()
    assert before
    _run("mref")
    after = profiling.last_job()
    assert [s.id for s in after] == [s.id for s in before]
    # a profile around other work holds no program span
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert not names & set(PROGRAM_SPANS)


@pytest.mark.parametrize("case", ["mref", "mref_streamed", "reffree",
                                  "reffree_shc", "reffree_scf",
                                  "reffree_fourvar"])
def test_a_profiled_job_records_every_span_in_place(case):
    with _profile():
        batches = _run(case)
    spans = profiling.last_job()
    by_id = {s.id: s for s in spans}
    names = [s.name for s in spans]
    assert names.count("job") == 1 and spans[0].name == "job"
    job = spans[0]
    assert job.parent is None
    assert job.attrs["resident"] == (case != "mref_streamed")
    assert job.attrs["sampler"] == "plain"
    assert {s.job for s in spans} == {job.id}
    assert set(names) <= set(PROGRAM_SPANS)
    for s in spans[1:]:
        parent = by_id[s.parent]
        assert parent.name in _parents(s.name), (s, parent)
        assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns
    assert names.count("engine.iterate") == MAXIT
    assert names.count("engine.reduce") == MAXIT
    assert names.count("engine.step") == batches * MAXIT
    assert names.count("step.search") == batches * MAXIT
    assert names.count("step.sums") == batches * MAXIT
    assert names.count("driver.prepare") == 1
    reffree = case.startswith("reffree")
    assert names.count("driver.update") == (2 if reffree else 1) * MAXIT
    assert names.count("driver.raw_sums") == (1 if reffree else 0)
    assert names.count("driver.fourvar") == (
        MAXIT if case == "reffree_fourvar" else 0)
    refs = [s for s in spans if s.name == "driver.refs"]
    assert len(refs) == (0 if reffree else MAXIT)
    assert all(s.attrs["classes"] == K and s.attrs["vanished"] == 0
               for s in refs)
    assert "mesh.collective" not in names
    for s in spans:
        if s.name == "step.search":
            assert {key: s.attrs[key] for key in (
                "box", "rings", "shifts", "mirrors", "ref_groups")} == {
                "box": NX, "rings": 12,
                # mref_ali2d's yr defaults to 0, ali2d_base's to xr; SCF's
                # rotation search is at one shift
                "shifts": 1 if case == "reffree_scf" else 9 if reffree else 3,
                "mirrors": 2, "ref_groups": 0}
    steps = [s for s in spans if s.name == "engine.step"]
    assert [(s.attrs["start"], s.attrs["end"]) for s in steps[:batches]] == (
        [(0, 10), (10, 20), (20, N)] if batches == 3 else [(0, N)])
    for s in spans:
        # on the CPU a span's device time is its host time
        assert s.device_ms() == s.host_ms >= 0


@pytest.mark.parametrize("case", ["mref", "reffree_shc", "reffree_scf"])
def test_the_sums_span_names_the_plain_route_on_the_cpu(case):
    with _profile():
        _run(case)
    sums = [s for s in profiling.last_job() if s.name == "step.sums"]
    assert len(sums) == MAXIT
    assert all(s.attrs["sums"] == "plain" and s.attrs["shear"] is False
               for s in sums)


def _parents(name: str) -> tuple:
    want = PARENT[name]
    return want if isinstance(want, tuple) else (want,)


def test_the_declared_spans_are_the_table():
    assert profiling.SPANS == PROGRAM_SPANS
    assert set(PARENT) == set(PROGRAM_SPANS) - {"job"}
    # every span but the mesh's is recorded by one driver in one process
    assert SINGLE["mref"] | SINGLE["reffree_fourvar"] == (
        set(PROGRAM_SPANS) - {"mesh.collective"})


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_the_spans_are_user_annotations_of_the_trace(tmp_path, case):
    with profiling.trace(str(tmp_path)):
        _run(case)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert SINGLE[case] <= annotated
    assert len(profiling.last_job()) == sum(
        1 for e in events if e.get("cat") == "user_annotation"
        and e["name"] in PROGRAM_SPANS)


def test_the_kernel_shc_search_counts_its_shift_groups():
    """The SHC step's ``step.search`` span carries the shift groups that
    the kernel's blocks ran only where the kernel ran: on the CPU,
    "kernel" runs the plain pick and the span holds no count.  The count
    is set as a one-element tensor (a device sum on the card) and read as
    an int when the span's ``attrs`` are read."""
    imgs, _ = _stack()
    with _profile():
        ali2d_base(imgs, ou=12, xr=1, ts=1, maxit=MAXIT, device="cpu",
                   log=RunLogger(None, quiet=True), random_method="SHC",
                   sampler="kernel")
    spans = profiling.last_job()
    assert spans[0].attrs["sampler"] == "kernel"
    searches = [s for s in spans if s.name == "step.search"]
    assert len(searches) == MAXIT
    for s in searches:
        assert "shc_groups" not in s.attrs
        assert "shc_groups_full" not in s.attrs
    with _profile():
        with profiling.job():
            with profiling.span("step.search") as sp:
                assert sp.recording
                sp.set(shc_groups=torch.ones(N, dtype=torch.int32).sum(),
                       shc_groups_full=3 * N)
    assert not profiling.span("step.search").recording
    attrs = profiling.last_job()[1].attrs
    assert type(attrs["shc_groups"]) is int and attrs["shc_groups"] == N
    assert attrs["shc_groups_full"] == 3 * N


def test_the_kernel_search_counts_its_unclamped_rings():
    """A ``step.search`` span carries ``interior_rings`` and
    ``rings_full`` only where the kernel ran: on the CPU, "kernel" runs
    the plain search and the spans hold no count.  Where the span records
    and the route launches the kernel, the step hands the kernel zeros
    and sets the count's device sum, read as an int, beside N x shifts x
    rings; under SHC beside the shifts each particle searched x rings."""
    from cryo_ralib_tpu_torch.config import AlignConfig
    from cryo_ralib_tpu_torch.models import steps
    from cryo_ralib_tpu_torch.ops.fused_search import KernelPlan

    imgs, _ = _stack()
    with _profile():
        ali2d_base(imgs, ou=12, xr=1, ts=1, maxit=MAXIT, device="cpu",
                   log=RunLogger(None, quiet=True), sampler="kernel")
    searches = [s for s in profiling.last_job() if s.name == "step.search"]
    assert len(searches) == MAXIT
    for s in searches:
        assert "interior_rings" not in s.attrs
        assert "rings_full" not in s.attrs
    cfg = AlignConfig(img_dim=NX, ring_num=12, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    route = steps.Route("kernel", "kernel", 1,
                        plan=KernelPlan(4, True, 200000, 1))
    stack = torch.as_tensor(imgs)
    assert steps._interior_counter(profiling.span("step.search"), route,
                                   stack, 1) is None
    with _profile():
        with profiling.job():
            for shifts in (None, torch.tensor([4, 9] * (N // 2))):
                with profiling.span("step.search") as sp:
                    assert steps._interior_counter(
                        sp, steps.Route("plain", "plain", 1), stack,
                        1) is None
                    assert steps._interior_counter(sp, route, stack,
                                                   0) is None
                    counted = steps._interior_counter(sp, route, stack, 1)
                    assert counted.dtype == torch.int32
                    assert counted.shape == (N,) and not counted.any()
                    counted += 7
                    steps._count_interior(sp, counted, cfg, shifts)
    first, second = [s.attrs for s in profiling.last_job()[1:]]
    assert type(first["interior_rings"]) is int
    assert first["interior_rings"] == second["interior_rings"] == 7 * N
    assert first["rings_full"] == N * cfg.n_shifts * 12
    assert second["rings_full"] == (4 + 9) * (N // 2) * 12


MESH_WORKER = r"""
import json, sys
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
import numpy as np
import torch
torch.set_num_threads(1)
from cryo_ralib_tpu_torch.models import mref_ali2d
from cryo_ralib_tpu_torch.parallel.mesh import initialize_distributed, shutdown
from cryo_ralib_tpu_torch.utils import profiling
from cryo_ralib_tpu_torch.utils.log import RunLogger
data = np.load(sys.argv[5])
mesh = initialize_distributed(rank=rank, world_size=world,
                              init_method="file://" + store, device="cpu",
                              timeout=60)
try:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        mref_ali2d(data["imgs"], data["refs"], ou=12, xr=1, ts=1,
                   maxit=%(maxit)d, device="cpu", mesh=mesh,
                   log=RunLogger(None, quiet=True))
    spans = profiling.last_job()
    by_id = {s.id: s.name for s in spans}
    rec = [{"name": s.name, "parent": by_id.get(s.parent),
            "attrs": {k: v for k, v in s.attrs.items()
                      if k in ("op", "bytes")}} for s in spans]
    with open(out, "w") as f:
        json.dump(rec, f)
finally:
    shutdown()
""" % {"maxit": MAXIT}


def test_a_mesh_job_records_its_collectives(tmp_path):
    """Two gloo ranks record a ``mesh.collective`` span around the class
    sums' all-reduce of every iteration, the params' gathers and the
    references' broadcasts, with ``op`` and ``bytes``; a job on a mesh of
    one rank records none."""
    imgs, refs = _stack()
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, imgs=imgs, refs=refs)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    runs = [(r, 2, "two") for r in range(2)] + [(0, 1, "one")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_WORKER, str(r), str(w),
         str(tmp_path / (tag + ".store")),
         str(tmp_path / f"{tag}{r}.json"), inputs],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r, w, tag in runs]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-3000:]
    h = NX
    for r in range(2):
        with open(tmp_path / f"two{r}.json") as f:
            spans = json.load(f)
        coll = [s for s in spans if s["name"] == "mesh.collective"]
        ops = [s["attrs"]["op"] for s in coll]
        assert ops.count("all_reduce_sums") == MAXIT
        assert ops.count("gather_params") == MAXIT + 1
        assert ops.count("broadcast_refs") == MAXIT
        for s in coll:
            assert s["parent"] in _parents("mesh.collective"), s
            assert s["attrs"]["bytes"] == {
                "all_reduce_sums": 8 * K * 2 * h * h + 8 * (K + 3),
                "gather_params": 4 * 5 * N,
                "broadcast_refs": 4 * K * h * h}[s["attrs"]["op"]]
    with open(tmp_path / "one0.json") as f:
        spans = json.load(f)
    assert spans and not [s for s in spans if s["name"] == "mesh.collective"]
