"""The port's spans on the CPU (``utils/profiling.py``): a job is recorded
only under a ``torch.profiler`` profile, whole, with every span where
the table of the module docstring puts it, and the spans appear in the
profile's Chrome trace as user annotations."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.models import ali2d_base, mref_ali2d
from cryo_ralib_tpu_torch.utils import profiling
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack)

NX, K, N, MAXIT = 32, 2, 24, 2
PROGRAM_SPANS = ("job", "driver.prepare", "driver.update", "driver.fourvar",
                 "driver.raw_sums", "engine.iterate", "engine.step",
                 "step.search", "step.sums", "engine.reduce")
PARENT = {"driver.prepare": "job", "driver.update": "job",
          "driver.fourvar": "driver.update",
          "driver.raw_sums": "driver.update", "engine.iterate": "job",
          "engine.step": "engine.iterate", "step.search": "engine.step",
          "step.sums": "engine.step", "engine.reduce": "engine.iterate"}


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
        assert parent.name == PARENT[s.name], (s, parent)
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
    steps = [s for s in spans if s.name == "engine.step"]
    assert [(s.attrs["start"], s.attrs["end"]) for s in steps[:batches]] == (
        [(0, 10), (10, 20), (20, N)] if batches == 3 else [(0, N)])
    for s in spans:
        # on the CPU a span's device time is its host time
        assert s.device_ms() == s.host_ms >= 0


def test_the_spans_are_user_annotations_of_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        _run("reffree_fourvar")
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert set(PROGRAM_SPANS) <= annotated
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
