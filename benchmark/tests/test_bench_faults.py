"""Whole runs of the harness on the CPU, past its look for a card, with
the timed path broken underneath: each fault a cell can have turns
``correct`` false, and the sound run reads true."""

from __future__ import annotations

import json
import math

import pytest
import torch
import torch.multiprocessing as mp

from conftest import BIG_SEED, tiny_spec

import capture
import harness
from cryo_ralib_tpu_torch.models import engine as engine_mod
from cryo_ralib_tpu_torch.models import steps as steps_mod
from cryo_ralib_tpu_torch.utils import profiling


def run(spec, fault=None):
    return harness.run_cell(spec, BIG_SEED, 0.0, False, "cpu", faults=fault)


def failing(out):
    return {k for k, c in out["checks"].items()
            if not c["value"] <= c["limit"]}


CASES = [("mref_ali2d", ""), ("ali2d_base", ""), ("ali2d_base", "SHC")]


@pytest.mark.parametrize("driver,method", CASES)
def test_sound_run_is_correct(driver, method):
    out = run(tiny_spec(driver, method))
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"particles_per_s", "setup_s"}


def unchanged_state(monkeypatch):
    """Every step hands back the params it was given."""
    def fault():
        monkeypatch.setattr(steps_mod, "decode_params",
                            lambda result, params, *a, **k: params)
    return fault


def half_batch(monkeypatch):
    """The step sums half of its particles and doubles the sums, the
    mean of the rest."""
    orig = steps_mod._finish_step

    def finish(images, new_params, peak, gidx, valid, *a, **k):
        h = images.shape[0] // 2
        part = type(new_params)(*[f[:h] for f in new_params])
        out = orig(images[:h], part, peak[:h], gidx[:h],
                   None if valid is None else valid[:h], *a, **k)
        return out._replace(params=new_params, peak=peak,
                            class_sums=out.class_sums * 2,
                            counts=out.counts * 2)

    def fault():
        monkeypatch.setattr(steps_mod, "_finish_step", finish)
    return fault


def altered_answer(monkeypatch):
    """One particle's decoded angle is moved where it is produced."""
    orig = steps_mod.decode_params

    def decode(*a, **k):
        p = orig(*a, **k)
        angle = p.angle.clone()
        angle[::7] += 7.0
        return p._replace(angle=angle)

    def fault():
        monkeypatch.setattr(steps_mod, "decode_params", decode)
    return fault


@pytest.mark.parametrize("driver,method", CASES)
@pytest.mark.parametrize("make", [unchanged_state, half_batch,
                                  altered_answer])
def test_fault_is_not_correct(monkeypatch, make, driver, method):
    out = run(tiny_spec(driver, method), make(monkeypatch))
    assert not out["correct"], out["checks"]


def _rank(rank, world, store, fault, queue, trace=False):
    torch.set_num_threads(1)
    import check
    from cryo_ralib_tpu_torch.parallel import mesh as mesh_mod

    m = mesh_mod.initialize_distributed(rank=rank, world_size=world,
                                        init_method=f"file://{store}",
                                        device="cpu")

    def no_exchange():
        engine_mod.all_reduce_sums = lambda mesh, *t: t

    # what the check's stack arrives as (on a card, a tensor there fails
    # np.asarray; on the CPU it would pass unseen)
    prepared, given = check.prepared, []

    def spy(stack, *a, **k):
        given.append(type(stack).__module__ + "." + type(stack).__name__)
        return prepared(stack, *a, **k)
    check.prepared = spy
    spec = tiny_spec(n=384)
    if trace:
        spec["per_layer"].append({"name": "mesh.collective_ms",
                                  "unit": "ms"})
    try:
        out = harness.run_cell(spec, BIG_SEED, 0.0, trace, "cpu", mesh=m,
                               faults=no_exchange if fault else None)
        if out is not None:
            out["prepared"] = given
            queue.put(json.dumps(out))
    finally:
        mesh_mod.shutdown()


def _two_ranks(tmp_path, fault, trace=False):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, tmp_path / "store",
                                             fault, queue, trace))
             for r in range(2)]
    for p in procs:
        p.start()
    out = json.loads(queue.get(timeout=240))
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert out["device"]["count"] == 2
    return out


@pytest.mark.parametrize("fault", [False, True])
def test_ranks_without_the_exchange_are_not_correct(tmp_path, fault):
    out = _two_ranks(tmp_path, fault)
    assert out["correct"] is (not fault), out["checks"]
    if fault:
        assert {"sums_err", "counts_err"} & failing(out)


@pytest.mark.parametrize("sampler", ["auto", "template", "matmul"])
def test_shc_search_is_recorded_whichever_search_runs(sampler):
    """The SHC cell's check finds every sampled particle's search in
    every iteration, whichever SHC search the step routes to."""
    spec = tiny_spec("ali2d_base", "SHC")
    spec["traffic"]["sampler"] = sampler
    out = run(spec)
    values = {k: c["value"] for k, c in out["checks"].items()}
    assert all(math.isfinite(v) for v in values.values()), values


def test_a_search_the_capture_misses_is_not_correct(monkeypatch, capsys):
    """An SHC search that runs unrecorded fails with its reason named,
    not with a KeyError."""
    monkeypatch.setattr(capture, "shc_searches", lambda: [])
    out = run(tiny_spec("ali2d_base", "SHC"))
    assert not out["correct"]
    assert math.isnan(out["checks"]["shc_gap"]["value"])
    assert "have no search record" in capsys.readouterr().err


def test_ranks_check_a_host_stack_and_read_their_collectives(tmp_path):
    """Under a mesh the check gets the whole stack as a host array, as
    the one-rank path gives it, and rank 0's traced job reads the
    collectives' time."""
    out = _two_ranks(tmp_path, False, trace=True)
    assert out["prepared"] == ["numpy.ndarray"]
    assert out["correct"], out["checks"]
    assert out["metrics"]["mesh.collective_ms"]["value"] > 0


@pytest.mark.parametrize("driver", ["mref_ali2d", "ali2d_base"])
def test_streamed_run_is_correct(driver):
    """A traffic file's ``batch_size`` below N streams the stack in
    batches (a step a batch), and the streamed job holds to the
    reference."""
    spec = tiny_spec(driver, maxit=2)
    spec["traffic"]["batch_size"] = 128
    out = harness.run_cell(spec, BIG_SEED, 0.0, True, "cpu")
    assert out["correct"], out["checks"]
    spans = profiling.last_job()
    iterations = sum(s.name == "engine.iterate" for s in spans)
    steps = sum(s.name == "engine.step" for s in spans)
    assert iterations == 2 and steps == iterations * 512 // 128
