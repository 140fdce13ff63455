"""The kernel's gate and the ``members`` limit, on the CPU.

``sampler="auto"`` on a CUDA device runs the PyTorch search, and logs
it, where the kernel cannot run the geometry (``kernel_gate``: another
ring length, a block over the device's shared memory, the int32
priority bound); ``sampler="kernel"`` raises ``ValueError`` there.  The
route (``resolve_route``) carries the kernel's plan where it runs.  No
card is needed: the device is the string "cuda" and the shared memory
limit is passed.  ``plan_model`` (the CPU copy of the kernel's launch
plan) is held to the plans that ``kernel_plan`` read on an H100.

The class-average write of ``mref_ali2d`` (``aqm%03d.hdf``) leaves
``members`` out of a class that HDF5's one object-header message cannot
hold (more than 16364 particles) and logs it; a class that fits is
written byte for byte as ``write_hdf_stack`` writes it.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.io.eman_hdf import (header_fits, read_own_hdf,
                                              write_hdf_stack)
from cryo_ralib_tpu_torch.models import steps
from cryo_ralib_tpu_torch.models.mref import write_class_averages
from cryo_ralib_tpu_torch.ops import fused_search as fs

H100_SMEM = 232448
HEADLINE = dict(img_dim=90, ring_num=36, shift_step=1.0, shift_rng_x=3.0,
                shift_rng_y=3.0)
# 2 * 49 shifts * K * 256 >= 2**31 from this K on
K_OVER_INT32 = 2 ** 31 // (2 * 49 * 256) + 1


def _cfg(**kw):
    return AlignConfig(**{**HEADLINE, **kw})


@pytest.mark.parametrize("mirror,k,want", [
    (True, 8, {"group": 3, "image_in_smem": True, "smem_bytes": 229456}),
    (True, 1, {"group": 4, "image_in_smem": True, "smem_bytes": 225040}),
    (False, 1, {"group": 4, "image_in_smem": True, "smem_bytes": 220944}),
])
def test_plan_model_matches_the_card(mirror, k, want):
    """The plans ``kernel_plan`` printed on an H100 at 90 px, R=36, 49
    shifts (chip_smoke.py; PERF.md's kernel table)."""
    assert fs.plan_model(36, mirror, k, 49, 90, 90, H100_SMEM) == want


GATE_CASES = [
    # config, n_refs, smem_limit, words the reason names
    (dict(ring_len=128), 8, None, "ring_len=128"),
    (dict(ring_num=36), 8, 80000, "shared memory"),
    (dict(img_dim=512, ring_num=200), 1, None, "ring_num=200"),
    (dict(), K_OVER_INT32, None, "int32"),
]


@pytest.mark.parametrize("geom,k,limit,words", GATE_CASES)
def test_outside_the_gate_auto_is_plain_and_kernel_raises(geom, k, limit,
                                                          words, caplog):
    cfg = _cfg(**geom)
    reason = fs.kernel_gate(cfg, k, 90, 90, smem_limit=limit)
    assert reason is not None and words in reason
    with caplog.at_level(logging.INFO, logger=steps.__name__):
        got = steps.resolve_route("auto", "cuda", cfg, n_refs=k,
                                  smem_limit=limit)
    # the PyTorch search, the class-sum kernel, no launch plan
    assert (got.search, got.sums, got.plan) == ("plain", "kernel", None)
    assert any("search engine: plain" in r.getMessage() and words
               in r.getMessage() for r in caplog.records)
    assert steps.resolve_route("auto", "cpu", cfg, n_refs=k,
                               smem_limit=limit).search == "plain"
    assert steps.resolve_route("plain", "cuda", cfg, n_refs=k,
                               smem_limit=limit).search == "plain"
    for dev in ("cuda", "cpu"):
        with pytest.raises(ValueError,
                           match="gate.*" + words.split("=")[0]):
            steps.resolve_route("kernel", dev, cfg, n_refs=k,
                                smem_limit=limit)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_inside_the_gate_auto_is_the_kernel(k):
    cfg = _cfg()
    assert fs.kernel_gate(cfg, k, 90, 90, smem_limit=H100_SMEM) is None
    route = steps.resolve_route("auto", "cuda", cfg, n_refs=k,
                                smem_limit=H100_SMEM)
    assert (route.search, route.sums, route.refs) == ("kernel", "kernel", k)
    # the plan is plan_model's, with the kernel's groups of 8 references
    # (one group of one at K=1)
    assert route.plan._asdict() == {
        **fs.plan_model(36, True, k, 49, 90, 90, H100_SMEM),
        "ref_groups": {1: 1, 8: 1, 64: 8}[k]}
    cpu = steps.resolve_route("auto", "cpu", cfg, n_refs=k)
    assert (cpu.search, cpu.sums, cpu.plan) == ("plain", "plain", None)
    # the smallest block the kernel takes: one shift per group, the image
    # read through the cache
    small = fs.plan_model(36, True, k, 1, 90, 90, 10 ** 9)["smem_bytes"]
    small -= 4 * 90 * 90
    assert steps.resolve_route("auto", "cuda", cfg, n_refs=k,
                               smem_limit=small).search == "kernel"
    assert steps.resolve_route("auto", "cuda", cfg, n_refs=k,
                               smem_limit=small - 1).search == "plain"


class ListLog:
    def __init__(self):
        self.lines = []

    def add(self, msg):
        self.lines.append(str(msg))


@pytest.mark.parametrize("big", [16364, 16365])
def test_class_averages_leave_out_members_that_do_not_fit(tmp_path, big):
    refs = np.arange(2 * 8 * 8, dtype=np.float32).reshape(2, 8, 8)
    members = [list(range(big)), list(range(big, big + 5))]
    counts = [len(m) for m in members]
    log = ListLog()
    path = str(tmp_path / "aqm000.hdf")
    write_class_averages(path, refs, counts, members, log)
    imgs, headers = read_own_hdf(path)
    np.testing.assert_array_equal(imgs, refs)
    assert [h["ave_n"] for h in headers] == counts
    assert headers[1]["members"] == list(map(float, members[1]))
    fits = big <= 16364
    assert header_fits("members", [float(m) for m in members[0]]) == fits
    if fits:
        assert headers[0]["members"] == list(map(float, members[0]))
        assert log.lines == []
        # byte for byte what the writer gives with every header
        want = str(tmp_path / "want.hdf")
        write_hdf_stack(want, refs, [
            {"ave_n": c, "members": sorted(float(x) for x in m)}
            for c, m in zip(counts, members)])
        with open(path, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()
    else:
        assert "members" not in headers[0]
        assert len(log.lines) == 1
        assert "group #  0" in log.lines[0] and str(big) in log.lines[0]
