"""The class-sum kernel's plan and order on the CPU
(``ops/classavg.py``): a plain PyTorch emulation of what
``csrc/class_sums.cu`` does with ``sum_plan`` (the slot sort, the chunks,
each chunk's partial sums in sorted order, each slot's partials added in
chunk order) against ``class_sum_oe(transform_batch(...))``, the plan's
cover of the particles, and the CPU route of ``fused_class_sums``.  The
kernel itself runs in ``tests/test_torch_kernel_gpu.py``."""

import bisect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.models.steps import _finish_step
from cryo_ralib_tpu_torch.ops.classavg import (SUM_CHUNK, class_sum_oe,
                                               class_sums_plain,
                                               fused_class_sums, sum_plan)
from cryo_ralib_tpu_torch.ops.transform import transform_batch
from cryo_ralib_tpu_torch.params import params_from_numpy


def _case(n, k, box, seed, mirrors=True, valid=False, odd_start=False,
          outside=False):
    """A random stack and params; ``outside`` puts some ``ref_id`` outside
    [0, K), which ``class_sum_oe`` leaves out."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, k, n)
    if outside:
        ref[rng.random(n) < 0.1] = k
        ref[rng.random(n) < 0.1] = -1
    params = params_from_numpy(
        {"angle": rng.uniform(0, 360, n).astype(np.float32),
         "shift_x": rng.uniform(-2.5, 2.5, n).astype(np.float32),
         "shift_y": rng.uniform(-2.5, 2.5, n).astype(np.float32),
         "mirror": (rng.integers(0, 2, n) if mirrors
                    else np.zeros(n)).astype(np.int32),
         "ref_id": ref.astype(np.int32)}, "cpu")
    images = torch.as_tensor(
        rng.standard_normal((n, box, box)).astype(np.float32))
    gidx = torch.arange(n) + (7 if odd_start else 0)
    mask = (torch.as_tensor((rng.random(n) > 0.2).astype(np.float32))
            if valid else None)
    return images, params, gidx, mask


def emulate(images, params, n_classes, gidx, valid, chunk):
    """What the kernel computes, in its order: block b takes chunk b of
    the plan (the last slot s with ``chunk_start[s] <= b``), adds its
    particles' samples in sorted order, and writes the partial; each
    slot adds its partials in chunk order."""
    n, h, w = images.shape
    plan = sum_plan(params.ref_id, gidx, valid, n_classes, chunk)
    t = transform_batch(images, params).reshape(n, h * w).double()
    cs, ss = plan.chunk_start.tolist(), plan.slot_start.tolist()
    order = plan.order.tolist()
    partial = torch.zeros((plan.n_blocks, h * w), dtype=torch.float64)
    for b in range(cs[-1]):            # blocks past cs[-1] exit
        slot = bisect.bisect_right(cs, b) - 1
        first = ss[slot] + (b - cs[slot]) * chunk
        for i in range(first, min(first + chunk, ss[slot + 1])):
            partial[b] += t[order[i]]
    sums = torch.zeros((2 * n_classes, h * w), dtype=torch.float64)
    for slot in range(2 * n_classes):
        for b in range(cs[slot], cs[slot + 1]):
            sums[slot] += partial[b]
    return sums.reshape(n_classes, 2, h, w), plan.counts


@pytest.mark.parametrize("chunk", [3, SUM_CHUNK])
@pytest.mark.parametrize("valid,mirrors,odd_start", [
    (False, True, False), (True, True, True), (True, False, False)],
    ids=["mirrors", "valid-odd-start", "valid-nomirror"])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_emulated_kernel_order_matches_class_sum_oe(k, valid, mirrors,
                                                    odd_start, chunk):
    images, params, gidx, mask = _case(301, k, 17, seed=k, mirrors=mirrors,
                                       valid=valid, odd_start=odd_start)
    got, counts = emulate(images, params, k, gidx, mask, chunk)
    want, want_counts = class_sum_oe(transform_batch(images, params),
                                     params.ref_id, k, global_index=gidx,
                                     valid=mask)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    assert torch.equal(counts, want_counts)


@pytest.mark.parametrize("n,k,chunk", [(0, 1, 4), (1, 1, 4), (301, 1, 4),
                                       (301, 8, 16), (257, 64, 3),
                                       (1000, 64, SUM_CHUNK)])
def test_the_plan_covers_every_kept_particle_once(n, k, chunk):
    _, params, gidx, mask = _case(n, k, 4, seed=n + k, valid=True,
                                  odd_start=True, outside=True)
    plan = sum_plan(params.ref_id, gidx, mask, k, chunk)
    assert plan.n_blocks == -(-n // chunk) + 2 * k
    cs, ss = plan.chunk_start.tolist(), plan.slot_start.tolist()
    order = plan.order.tolist()
    assert cs[0] == ss[0] == 0 and cs[-1] <= plan.n_blocks
    ref = params.ref_id.long()
    kept = ((ref >= 0) & (ref < k) & (mask != 0)).nonzero().flatten()
    slot_of = ref * 2 + gidx % 2
    covered = []
    for b in range(cs[-1]):
        slot = bisect.bisect_right(cs, b) - 1
        first = ss[slot] + (b - cs[slot]) * chunk
        members = order[first:min(first + chunk, ss[slot + 1])]
        assert 0 < len(members) <= chunk
        assert all(int(slot_of[p]) == slot for p in members)
        assert members == sorted(members)      # the stack's order
        covered += members
    assert sorted(covered) == kept.tolist()
    assert len(covered) == len(set(covered))
    assert torch.equal(plan.counts, torch.bincount(
        ref[kept], minlength=k).int())


def test_fused_class_sums_on_the_cpu_is_the_plain_route():
    images, params, gidx, mask = _case(40, 3, 12, seed=5, valid=True)
    before = fused_class_sums.launches
    got = fused_class_sums(images, params, 3, gidx, mask)
    want = class_sums_plain(images, params, 3, gidx, mask)
    assert fused_class_sums.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    step = _finish_step(images, params, torch.zeros(40), gidx, mask, 3,
                        "plain")
    assert torch.equal(step.class_sums, want[0])
    assert fused_class_sums.launches == before
    with pytest.raises(ValueError, match="no class-sum kernel"):
        fused_class_sums(images.to("meta"), params, 3)
