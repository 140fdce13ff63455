"""The plain reference agrees with the port at a tiny size on the CPU
(the port's own plain search, decode, transform, sums and host
update), so that the reference the check runs computes the function the
port computes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import BIG_SEED

import gen
import reference as R
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.user_functions import ref_ali2d
from cryo_ralib_tpu_torch.ops.classavg import class_sum_oe
from cryo_ralib_tpu_torch.ops.fsc import fsc, fsc_mask
from cryo_ralib_tpu_torch.ops.filters import fshift
from cryo_ralib_tpu_torch.ops.masks import model_circle, normalize_mask
from cryo_ralib_tpu_torch.ops.search import (decode_params,
                                             prepare_ref_spectra,
                                             rotational_shift_search,
                                             rotational_shift_search_shc)
from cryo_ralib_tpu_torch.ops.transform import transform_batch
from cryo_ralib_tpu_torch.params import AlignParams

NX, OU, XR = 32, 12, 1


@pytest.fixture(scope="module")
def case():
    tmpl = torch.as_tensor(gen.templates(3, NX))
    imgs = gen.stack(tmpl, BIG_SEED, 0, 96, "cpu")
    mask = torch.as_tensor(model_circle(OU, NX))
    imgs = normalize_mask(imgs, mask)
    refs = normalize_mask(tmpl, mask, no_sigma=True)
    rng = np.random.default_rng(5)
    prev = AlignParams(
        torch.as_tensor(rng.uniform(0, 360, 96).astype(np.float32)),
        torch.as_tensor(rng.choice([0.0, 1.0, -1.0, 0.5], 96)
                        .astype(np.float32)),
        torch.as_tensor(rng.choice([0.0, -1.0, 0.25], 96).astype(np.float32)),
        torch.zeros(96, dtype=torch.int32), torch.zeros(96, dtype=torch.int32))
    cfg = AlignConfig(img_dim=NX, ring_num=OU, shift_rng_x=XR,
                      shift_rng_y=XR)
    geo = R.Geometry(NX, OU, XR, XR, 1.0)
    return imgs, refs, prev, cfg, geo


def test_geometry_is_the_configs(case):
    *_, cfg, geo = case
    assert torch.equal(geo.coords, torch.as_tensor(cfg.polar_coords))
    assert torch.equal(geo.shifts, torch.as_tensor(cfg.shifts))
    assert torch.equal(geo.weights, torch.as_tensor(cfg.ring_weights))
    assert geo.limit == cfg.shift_limit


def test_search_winners_rows_and_decode(case):
    imgs, refs, prev, cfg, geo = case
    port = rotational_shift_search(imgs, prepare_ref_spectra(refs, cfg),
                                   prev, cfg)
    rows = R.all_rows(imgs, refs, prev.shift_x, prev.shift_y, geo)
    m, s, k, a = R.argmax_pick(rows)
    assert torch.equal(m.int(), port.best_mirror)
    assert torch.equal(s.int(), port.best_sidx)
    assert torch.equal(k.int(), port.best_ref)
    assert torch.equal(a.int(), port.best_aidx)
    row = rows[torch.arange(len(m)), m, s, k]
    assert torch.allclose(row, port.best_row, rtol=0, atol=1e-5)
    want = decode_params(port, prev, cfg)
    ang, sx, sy = R.decode(port.best_row, port.best_aidx, port.best_sidx,
                           port.best_mirror, prev.shift_x, prev.shift_y, geo)
    assert torch.equal(ang, want.angle)
    assert torch.equal(sx, want.shift_x) and torch.equal(sy, want.shift_y)


def test_shc_pick(case):
    imgs, refs, prev, cfg, geo = case
    rows = R.all_rows(imgs, refs, prev.shift_x, prev.shift_y, geo)
    pm = rows.amax(-1).reshape(len(imgs), -1).amax(1) * torch.linspace(
        0.2, 1.01, len(imgs))
    port, found = rotational_shift_search_shc(
        imgs, prepare_ref_spectra(refs, cfg), prev, cfg, pm)
    f, m, s, k, a = R.shc_pick(rows, pm)
    assert torch.equal(f, found) and not bool(found.all())
    for mine, theirs in ((m, port.best_mirror), (s, port.best_sidx),
                         (k, port.best_ref), (a, port.best_aidx)):
        assert torch.equal(mine[f].int(), theirs[f])


def test_transform_and_class_sums(case):
    imgs, _refs, prev, *_ = case
    ref_id = torch.arange(len(imgs), dtype=torch.int32) % 3
    p = prev._replace(ref_id=ref_id,
                      mirror=(torch.arange(len(imgs)) % 2).int())
    t = R.transform(imgs, p.angle, p.shift_x, p.shift_y, p.mirror)
    assert torch.equal(t, transform_batch(imgs, p))
    sums, counts = R.class_sums(imgs, p.angle, p.shift_x, p.shift_y,
                                p.mirror, p.ref_id, 3, block=32)
    want, wc = class_sum_oe(transform_batch(imgs, p), p.ref_id, 3)
    assert torch.allclose(sums, want, rtol=0, atol=1e-9)
    assert torch.equal(counts, wc.long())


def test_host_update(case):
    imgs, refs, *_ = case
    mask = R.disc(OU, NX)
    sums = torch.stack([imgs[0::2].double().sum(0),
                        imgs[1::2].double().sum(0)])[None].float().numpy()
    f1, v1 = R.fsc(sums[0, 0], sums[0, 1])
    f2, v2, _ = fsc(sums[0, 0], sums[0, 1])
    assert np.allclose(f1, f2) and np.allclose(v1, v2, atol=1e-12)
    fm, vm, _ = fsc_mask(sums[0, 0], sums[0, 1], mask)
    avg = ((sums[0, 0] + sums[0, 1]) / len(imgs)).astype(np.float32)
    filt, _ = ref_ali2d([mask, 0, avg, (fm, vm)])
    want = fshift(torch.as_tensor(filt), -0.3, 0.2).numpy()
    got = R.reffree_average(sums, len(imgs), 0.3 * len(imgs),
                            -0.2 * len(imgs), mask)
    assert np.allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0,
                      1.0 + 2 ** -12], dtype=torch.float32)
    y = R.tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -9, -3.0, 1.0]
    z = torch.complex(x, -x)
    assert torch.equal(torch.view_as_real(R.tf32(z))[:, 0], y)
