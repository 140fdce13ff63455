"""Streaming on the GPU: the engine and ``mref_ali2d`` streamed in
batches of 1000 (an odd remainder) against the resident run, and the
CPU copy of the kernel's launch plan against the built kernel's.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.
They import no JAX, so on the GPU machine they run with::

    python -m pytest --noconftest -m cuda tests/test_torch_streaming_gpu.py

Tolerances: the first iteration runs the kernel on the same inputs
against the same references in both modes, so its params are equal bit
for bit; the class sums within 5e-4 of their largest value (the batches
add up in another order); after that ref_id and mirror equal, angles
within 1e-3 degree and shifts within 1e-3 (the references differ by that
rounding).
"""

import warnings
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models.engine import AlignmentEngine
from cryo_ralib_tpu_torch.models.mref import mref_ali2d
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.ops.masks import model_circle, normalize_mask
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (scattered_stack,
                                                  unit_sigma_blobs)

NX, N, K, BATCH = 90, 4096, 8, 1000


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _cfg():
    return AlignConfig(img_dim=NX, ring_num=36, shift_step=1.0,
                       shift_rng_x=3.0, shift_rng_y=3.0)


def _stack(dev):
    tmpl = unit_sigma_blobs(K, NX, seed=8)
    imgs = scattered_stack(tmpl, N, max_shift=2, noise=0.3, seed=17,
                           device=dev)[0]
    mask = torch.as_tensor(model_circle(36, NX), device=dev)
    return normalize_mask(imgs, mask).contiguous(), tmpl


def _assert_close_params(a, b):
    for f in ("ref_id", "mirror"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    d = np.abs(a.angle - b.angle)
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    np.testing.assert_allclose(a.shift_x, b.shift_x, atol=1e-3)
    np.testing.assert_allclose(a.shift_y, b.shift_y, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [0.0, 15.0], ids=["default", "dst"])
def test_engine_streamed_equals_resident(cuda_device, delta):
    imgs, tmpl = _stack(cuda_device)
    variant = "search_masked" if delta else "search"
    runs = {}
    for name, bs in (("resident", None), ("streamed", BATCH)):
        eng = AlignmentEngine(imgs, _cfg(), n_classes=K, device=cuda_device,
                              batch_size=bs, delta=delta)
        assert eng.resident == (bs is None)
        outs, params = [], []
        for it in range(2):
            before = fs.fused_search.launches[variant]
            outs.append(eng.iterate(tmpl, discrete=bool(delta) and it == 0))
            if it == 0:
                want = 1 if bs is None else -(-N // BATCH)
                assert fs.fused_search.launches[variant] == before + want
            params.append(eng.params_np())
        runs[name] = outs, params
    (o_r, p_r), (o_s, p_s) = runs["resident"], runs["streamed"]
    for f in p_r[0]._fields:
        np.testing.assert_array_equal(getattr(p_s[0], f),
                                      getattr(p_r[0], f), err_msg=f)
    np.testing.assert_array_equal(o_s[0].peak, o_r[0].peak)
    for a, b in zip(o_s, o_r):
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_allclose(a.class_sums, b.class_sums, rtol=0,
                                   atol=5e-4 * np.abs(b.class_sums).max())
    _assert_close_params(p_s[1], p_r[1])


@pytest.mark.cuda
def test_mref_streamed_equals_resident(cuda_device):
    imgs, tmpl = _stack(cuda_device)
    host = imgs.cpu().numpy()
    kw = dict(ou=36, xr=3, yr=3, ts=1, maxit=2, device=cuda_device,
              log=RunLogger(None, quiet=True))
    res_r = mref_ali2d(host, tmpl, **kw)
    res_s = mref_ali2d(host, tmpl, batch_size=BATCH, **kw)
    np.testing.assert_array_equal(res_s.assignments, res_r.assignments)
    np.testing.assert_array_equal(res_s.class_counts, res_r.class_counts)
    np.testing.assert_array_equal(res_s.params[:, 3], res_r.params[:, 3])
    d = np.abs(res_s.params[:, 0] - res_r.params[:, 0])
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    np.testing.assert_allclose(res_s.params[:, 1:3], res_r.params[:, 1:3],
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(90, 36, 49), (160, 48, 25),
                                  (256, 100, 25)])
def test_plan_model_equals_the_kernel_plan(cuda_device, geom):
    nx, rings, shifts = geom
    limit = fs.device_smem_limit(cuda_device)
    for mirror in (True, False):
        for k in (1, 4, 8, 64):
            assert (fs.plan_model(rings, mirror, k, shifts, nx, nx, limit)
                    == fs.kernel_plan(rings, mirror, k, shifts, nx, nx))


@pytest.mark.cuda
def test_streamed_iteration_waits_once(cuda_device):
    """The host waits for the card a few times per streamed iteration
    (the reference upload and the reads at its end), whatever the number
    of batches: nothing inside the batch loop synchronises.  Under
    ``set_sync_debug_mode("warn")`` every synchronising call warns from
    its line, so a wait per batch would repeat one line once per batch."""
    imgs, tmpl = _stack(cuda_device)
    for bs in (1000, 250):          # 5 and 17 batches
        eng = AlignmentEngine(imgs, _cfg(), n_classes=K, device=cuda_device,
                              batch_size=bs)
        eng.iterate(tmpl)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.iterate(tmpl)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        where = Counter((w.filename, w.lineno) for w in seen
                        if "synchroniz" in str(w.message))
        assert sum(where.values()) <= 12, (bs, where)
        assert max(where.values(), default=0) < -(-N // bs), (bs, where)
