"""The device loops and the command line on the GPU.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.
They import no JAX, so on the GPU machine they run with::

    python -m pytest --noconftest -m cuda tests/test_torch_loop_gpu.py

Tolerances: the loops through the kernel and through the plain search
give the same ref_id, mirror and shifts, angles within 1e-3 degree and
references / average within 1e-4 of their largest value (the kernel's
16 x 16 FFTs against cuFFT, both f32, over three iterations).  The
multireference case uses ``unit_sigma_blobs`` templates: with
``asymmetric_templates(8, 90)`` the two mirror channels' peaks of a few
of these particles near-tie, so that f32 rounding alone flipped a mirror
flag between the kernel's loop and the plain one.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import make_device_loop, make_mref_device_loop
from cryo_ralib_tpu_torch.ops import fused_search as fs
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack,
                                                  unit_sigma_blobs)

NX, N, N_ITER = 90, 512, 3


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _case(mref, dev):
    k = 8 if mref else 1
    cfg = AlignConfig(img_dim=NX, ring_num=36, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    tmpl = (unit_sigma_blobs(k, NX, seed=8) if mref
            else asymmetric_templates(k, NX))
    imgs = scattered_stack(tmpl, N, max_shift=2, noise=0.3, seed=17,
                           device=dev)[0].contiguous()
    refs0 = torch.as_tensor(tmpl, device=dev) if mref else imgs.mean(0)
    make = ((lambda s: make_mref_device_loop(cfg, N_ITER, k,
                                             np.full(N_ITER, 0.25),
                                             device=dev, sampler=s))
            if mref else
            (lambda s: make_device_loop(cfg, N_ITER, np.full(N_ITER, 0.25),
                                        device=dev, sampler=s)))
    args = (imgs, refs0, AlignParams.zeros(N, dev), torch.arange(N,
                                                                 device=dev),
            torch.ones(N, device=dev))
    return make, args


@pytest.mark.cuda
@pytest.mark.parametrize("mref", [False, True], ids=["reffree", "mref"])
def test_loop_kernel_matches_plain(cuda_device, mref):
    make, args = _case(mref, cuda_device)
    before = fs.fused_search.launches["search"]
    p_k, out_k = make("kernel")(*args)
    assert fs.fused_search.launches["search"] == before + N_ITER
    p_p, out_p = make("plain")(*args)
    torch.cuda.synchronize()
    for f in ("ref_id", "mirror", "shift_x", "shift_y"):
        assert torch.equal(getattr(p_k, f), getattr(p_p, f)), f
    d = (p_k.angle - p_p.angle).abs()
    assert float(torch.minimum(d, 360.0 - d).max()) < 1e-3
    assert bool(torch.isfinite(out_k).all())
    torch.testing.assert_close(out_k, out_p, rtol=0,
                               atol=1e-4 * float(out_p.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("mref", [False, True], ids=["reffree", "mref"])
def test_loop_makes_no_host_sync(cuda_device, mref):
    """After a first call, a loop call runs under
    ``set_sync_debug_mode("error")``: nothing in it waits for the card."""
    make, args = _case(mref, cuda_device)
    run = make("auto")
    run(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, out = run(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert bool(torch.isfinite(params.angle).all())


@pytest.mark.cuda
def test_cli_on_the_gpu_needs_no_h5py(cuda_device, tmp_path, monkeypatch):
    """``cli.mref`` on .mrcs input writes its .hdf outputs, and they read
    back, with h5py made unimportable."""
    import sys

    from cryo_ralib_tpu_torch.cli import mref as cli_mref
    from cryo_ralib_tpu_torch.io.eman_hdf import read_hdf_stack
    from cryo_ralib_tpu_torch.io.mrc import write_mrc

    monkeypatch.setitem(sys.modules, "h5py", None)
    tmpl = asymmetric_templates(4, 64)
    imgs, cls = scattered_stack(tmpl, 256, max_shift=1, noise=0.3, seed=3,
                                device=cuda_device)[:2]
    stack, refs = str(tmp_path / "s.mrcs"), str(tmp_path / "r.mrcs")
    write_mrc(stack, imgs.cpu().numpy())
    write_mrc(refs, tmpl)
    out = str(tmp_path / "out")
    before = fs.fused_search.launches["search"]
    # one process (the default, 0, is every visible card)
    assert cli_mref.main([stack, refs, out, "--ou=24", "--xr=1", "--ts=1",
                          "--maxit=2", "--devices=1"]) == 0
    assert fs.fused_search.launches["search"] == before + 2
    got, headers = read_hdf_stack(os.path.join(out, "aqm001.hdf"))
    assert got.shape == (4, 64, 64) and np.isfinite(got).all()
    assert sum(h["ave_n"] for h in headers) == 256
    members = sorted(m for h in headers for m in h["members"])
    assert members == list(range(256))
