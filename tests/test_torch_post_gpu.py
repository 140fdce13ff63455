"""The post-alignment path on the GPU: ``rot_shift2d`` on the card
against the port on the CPU, by blocks and in one call; ``MPCA`` /
``TwoSDR`` on the card against the CPU; ``HDFfile.aligned_particles``
and the export example on the card against each other.

These tests need an NVIDIA GPU; elsewhere they skip.  They import no
JAX, so on the GPU machine they run with::

    python -m pytest --noconftest -m cuda tests/test_torch_post_gpu.py

Tolerances: ``rot_shift2d`` within 1e-4 of the CPU (its CPU test's
tolerance against JAX, tests/test_torch_rot_shift.py; the card takes
cos and sin in f64 as the CPU does, so most pixels are bitwise equal);
the blocked call bitwise equal to one call; the reduction as
tests/test_torch_analysis.py holds it against JAX: means within 1e-5,
each column's overlap within 1e-3 of 1, factors within 1e-3 of the
largest after the sign of each column is aligned.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.analysis import MPCA, TwoSDR
from cryo_ralib_tpu_torch.io.dataset import HDFfile
from cryo_ralib_tpu_torch.io.mrc import write_mrc
from cryo_ralib_tpu_torch.io.star import write_text_row
from cryo_ralib_tpu_torch.ops import transform
from cryo_ralib_tpu_torch.ops.transform import rot_shift2d

pytestmark = pytest.mark.cuda

NX = 90


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _params(n, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-360, 720, n).astype(np.float32)
    ang[:6] = [0, 90, 180, 270, 720, -90]
    sx = rng.uniform(-4, 4, n).astype(np.float32)
    sx[:4] = [NX, -NX, NX + 0.5, 2 * NX]
    sy = np.roll(sx, 2)
    mirror = rng.integers(0, 2, n).astype(np.int32)
    scale = rng.uniform(0.8, 1.2, n).astype(np.float32)
    scale[:3] = 0.0
    return ang, sx, sy, mirror, scale


def test_rot_shift2d_card_matches_cpu(cuda_device, monkeypatch):
    n = 512
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((n, NX, NX)).astype(np.float32)
    cols = _params(n, 6)
    want = rot_shift2d(torch.as_tensor(imgs), *cols[:3], mirror=cols[3],
                       scale=cols[4]).numpy()
    args = [torch.as_tensor(v, device=cuda_device) for v in (imgs,) + cols]
    got = rot_shift2d(*args[:4], mirror=args[4], scale=args[5])
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=1e-4)
    monkeypatch.setattr(transform, "transform_block", lambda h, w: 100)
    blocked = rot_shift2d(*args[:4], mirror=args[4], scale=args[5])
    assert torch.equal(blocked, got)


def _separated(n, nx, comps, seed):
    """A stack whose leading eigenvalues lie apart (weights 0.8^k), so
    that eigenvectors are defined up to sign on any device."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((nx, comps)))[0]
    v = np.linalg.qr(rng.standard_normal((nx, comps)))[0]
    coef = rng.standard_normal((n, comps)) * 0.8 ** np.arange(comps)
    arr = np.einsum("nk,pk,qk->npq", coef, u, v)
    arr += 1e-3 * rng.standard_normal((n, nx, nx))
    return arr.astype(np.float32)


def _assert_agree(got, want, kron_signs=False):
    *mats, mean = got
    *mats_c, mean_c = want
    np.testing.assert_allclose(mean, mean_c, rtol=0, atol=1e-5)
    bases = list(zip(mats[1:], mats_c[1:]))
    if kron_signs:   # TwoSDR: Gt's rows follow At's and Bt's column signs
        sa = np.sign(np.diag(bases[1][0].T @ bases[1][1]))
        sb = np.sign(np.diag(bases[2][0].T @ bases[2][1]))
        bases[0] = (np.kron(sa, sb)[:, None] * bases[0][0], bases[0][1])
    for a, b in bases:
        np.testing.assert_allclose(np.abs(np.diag(a.T @ b)), 1.0, atol=1e-3)
    f, fc = mats[0], mats_c[0]
    sign = np.sign((f * fc).sum(0))
    np.testing.assert_allclose(f * sign, fc, rtol=0,
                               atol=1e-3 * np.abs(fc).max())


def test_reduction_card_matches_cpu(cuda_device):
    arr = _separated(1024, NX, 24, seed=31)
    got = MPCA(arr, 10, 10, device=cuda_device)
    assert all(isinstance(x, np.ndarray) for x in got)
    _assert_agree(got, MPCA(arr, 10, 10, device="cpu"))
    _assert_agree(TwoSDR(arr, 20, 20, 8, device=cuda_device),
                  TwoSDR(arr, 20, 20, 8, device="cpu"), kron_signs=True)


def test_hdffile_and_export_on_the_card(cuda_device, tmp_path):
    """``HDFfile.aligned_particles`` on the card is bitwise the export
    example's stack and within 1e-4 of the CPU's."""
    import importlib.util

    n = 300
    rng = np.random.default_rng(9)
    imgs = rng.standard_normal((n, NX, NX)).astype(np.float32)
    ang, sx, sy, mirror, _ = _params(n, 10)
    cls = rng.integers(0, 4, n)
    table = np.column_stack([np.arange(n), ang, sx, sy, mirror, cls])
    write_text_row(table, str(tmp_path / "params.txt"))
    write_mrc(str(tmp_path / "stack.mrcs"), imgs)
    ds = HDFfile.load(str(tmp_path / "stack.mrcs"), str(tmp_path / "params.txt"))
    card = ds.aligned_particles()
    np.testing.assert_allclose(card, ds.aligned_particles(device="cpu"),
                               rtol=0, atol=1e-4)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_08_export_aligned.py")
    spec = importlib.util.spec_from_file_location("torch_08", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    _, avg_path, aligned = ex.export_aligned(
        imgs, *ex.load_params(str(tmp_path / "params.txt")),
        str(tmp_path / "out"))
    assert avg_path is not None
    np.testing.assert_array_equal(aligned, card)
