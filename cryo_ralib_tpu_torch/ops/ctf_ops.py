"""CTF-aware alignment ops: premultiplication and Wiener averaging
(PyTorch).

Counterpart of ``cryo_ralib_tpu/ops/ctf_ops.py`` with a tensor copy of
``cryo_ralib_tpu/analysis/ctf.py::compute_ctf``.  Each particle is
premultiplied by its CTF in Fourier space (``filt_ctf``: phase flip plus
amplitude weighting, which makes the point spread symmetric so that the
rotational search is unbiased), and class averages are Wiener-restored
by dividing the summed spectrum by ``sum(ctf_i^2) + 1/snr``.  The
transforms are ``torch.fft.rfft2`` / ``irfft2`` (the JAX package's are
matmul DFTs, a TPU workaround); the CTF is evaluated on the unshifted
rfft2 frequency grid.

``CtfContext`` computes the CTF in float32, in the JAX package's order
of operations.  The phase argument reaches tens to hundreds of radians,
where one float32 ulp is 4e-6..3e-5, so the two packages' CTFs agree to
a few of those (5.6e-5 measured at 270 rad, tests/test_torch_ctf.py),
and a float64 evaluation is no closer to the float32 reference.

Approximation (standard for 2-D class averaging): the per-particle
ctf^2 sum ignores the in-plane alignment rotation; exact for a CTF
without astigmatism, and averaged out over random orientations else.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import all_reduce_sums, ref_slice, shard_range


def rfft2_freqs(nx: int, apix: float = 1.0) -> np.ndarray:
    """(nx, nx//2+1, 2) spatial-frequency grid (1/A) of the rfft2 layout:
    axis -2 is the full (unshifted) DFT along y, axis -1 the real-FFT
    half along x."""
    fy = np.fft.fftfreq(nx) / apix
    fx = np.fft.rfftfreq(nx) / apix
    gx, gy = np.meshgrid(fx, fy)
    return np.stack([gx, gy], axis=-1)


def compute_ctf(freqs, dfu, dfv, dfang, volt, cs, w, phase_shift=0.0,
                bfactor=None):
    """2-D CTF at the given spatial frequencies, on tensors.

    Args:
      freqs: (M, 2) spatial frequencies (1/A), a tensor; its dtype and
        device are the result's.
      dfu, dfv: defocus U/V (A); dfang: astigmatism angle (deg); scalars,
        or (N,) tensors for a particle axis.
      volt: kV; cs: mm; w: amplitude contrast ratio; phase_shift: deg,
        scalar or (N,); bfactor: envelope B-factor (A^2) or None.
    Returns (M,) for scalar defocus, else (N, M).
    """
    dt, dev = freqs.dtype, freqs.device

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    volt = volt * 1000.0
    cs = cs * 1e7
    dfu, dfv = t(dfu), t(dfv)
    dfang = t(dfang) * (math.pi / 180.0)
    phase_shift = t(phase_shift) * (math.pi / 180.0)
    lam = 12.2639 / math.sqrt(volt + 0.97845e-6 * volt ** 2)
    x = freqs[:, 0]
    y = freqs[:, 1]
    ang = torch.atan2(y, x)
    s2 = x ** 2 + y ** 2
    if max(a.ndim for a in (dfu, dfv, dfang, phase_shift)):
        dfu = dfu.reshape(-1, 1)
        dfv = dfv.reshape(-1, 1)
        dfang = dfang.reshape(-1, 1)
        if phase_shift.ndim:
            phase_shift = phase_shift.reshape(-1, 1)
        ang = ang[None, :]
        s2 = s2[None, :]
    df = 0.5 * (dfu + dfv + (dfu - dfv) * torch.cos(2.0 * (ang - dfang)))
    gamma = (2.0 * math.pi * (-0.5 * df * lam * s2
                              + 0.25 * cs * lam ** 3 * s2 ** 2) - phase_shift)
    ctf = math.sqrt(1.0 - w ** 2) * torch.sin(gamma) - w * torch.cos(gamma)
    if bfactor is not None:
        ctf = ctf * torch.exp(-bfactor / 4.0 * s2)
    return ctf


def ctf_rfft2(nx: int, apix, dfu, dfv, dfang, voltage=300.0, cs=2.7,
              w=0.1, phase_shift=0.0, bfactor=None, device="cpu"):
    """Per-particle 2-D CTF on the rfft2 grid: (N, nx, nx//2+1) float32
    for (N,) defocus, (nx, nx//2+1) for scalar defocus; evaluated in
    float64, as the reference's numpy default (``CtfContext`` evaluates
    in float32)."""
    freqs = torch.as_tensor(rfft2_freqs(nx, apix).reshape(-1, 2),
                            dtype=torch.float64, device=device)
    ctf = compute_ctf(freqs, dfu, dfv, dfang, voltage, cs, w,
                      phase_shift=phase_shift, bfactor=bfactor)
    return ctf.reshape(ctf.shape[:-1] + (nx, nx // 2 + 1)).float()


def filt_ctf(images, ctf):
    """Premultiply real images by their CTFs in Fourier space:
    (N, H, W) x (N, H, Fw) -> (N, H, W)."""
    h, w = images.shape[-2:]
    return torch.fft.irfft2(torch.fft.rfft2(images) * ctf, s=(h, w))


def class_ctf2_sum(ctf, ref_id, n_classes: int):
    """Per-class sum of ctf^2: (N, H, Fw), (N,) -> (K, H, Fw).  A class id
    outside 0..K-1 adds nothing.  No even/odd split: Wiener restores the
    combined average."""
    k = n_classes
    rid = ref_id.long()
    inside = (rid >= 0) & (rid < k)
    out = torch.zeros((k + 1,) + ctf.shape[1:], dtype=ctf.dtype,
                      device=ctf.device)
    out.index_add_(0, torch.where(inside, rid, k), ctf * ctf)
    return out[:k]


def wiener_restore(summed, ctf2_sum, snr: float):
    """Wiener-restore summed class averages: divide the spectrum by
    ``sum(ctf^2) + 1/snr``.  summed: (..., H, W); ctf2_sum: (..., H, Fw)."""
    h, w = summed.shape[-2:]
    spec = torch.fft.rfft2(summed) / (ctf2_sum + 1.0 / float(snr))
    return torch.fft.irfft2(spec, s=(h, w))


class CtfContext:
    """CTF state of one alignment run: the per-particle defocus table on the
    device, premultiplication and per-class Wiener restoration.

    Built once per run from ``ctf_params`` (``dfu`` per particle at
    least; ``dfv``, ``dfang``, ``phase_shift`` per particle or scalar;
    scalars ``apix``, ``voltage``, ``cs``, ``w``, ``bfactor``).  Only the
    defocus rows are kept; the (batch, H, Fw) CTFs are made per chunk, so
    device memory stays O(batch * H * Fw).

    Under a ``mesh`` (``parallel/mesh.py``) ``ctf_params`` still holds the
    whole stack's rows, and the context keeps the rank's block: ``n`` is
    the block's size, ``start`` its first global index and ``n_total``
    the stack's; ``ctf_chunk`` and ``premultiply_block`` count from the
    block's start, and ``restore`` all-reduces the per-class ctf^2 sums
    before the Wiener division.  On a 2-D mesh the ranks of a ref group
    hold the same block and each sums the ctf^2 of its share of it
    (``ref_slice``), so every particle counts once, as in the class sums.
    """

    def __init__(self, nx: int, ctf_params: dict, snr: float = 1.0,
                 batch: int = 2048, device="cpu", mesh=None):
        p = dict(ctf_params)
        dfu = np.atleast_1d(np.asarray(p.pop("dfu"), np.float64))
        dfv = np.atleast_1d(np.asarray(p.pop("dfv", dfu), np.float64))
        dfang = np.atleast_1d(np.asarray(p.pop("dfang", 0.0), np.float64))
        phase = np.atleast_1d(np.asarray(p.pop("phase_shift", 0.0),
                                         np.float64))
        n_total = max(dfu.size, dfv.size, dfang.size, phase.size)
        df = np.stack([np.broadcast_to(a, (n_total,)) for a in
                       (dfu, dfv, dfang, phase)], axis=1)      # (N, 4)
        start, stop = shard_range(n_total, mesh)
        self.mesh = mesh
        self.device = torch.device(device)
        self.df = torch.as_tensor(df[start:stop].astype(np.float32),
                                  device=self.device)
        self.snr = float(snr)
        self.nx = nx
        self.n = stop - start
        self.start = start
        self.n_total = n_total
        self.batch = max(1, min(batch, self.n))
        self.scalars = dict(apix=p.pop("apix", 1.0),
                            voltage=p.pop("voltage", 300.0),
                            cs=p.pop("cs", 2.7), w=p.pop("w", 0.1),
                            bfactor=p.pop("bfactor", None))
        if p:
            raise ValueError(f"unknown ctf_params keys: {sorted(p)}")
        flat = rfft2_freqs(nx, self.scalars["apix"]).reshape(-1, 2)
        self._freqs = torch.as_tensor(flat.astype(np.float32),
                                      device=self.device)

    def ctf_chunk(self, start: int, count: int | None = None):
        """(b, H, Fw) float32 CTFs of the particles ``start ..
        start+count-1`` (``count`` defaults to ``batch``)."""
        count = self.batch if count is None else count
        df = self.df[start:start + count]
        sc = self.scalars
        ctf = compute_ctf(self._freqs, df[:, 0], df[:, 1], df[:, 2],
                          sc["voltage"], sc["cs"], sc["w"],
                          phase_shift=df[:, 3], bfactor=sc["bfactor"])
        return ctf.reshape(-1, self.nx, self.nx // 2 + 1)

    def premultiply_block(self, block, start: int):
        """``filt_ctf`` of the particles ``start .. start+len(block)-1``,
        a block on the device."""
        return filt_ctf(block, self.ctf_chunk(start, block.shape[0]))

    def premultiply(self, images):
        """``filt_ctf`` over the stack, chunk by chunk on the device, into
        a new tensor there; ``images`` (numpy or a tensor, on the host or
        the device) is uploaded a chunk at a time."""
        if images.shape[0] != self.n:
            raise ValueError(f"{images.shape[0]} images vs {self.n} CTFs")
        out = torch.empty(tuple(images.shape), dtype=torch.float32,
                          device=self.device)
        for i in range(0, self.n, self.batch):
            block = torch.as_tensor(images[i:i + self.batch],
                                    dtype=torch.float32, device=self.device)
            out[i:i + self.batch] = self.premultiply_block(block, i)
        return out

    def restore(self, summed, assign=None):
        """Wiener-restore per-class summed averages.

        summed: (K, H, W) summed (even + odd, unnormalised) class images,
        numpy or tensor; assign: (N,) class ids of the whole stack (None:
        every particle in class 0).  Returns a (K, H, W) float32 numpy
        array.  Under a mesh every rank calls it (a collective).
        """
        summed = torch.as_tensor(np.asarray(summed, np.float32)
                                 if not torch.is_tensor(summed) else summed,
                                 dtype=torch.float32, device=self.device)
        k = summed.shape[0]
        if assign is None:
            rid = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        else:
            rid = torch.as_tensor(np.asarray(assign, np.int64)
                                  if not torch.is_tensor(assign) else assign,
                                  device=self.device)
            if rid.shape[0] != self.n_total:
                raise ValueError(f"{rid.shape[0]} class ids for a stack of "
                                 f"{self.n_total}")
            rid = rid[self.start:self.start + self.n]
        ctf2 = torch.zeros((k, self.nx, self.nx // 2 + 1),
                           dtype=torch.float32, device=self.device)
        a, b = ref_slice(self.n, self.mesh)
        for i in range(a, b, self.batch):
            m = min(self.batch, b - i)
            ctf2 += class_ctf2_sum(self.ctf_chunk(i, m), rid[i:i + m], k)
        all_reduce_sums(self.mesh, ctf2)
        return wiener_restore(summed, ctf2, self.snr).cpu().numpy()
