"""A RELION project on the PyTorch/CUDA port: .mrcs stack + particles
.star -> mref.

The port's counterpart of ``examples/05_relion_ingest.py``: builds a
format-realistic RELION-style project (an MRC stack with a 1024-byte
header, mode 2, apix in cella; a particles STAR file with
``index@stack.mrcs`` image names, optics values and per-particle
astigmatic defocus and Volta phase shifts) and ingests it as a user
would:

1. ``Starfile.load`` and ``get_particles`` resolve ``_rlnImageName``
   into the .mrcs through ``LazyImage`` offsets;
2. ``parse_ctf_star`` derives apix from DetectorPixelSize/Magnification
   and collects the per-particle CTF rows;
3. ``mref_ali2d`` aligns with ``--CTF`` semantics (premultiply and
   Wiener restore).

    python examples/torch_05_relion_ingest.py [outdir]          # on the GPU
    python examples/torch_05_relion_ingest.py --device=cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from cryo_ralib_tpu_torch.models.engine import resolve_device


def build_project(outdir: str, n: int = 48, nx: int = 64, k: int = 3,
                  apix: float = 1.34, seed: int = 11):
    """Write a format-realistic RELION-style project directory.

    Returns (star_path, mrcs_path, true_class, templates).
    """
    from cryo_ralib_tpu_torch.analysis.ctf import compute_ctf
    from cryo_ralib_tpu_torch.io.mrc import write_mrc
    from cryo_ralib_tpu_torch.io.star import Starfile, Table
    from cryo_ralib_tpu_torch.ops.ctf_ops import rfft2_freqs
    from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                      scattered_stack)

    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)
    templates = asymmetric_templates(k, nx)
    images, cls = scattered_stack(templates, n, max_shift=2, seed=seed)[:2]

    # the acquisition: a defocus series with astigmatism and Volta phase
    # shifts, the CTF applied in Fourier space (what the scope does),
    # then noise
    dfu = rng.uniform(8000.0, 26000.0, n)
    dfv = dfu - rng.uniform(0.0, 800.0, n)
    dfang = rng.uniform(0.0, 180.0, n)
    phase = rng.uniform(0.0, 90.0, n)
    freqs = rfft2_freqs(nx, apix).reshape(-1, 2)
    ctf = compute_ctf(freqs, dfu, dfv, dfang, 300.0, 2.7, 0.1,
                      phase_shift=phase).reshape(n, nx, nx // 2 + 1)
    data = np.fft.irfft2(np.fft.rfft2(images.numpy()) * ctf, s=(nx, nx))
    data = (data + rng.normal(0.0, 0.15, data.shape)).astype(np.float32)

    mrcs_path = os.path.join(outdir, "particles.mrcs")
    write_mrc(mrcs_path, data, apix=apix)

    # particles STAR: 1-based index@file image names, optics via
    # DetectorPixelSize/Magnification (apix = 1e4 * dps / mag)
    mag = 10000.0
    dps = apix * mag / 1.0e4
    headers = ["_rlnImageName", "_rlnDefocusU", "_rlnDefocusV",
               "_rlnDefocusAngle", "_rlnVoltage", "_rlnSphericalAberration",
               "_rlnAmplitudeContrast", "_rlnPhaseShift",
               "_rlnDetectorPixelSize", "_rlnMagnification"]
    cols = {
        "_rlnImageName": np.array(
            [f"{i + 1:06d}@particles.mrcs" for i in range(n)], object),
        "_rlnDefocusU": np.array([f"{v:.1f}" for v in dfu], object),
        "_rlnDefocusV": np.array([f"{v:.1f}" for v in dfv], object),
        "_rlnDefocusAngle": np.array([f"{v:.2f}" for v in dfang], object),
        "_rlnVoltage": np.array(["300.0"] * n, object),
        "_rlnSphericalAberration": np.array(["2.7"] * n, object),
        "_rlnAmplitudeContrast": np.array(["0.1"] * n, object),
        "_rlnPhaseShift": np.array([f"{v:.2f}" for v in phase], object),
        "_rlnDetectorPixelSize": np.array([f"{dps:.4f}"] * n, object),
        "_rlnMagnification": np.array([f"{mag:.1f}"] * n, object),
    }
    star = Starfile(headers, Table(headers, cols))
    star_path = os.path.join(outdir, "particles.star")
    star.write(star_path)
    return star_path, mrcs_path, cls, templates


def ingest_and_align(star_path: str, outdir: str, device, k: int = 3,
                     sampler: str = "auto"):
    """The user's flow: STAR -> stack + CTF rows -> mref with CTF."""
    from cryo_ralib_tpu_torch.io.star import Starfile, parse_ctf_star
    from cryo_ralib_tpu_torch.models.mref import mref_ali2d
    from cryo_ralib_tpu_torch.utils.log import RunLogger

    star = Starfile.load(star_path)
    data = np.stack(star.get_particles(
        datadir=os.path.dirname(star_path), lazy=False))
    rows = parse_ctf_star(star.df, d=data.shape[1], angpix=None)
    apix = float(rows[0, 1])
    ctf_params = dict(dfu=rows[:, 2], dfv=rows[:, 3], dfang=rows[:, 4],
                      apix=apix, voltage=float(rows[0, 5]),
                      cs=float(rows[0, 6]), w=float(rows[0, 7]),
                      phase_shift=rows[:, 8])

    rng = np.random.default_rng(0)
    n, nx = data.shape[0], data.shape[1]
    refs = data[rng.choice(n, k, replace=False)].copy()
    res = mref_ali2d(
        data, refs, outdir=os.path.join(outdir, "mref"),
        ou=nx // 2 - 4, xr=2.0, yr=2.0, ts=1.0, maxit=4,
        CTF=True, ctf_params=ctf_params, snr=0.5, device=device,
        sampler=sampler, log=RunLogger(None, quiet=True))
    return res, apix


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("outdir", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sampler", default="auto",
                   choices=["auto", "kernel", "plain", "template", "matmul"])
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    outdir = args.outdir or tempfile.mkdtemp(prefix="torch_relion_ingest_")
    star_path, mrcs_path, cls, _templates = build_project(outdir)
    print(f"wrote {mrcs_path} + {star_path}")
    res, apix = ingest_and_align(star_path, outdir, dev,
                                 sampler=args.sampler)
    print(f"apix from STAR optics: {apix:.3f} A")
    print(f"aligned {res.params.shape[0]} particles on {dev}, "
          f"final counts: {res.class_counts}")
    print(f"artifacts in {os.path.join(outdir, 'mref')}")
    return res, apix, cls


if __name__ == "__main__":
    main()
