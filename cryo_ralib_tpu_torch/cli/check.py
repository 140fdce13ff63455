"""Environment check of the PyTorch/CUDA port (counterpart of
``cryo_ralib_tpu/cli/check.py``).

Checks and reports: torch and the CUDA version it was built for, the
visible GPU, its name and power limit (``nvidia-smi``), ``nvcc``, the
search kernel's build, one small kernel launch held against the plain
search, and the optional h5py (``.hdf`` inputs) and scipy.  Exits 1 when
a required check fails, so a machine without a CUDA GPU never passes.

Usage: python -m cryo_ralib_tpu_torch.cli.check
"""

from __future__ import annotations

import argparse
import subprocess


def _ok(name, detail=""):
    print(f"  [ok]   {name}" + (f" — {detail}" if detail else ""))


def _fail(name, detail=""):
    print(f"  [FAIL] {name}" + (f" — {detail}" if detail else ""))


def _small_launch():
    """One search kernel launch on 8 particles held against the plain
    search: identical winners, peaks within 1e-4 of the largest."""
    import numpy as np
    import torch

    from ..config import AlignConfig
    from ..ops import fused_search as fs
    from ..ops.search import prepare_ref_spectra
    from ..params import AlignParams

    dev = torch.device("cuda")
    cfg = AlignConfig(img_dim=32, ring_num=12, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    rng = np.random.default_rng(0)
    refs = rng.standard_normal((2, 32, 32)).astype(np.float32)
    imgs = refs[np.arange(8) % 2] + 0.1 * rng.standard_normal(
        (8, 32, 32)).astype(np.float32)
    imgs = torch.as_tensor(imgs, device=dev)
    rfw = prepare_ref_spectra(torch.as_tensor(refs, device=dev), cfg)
    params = AlignParams.zeros(8, dev)
    got = fs.fused_search(imgs, rfw, params, cfg)
    want = fs.search_plain(imgs, rfw, params, cfg)
    torch.cuda.synchronize()
    for f in ("best_ref", "best_sidx", "best_mirror", "best_aidx"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise RuntimeError(f"kernel and plain search differ in {f}")
    err = float((got.best_val - want.best_val).abs().max())
    if err > 1e-4 * float(want.best_val.abs().max()):
        raise RuntimeError(f"peak values differ by {err}")
    return err


def main(argv=None):
    p = argparse.ArgumentParser(prog="cryo-ralib-torch-check")
    p.add_argument("--mesh", type=int, default=0,
                   help="a sharded step over an N-device mesh: not part of "
                        "this check (run examples/torch_06_mesh_scaling.py "
                        "--ranks=N)")
    args = p.parse_args(argv)
    if args.mesh > 1:
        print(f"ERROR: --mesh={args.mesh}: this check runs one process; "
              "run examples/torch_06_mesh_scaling.py --ranks="
              f"{args.mesh} for a sharded step")
        return 2
    failures = 0

    print("cryo_ralib_tpu_torch environment check")
    import numpy as np
    _ok("numpy", np.__version__)
    import torch

    if torch.version.cuda:
        _ok("torch", f"{torch.__version__}, built for CUDA "
            f"{torch.version.cuda}")
    else:
        _fail("torch", f"{torch.__version__} was built without CUDA")
        failures += 1
    cuda = torch.cuda.is_available()
    if cuda:
        _ok("CUDA device", ", ".join(
            f"{i}: {torch.cuda.get_device_name(i)} (sm_"
            f"{''.join(map(str, torch.cuda.get_device_capability(i)))})"
            for i in range(torch.cuda.device_count())))
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60)
            _ok("nvidia-smi (name, power limit)",
                "; ".join(out.stdout.strip().splitlines()))
        except (OSError, subprocess.SubprocessError) as e:
            print(f"  [--]   nvidia-smi unavailable ({e}); the power limit "
                  "is not known")
    else:
        _fail("CUDA device", "CUDA is not available: no NVIDIA GPU visible "
              "to torch")
        failures += 1

    from .. import kernels
    from ..ops import fused_search as fs

    built = False
    try:
        _ok("nvcc", kernels.nvcc_path())
    except RuntimeError as e:
        _fail("nvcc", str(e))
        failures += 1
    else:
        try:
            fs.build()
            info = kernels.build_log["search"]
            _ok("search kernel built (sm_90a)",
                f"{info['seconds']:.1f} s, cached={info['cached']}")
            built = True
        except Exception as e:  # noqa: BLE001 - report and go on checking
            _fail("search kernel build", str(e).splitlines()[0] if str(e)
                  else repr(e))
            failures += 1
    if cuda and built:
        try:
            err = _small_launch()
            _ok("search kernel launch vs plain search",
                f"8 particles, identical winners, max |dpeak| {err:.2e}")
        except Exception as e:  # noqa: BLE001 - report and go on checking
            _fail("search kernel launch", repr(e))
            failures += 1
    else:
        _fail("search kernel launch", "needs a CUDA device and the built "
              "kernel")
        failures += 1

    for mod, what in [("h5py", "reading .hdf inputs not written by this "
                               "package"),
                      ("scipy", "the tanh fit of the ref_ali2d filter")]:
        try:
            m = __import__(mod)
            _ok(f"{mod} ({what})", getattr(m, "__version__", ""))
        except ImportError:
            print(f"  [--]   {mod} ({what}) not installed — optional")

    print("all checks passed" if failures == 0 else f"{failures} FAILURES")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
