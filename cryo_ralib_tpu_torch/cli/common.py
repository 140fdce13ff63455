"""Shared CLI plumbing of the alignment front-ends (counterpart of
``cryo_ralib_tpu/cli/common.py``).

The same flags, spellings and per-CLI defaults as the JAX CLI (the
reference's optparse surface), so a command line that runs there parses
the same here.  ``--devices`` (or ``--gpu_devices``, whose entries are
counted) sets the number of ranks, one process per card, as the JAX
CLI's ``make_mesh_arg`` sets its mesh: 0 means every visible card (one
process on the CPU), and a count above the visible cards is clamped and
logged.  Under ``torchrun`` (``python -m torch.distributed.run``,
``WORLD_SIZE`` in the environment) each process joins the group as one
rank, and torchrun's ranks replace ``--devices``; otherwise more than
one rank is started here, one worker process per card
(``torch.multiprocessing.spawn``, meeting through a file store in a
temporary directory).  Each rank reads its block of the stack;
rank 0 checks and writes the output directory and the log, writes the
headers back, and its exit status is the run's.
Stacks are ``.hdf``, ``.mrc(s)`` or EMAN2 ``bdb:`` containers (read and
written back through the system's ``libdb``, ``io/bdb.py``).
``--sampler``: ``auto`` and ``fused`` run the CUDA search kernel on the
GPU, ``gather`` its plain PyTorch version (the JAX ``gather`` engine's
f32 semantics), ``template`` the template engine (the search as bf16
matrix products, ``ops/template_search.py``; standard and eman2 rings,
SHC; refused under SCF and outside its geometry gate), ``matmul`` the
matmul sampler (the polar samples as bf16 tent products,
``ops/polar_mm.py``; every mode); ``template`` and ``matmul`` sum the
classes by the FFT shear, as the JAX CLI does with them;
``--random_method=SHC`` runs the kernel's SHC pick under ``auto`` and
``fused``; ``--ring_scheme=eman2`` has no kernel and runs the PyTorch
search under ``auto`` (``fused`` is refused there).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# --sampler -> the port's search: kernel on a CUDA device, plain version,
# template engine, matmul sampler
SAMPLERS = {"auto": "auto", "fused": "kernel", "gather": "plain",
            "template": "template", "matmul": "matmul"}


def _intish(s: str) -> int:
    """The reference parses its integer-valued flags as optparse floats
    (``--ou=36.0`` works there); accept the same spellings."""
    return int(float(s))


def _sched(s: str) -> float:
    """Shift-range/step value, accepting the reference reffree's
    space-separated schedule strings (``--xr="4 2 1 1"``), of which the
    reference uses only the first entry (it pins ``N_step = 0``); so does
    this, and says so."""
    vals = [float(v) for v in s.replace(",", " ").split()]
    if not vals:
        raise argparse.ArgumentTypeError("empty shift range/step")
    if len(vals) > 1:
        print(f"NOTE: schedule {vals} accepted for compatibility; like "
              "the reference (N_step pinned to 0), only the first entry "
              f"({vals[0]}) is used", file=sys.stderr)
    return vals[0]


def add_common_flags(p: argparse.ArgumentParser, reffree: bool = False):
    """The JAX CLI's flags, flag for flag, with each CLI's own defaults
    (mref: xr=0, ts=1, center=1; reffree: xr=4, ts=2, center=-1)."""
    p.add_argument("--ir", type=_intish, default=1,
                   help="inner ring radius")
    p.add_argument("--ou", type=_intish, default=-1, help="outer ring radius")
    p.add_argument("--rs", type=_intish, default=1, help="ring step")
    p.add_argument("--xr", type=_sched, default=4.0 if reffree else 0.0,
                   help="x shift search range (a schedule string is "
                        "accepted; its first entry is used)")
    p.add_argument("--yr", type=_sched, default=-1.0,
                   help="y shift search range (<0: use xr)")
    p.add_argument("--ts", type=_sched, default=2.0 if reffree else 1.0,
                   help="shift search step (a schedule string is accepted; "
                        "its first entry is used)")
    p.add_argument("--center", type=_intish, default=-1 if reffree else 1,
                   help="centering method (mref default 1, reffree -1 = "
                        "average centering)")
    p.add_argument("--maxit", type=_intish, default=0,
                   help="max iterations (0 = auto)")
    p.add_argument("--CTF", action="store_true",
                   help="CTF-aware alignment: premultiply particles by "
                        "their CTF, Wiener-restore class averages "
                        "(requires --ctf_file)")
    p.add_argument("--snr", type=float, default=1.0, help="SNR (CTF path)")
    p.add_argument("--ctf_file", default="",
                   help="per-particle CTF parameters: a RELION .star file "
                        "or a text table of 'dfu [dfv [dfang]]' rows "
                        "(Angstrom / degrees)")
    p.add_argument("--apix", type=float, default=None,
                   help="pixel size in A (CTF path; overrides the STAR "
                        "file's DetectorPixelSize/Magnification)")
    p.add_argument("--voltage", type=float, default=300.0,
                   help="acceleration voltage in kV (CTF path)")
    p.add_argument("--Cs", type=float, default=2.7,
                   help="spherical aberration in mm (CTF path)")
    p.add_argument("--ac", type=float, default=0.1,
                   help="amplitude contrast ratio (CTF path)")
    p.add_argument("--function", default="ref_ali2d",
                   help="reference-preparation user function")
    p.add_argument("--rand_seed", type=int, default=1000,
                   help="seed for vanished-class reseeding")
    p.add_argument("--MPI", action="store_true",
                   help="accepted for compatibility; one process per GPU")
    p.add_argument("--EQ", action="store_true",
                   help="accepted for compatibility (EQ variant unused)")
    p.add_argument("--gpu_devices", default="",
                   help="compatibility alias for --devices: a count, or a "
                        "list of card ids whose entries are counted")
    p.add_argument("--gpu_info", action="store_true",
                   help="print the visible CUDA devices and exit")
    p.add_argument("--devices", type=int, default=0,
                   help="number of GPUs, one process each (0 = every "
                        "visible GPU; more than are visible is clamped)")
    p.add_argument("--sampler", default="auto",
                   choices=["auto", "fused", "template", "matmul", "gather"],
                   help="search engine: auto and fused = the CUDA search "
                        "kernel, gather = its plain PyTorch version, "
                        "template = the search as bf16 matrix products, "
                        "matmul = the polar samples as bf16 tent products")
    p.add_argument("--ring_scheme", default="cuda",
                   choices=["cuda", "eman2"],
                   help="polar ring convention: cuda = uniform 256-sample "
                        "rings (the CUDA kernel's), eman2 = variable-length "
                        "Numrinit rings + ringwe weights (PyTorch search)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the checkpoint in outdir")
    p.add_argument("--header_writeback", action="store_true",
                   help="write final params into the input stack headers "
                        "(xform.align2d / assign)")
    if reffree:
        p.add_argument("--nomirror", action="store_true",
                       help="disable the mirrored-orientation search channel")
        p.add_argument("--dst", type=float, default=0.0,
                       help="discrete-angle delta: every 4th iteration "
                            "(except the last 10) the rotation search is "
                            "restricted to multiples of this angle")
        p.add_argument("--Fourvar", action="store_true",
                       help="compute the 2-D Fourier variance of the "
                            "aligned stack each iteration, divide the "
                            "average by it and write varf.hdf")
        p.add_argument("--mode", default="F", choices=["F", "H"],
                       help="full or half rings: 'H' searches rotations in "
                            "[0, 180) only")
        p.add_argument("--random_method", default="", choices=["", "SHC", "SCF"],
                       help="SHC = stochastic hill climbing (first "
                            "candidate beating the particle's previousmax); "
                            "SCF = self-correlation alignment (rotation "
                            "from the shift-invariant scf, then a 2-D ccf "
                            "translation; forces half rings)")
        p.add_argument("--randomize", action="store_true",
                       help="accepted for compatibility (never read)")
        p.add_argument("--orient", action="store_true",
                       help="accepted for compatibility (never read)")
    return p


def validate_reffree_flags(args):
    """Fail loudly on the undefined --dst + --random_method combination
    (the reference CPU twin's delta applies to the standard search only),
    as the JAX CLI does."""
    if args.dst != 0.0 and args.random_method:
        print("ERROR: unsupported flag(s) — the reference GPU path ignores "
              "these silently; this rebuild rejects them instead:\n  "
              "--dst with --random_method (the CPU twin's delta only "
              "applies to the standard search)", file=sys.stderr)
        raise SystemExit(2)


def _device_count(s: str) -> int:
    """Devices named by ``--gpu_devices``: a count, or a list of ids."""
    entries = s.replace(",", " ").split()
    if len(entries) == 1 and entries[0].isdigit():
        return int(entries[0])
    return len(entries)


def world_size(args, device, n_visible: int | None = None) -> int:
    """The number of ranks that ``--devices`` / ``--gpu_devices`` ask
    for (the counterpart of the JAX CLI's ``make_mesh_arg``): 0 means
    every visible card on a CUDA device and one process on the CPU; a
    count above the ``n_visible`` devices (the visible cards, or the CPU
    cores) is clamped, and the clamp is logged to stderr."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if n_visible is None:
        n_visible = (torch.cuda.device_count() if cuda
                     else os.cpu_count() or 1)
    want = args.devices if args.devices > 0 else _device_count(
        args.gpu_devices)
    if want <= 0:
        return n_visible if cuda else 1
    if want > n_visible:
        flag = (f"--devices={args.devices}" if args.devices > 0
                else f"--gpu_devices={args.gpu_devices}")
        print(f"NOTE: {flag} asks for {want} devices; {n_visible} "
              f"{'are' if n_visible > 1 else 'is'} visible, so the run "
              f"takes {n_visible}", file=sys.stderr)
        return n_visible
    return want


def prepare_outdir(args):
    """The output directory: made if it is missing under ``--resume``,
    else it must not exist (exit 1)."""
    if args.resume:
        os.makedirs(args.outdir, exist_ok=True)
    else:
        check_outdir(args.outdir)


def launch(run, args, device) -> int:
    """Run ``run(args, device, mesh)`` on every rank and return the run's
    exit status (rank 0's).

    Under ``torchrun`` the process joins the group as one rank (the
    ranks are torchrun's; ``--devices`` is not read); with one rank it
    runs here with no mesh; with more it starts one worker per
    rank (``torch.multiprocessing.spawn``) and waits for them: a worker
    that raises or exits non-zero ends the others and makes this exit
    non-zero.  Rank 0 (or this process, before the workers start)
    prepares the output directory."""
    from ..parallel.mesh import initialize_distributed, shutdown

    if "WORLD_SIZE" in os.environ:
        mesh = initialize_distributed(device=device)
        try:
            return _run_rank(run, args, mesh)
        finally:
            shutdown()
    n = world_size(args, device)
    prepare_outdir(args)
    if n <= 1:
        return run(args, device, None)
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="cryo_ralib_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        ctx = mp.spawn(_spawned_rank, args=(run, args, str(device), n, store),
                       nprocs=n, join=False)
        try:
            while not ctx.join():
                pass
        except mp.ProcessExitedException as err:
            print(f"ERROR: {err}", file=sys.stderr)
            _report_other_ranks(ctx, err.error_index)
            return err.exit_code or 1
        except mp.ProcessRaisedException as err:
            print(f"ERROR: a rank failed:\n{err}", file=sys.stderr)
            _report_other_ranks(ctx, err.error_index)
            return 1
    return 0


def _report_other_ranks(ctx, first: int):
    """Print the tracebacks of the ranks that raised besides the one
    ``torch.multiprocessing.spawn`` reported: when a rank raises and
    leaves, its peers' collectives fail too, and the spawn reports
    whichever process it sees end first, which under load can be such a
    peer and not the rank that started it.  The tracebacks are the
    pickled strings the workers' wrapper wrote (one file per rank)."""
    import pickle

    for rank, path in enumerate(ctx.error_files):
        if rank != first and os.access(path, os.R_OK):
            with open(path, "rb") as fh:
                trace = pickle.load(fh)
            print(f"ERROR: rank {rank} failed too:\n{trace}", file=sys.stderr)


def _spawned_rank(rank, run, args, device, n, store):
    """One worker of ``launch``: join the group through the file store and
    run; the output directory is already prepared."""
    from ..parallel.mesh import initialize_distributed, shutdown

    mesh = initialize_distributed(rank=rank, world_size=n, local_rank=rank,
                                  init_method=store, device=device)
    try:
        code = run(args, mesh.device, mesh)
    finally:
        shutdown()
    if code:
        raise SystemExit(code)


def _run_rank(run, args, mesh) -> int:
    """One rank under torchrun: rank 0 prepares the output directory and
    every rank takes its status."""
    from ..parallel.mesh import broadcast_status

    code = 0
    if mesh.is_root:
        try:
            prepare_outdir(args)
        except SystemExit as err:
            code = err.code
    code = broadcast_status(code, mesh)
    if code:
        return code
    return run(args, mesh.device, mesh)


def rank_log(outdir: str, mesh):
    """The run's log: rank 0's (or the single process's) in ``outdir``,
    nothing on the other ranks; a rank's run logs its group first."""
    from ..utils.log import RunLogger

    if mesh is not None and not mesh.is_root:
        return RunLogger(None, quiet=True)
    log = RunLogger(outdir)
    if mesh is not None:
        log.add(f"{mesh.world_size} ranks, backend {mesh.backend}, rank 0 "
                f"on {mesh.device}")
    return log


def load_ctf_params(args, n: int) -> dict | None:
    """The ``ctf_params`` dict of ``mref_ali2d`` / ``ali2d_base`` from
    --CTF/--ctf_file, as the JAX CLI builds it: None when --CTF is off; exit 2 on --CTF without a
    file, on a STAR file without a usable ``_rlnDefocusU`` column, and on
    a particle-count mismatch."""
    if not args.CTF:
        return None
    if not args.ctf_file:
        print("ERROR: --CTF requires --ctf_file (per-particle defocus)",
              file=sys.stderr)
        raise SystemExit(2)
    path = args.ctf_file
    if path.lower().endswith(".star"):
        from ..io.star import Starfile, parse_ctf_star

        star = Starfile.load(path)
        # angpix=None lets parse_ctf_star derive apix from the file's
        # DetectorPixelSize/Magnification; --apix overrides
        rows = parse_ctf_star(star.df, d=0, angpix=args.apix)
        # parse_ctf_star zero-fills absent columns; a missing DefocusU
        # would run an all-zero CTF model
        if "_rlnDefocusU" not in star.df or not np.any(rows[:, 2]):
            print(f"ERROR: {path} has no usable _rlnDefocusU column — "
                  "cannot build a CTF model", file=sys.stderr)
            raise SystemExit(2)
        apix = float(rows[0, 1])
        dfu, dfang = rows[:, 2], rows[:, 4]
        # dfv=0 would mean extreme astigmatism: an absent DefocusV
        # defaults to dfu
        dfv = rows[:, 3] if "_rlnDefocusV" in star.df else dfu
        voltage = float(rows[0, 5]) or args.voltage
        cs = float(rows[0, 6]) or args.Cs
        w = float(rows[0, 7]) or args.ac
        phase_shift = rows[:, 8]   # per particle (phase plates)
    else:
        # ndmin=2 keeps a single-column file as (N, 1), not a row vector
        rows = np.loadtxt(path, dtype=np.float64, ndmin=2)
        apix = args.apix if args.apix is not None else 1.0
        dfu = rows[:, 0]
        dfv = rows[:, 1] if rows.shape[1] > 1 else dfu
        dfang = rows[:, 2] if rows.shape[1] > 2 else np.zeros_like(dfu)
        voltage, cs, w, phase_shift = args.voltage, args.Cs, args.ac, 0.0
    if dfu.shape[0] != n:
        print(f"ERROR: {dfu.shape[0]} CTF rows for {n} particles",
              file=sys.stderr)
        raise SystemExit(2)
    return dict(dfu=dfu, dfv=dfv, dfang=dfang, apix=apix,
                voltage=voltage, cs=cs, w=w, phase_shift=phase_shift)


def cli_device(device):
    """The torch device a CLI run uses; without CUDA (for a CUDA device)
    an error naming CUDA and exit status 1, before any output exists."""
    from ..models.engine import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as err:
        print(f"ERROR: {err}", file=sys.stderr)
        raise SystemExit(1) from err


def print_device_info():
    """``--gpu_info``: the visible CUDA devices."""
    import torch

    if not torch.cuda.is_available():
        print(f"no CUDA device visible (torch {torch.__version__}, CUDA "
              f"build {torch.version.cuda})")
        return
    for i in range(torch.cuda.device_count()):
        prop = torch.cuda.get_device_properties(i)
        print(f"device {i}: {prop.name} (cuda, sm_{prop.major}{prop.minor}, "
              f"{prop.total_memory / 2**30:.1f} GiB)")


def load_stack(path: str, mesh=None):
    """Read a particle stack: an EMAN2 ``bdb:`` container (through the
    system's libdb), or by extension EMAN2-HDF (.hdf, through h5py unless
    this package wrote it) or MRC(S).  Under a ``mesh`` the images are a
    ``StackShard`` of the rank's block, with their headers: an MRC stack
    reads only the block's slices, HDF picks them, ``bdb:`` is read
    whole and cut."""
    if mesh is not None:
        return _load_block(path, mesh)
    from ..io.eman_hdf import read_hdf_stack
    from ..io.mrc import read_mrc

    if path.startswith("bdb:"):
        from ..io.bdb import read_bdb_stack

        try:
            images, headers = read_bdb_stack(path)
        except FileNotFoundError:
            raise
        except (RuntimeError, ValueError, OSError, KeyError) as e:
            # missing libdb, a foreign layout (no maxrec/data_path) or a
            # corrupt btree: the same guidance as the JAX CLI's
            raise ValueError(
                f"{e}; convert to HDF first, e.g. "
                f"`e2proc2d.py {path} stack.hdf` — then pass stack.hdf"
            ) from e
        return np.asarray(images, np.float32), headers
    ext = os.path.splitext(path)[1].lower()
    if ext in (".hdf", ".h5", ".hdf5"):
        images, headers = read_hdf_stack(path)
        return np.asarray(images, np.float32), headers
    if ext in (".mrc", ".mrcs"):
        data = read_mrc(path)
        if data.ndim == 2:
            data = data[None]
        return np.asarray(data, np.float32), [{} for _ in range(len(data))]
    raise ValueError(f"unsupported stack format: {path}")


def _load_block(path: str, mesh):
    from ..io.eman_hdf import get_image_count, read_hdf_stack
    from ..io.mrc import parse_header, read_mrc
    from ..parallel.mesh import StackShard, shard_range

    ext = os.path.splitext(path)[1].lower()
    if path.startswith("bdb:") or ext not in (".hdf", ".h5", ".hdf5",
                                              ".mrc", ".mrcs"):
        images, headers = load_stack(path)
        start, stop = shard_range(images.shape[0], mesh)
        return StackShard(images[start:stop], start, images.shape[0]), \
            headers[start:stop]
    if ext in (".mrc", ".mrcs"):
        n = parse_header(path).nz
        start, stop = shard_range(n, mesh)
        images = read_mrc(path, indices=np.arange(start, stop))
        headers = [{} for _ in range(stop - start)]
    else:
        n = get_image_count(path)
        start, stop = shard_range(n, mesh)
        images, headers = read_hdf_stack(path, indices=range(start, stop))
    return StackShard(np.asarray(images, np.float32), start, n), headers


def load_mask(path: str | None, nx: int):
    """Optional maskfile positional: the first image of the file, which
    must match the particle box size."""
    if not path:
        return None
    imgs, _ = load_stack(path)
    mask = np.asarray(imgs[0], np.float32)
    if mask.shape != (nx, nx):
        print(f"ERROR: maskfile {path} is {mask.shape}, stack box is "
              f"({nx}, {nx})", file=sys.stderr)
        raise SystemExit(2)
    return mask


def check_outdir(outdir: str):
    """The reference hard-errors when the output directory exists."""
    if os.path.exists(outdir):
        print(f"ERROR: output directory {outdir} exists", file=sys.stderr)
        raise SystemExit(1)
    os.makedirs(outdir)


def writeback_headers(stack_path: str, table: np.ndarray, assign=None):
    """Final header write-back (``xform.align2d`` + ``assign``) into an
    HDF stack or a ``bdb:`` container."""
    updates = []
    for i in range(table.shape[0]):
        upd = {"xform.align2d": {
            "alpha": float(table[i, 0]), "tx": float(table[i, 1]),
            "ty": float(table[i, 2]), "mirror": int(table[i, 3]),
            "scale": 1.0}}
        if assign is not None:
            upd["assign"] = int(assign[i])
        updates.append(upd)
    if stack_path.startswith("bdb:"):
        from ..io.bdb import update_bdb_headers

        update_bdb_headers(stack_path, updates)
        return
    from ..io.eman_hdf import update_headers

    update_headers(stack_path, updates)
