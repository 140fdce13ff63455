"""The port's command line (``cryo_ralib_tpu_torch/cli``) against the JAX
package's, on the CPU: the same parsers, and the same output files with
matching contents from the same stacks.

The port's CLI runs with ``main(argv, device="cpu")`` and
``--sampler=gather`` (its plain search); the JAX CLI with
``--sampler=gather --devices=1``.  Tolerances: ``.hdf`` images within
1e-4 of their largest value with equal headers, text tables within 1e-3
(as tests/test_torch_mref.py); the logs' content is not compared.  Under
``--CTF`` the images agree within 1e-3 of their largest value (the two
packages' f32 CTFs differ by 6e-5, tests/test_torch_ctf.py, and the
Wiener division carries that into the averages).  ``--Fourvar`` is held
from a one-iteration start with both packages' variance op at
``engine="exact"`` (tests/test_torch_fourvar.py says why).  Every
``--sampler`` value of the JAX CLI is taken (``--sampler=matmul`` in
tests/test_torch_matmul.py).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from cryo_ralib_tpu.cli import mref as jax_mref
from cryo_ralib_tpu.cli import reffree as jax_reffree
from cryo_ralib_tpu.io.eman_hdf import read_hdf_stack as jax_read_hdf
from cryo_ralib_tpu.io.eman_hdf import write_hdf_stack as jax_write_hdf
from cryo_ralib_tpu.utils.synthetic import (asymmetric_templates,
                                            scattered_stack)
from cryo_ralib_tpu_torch.cli import check as port_check
from cryo_ralib_tpu_torch.cli import mref as port_mref
from cryo_ralib_tpu_torch.cli import reffree as port_reffree
from cryo_ralib_tpu_torch.io.eman_hdf import read_own_hdf, write_hdf_stack
from cryo_ralib_tpu_torch.io.mrc import write_mrc

K, NX, N = 2, 48, 8
COMMON = ["--ou=16", "--xr=1", "--ts=1"]
CLIS = {"mref": (port_mref, jax_mref), "reffree": (port_reffree, jax_reffree)}


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """The same particles and references as .hdf (written by the JAX
    writer, so the port reads them through h5py) and as .mrcs."""
    d = tmp_path_factory.mktemp("stacks")
    base = asymmetric_templates(K, NX)
    imgs = np.asarray(scattered_stack(base, N, max_shift=1, noise=0.05,
                                      seed=43)[0], np.float32)
    paths = {}
    for name, data in (("stack", imgs), ("refs", base)):
        paths[name, "hdf"] = str(d / f"{name}.hdf")
        jax_write_hdf(paths[name, "hdf"], data)
        paths[name, "mrcs"] = str(d / f"{name}.mrcs")
        write_mrc(paths[name, "mrcs"], data)
    return paths


def _run(cli, which, argv):
    port, jax_cli = CLIS[cli]
    if which == "port":
        return port.main(argv, device="cpu")
    return jax_cli.main(argv + ["--devices=1"])


def _positionals(stacks, cli, fmt, outdir):
    refs = [stacks["refs", fmt]] if cli == "mref" else []
    return [stacks["stack", fmt]] + refs + [outdir]


def _assert_outputs_match(d_port, d_jax, rel=1e-4, text_atol=1e-3):
    names = set(os.listdir(d_jax))
    assert set(os.listdir(d_port)) == names
    for name in sorted(names - {"logfile.txt"}):
        a, b = os.path.join(d_port, name), os.path.join(d_jax, name)
        if name == "varf.hdf":
            # a resumed run's file has no image 0: compare by key
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                ga, gb = fa["MDF/images"], fb["MDF/images"]
                assert sorted(ga) == sorted(gb)
                for key in gb:
                    want = gb[key]["image"][()]
                    np.testing.assert_allclose(
                        ga[key]["image"][()], want, rtol=0,
                        atol=rel * np.abs(want).max(), err_msg=name)
        elif name.endswith(".hdf"):
            got, got_h = jax_read_hdf(a)          # through h5py
            own, own_h = read_own_hdf(a)          # without it
            want, want_h = jax_read_hdf(b)
            assert np.array_equal(own, got) and own_h == got_h, name
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=rel * np.abs(want).max(),
                                       err_msg=name)
            assert got_h == want_h, name
        elif name == "checkpoint.npz":
            za, zb = np.load(a), np.load(b)
            assert set(za.files) == set(zb.files)
            for key in ("iteration", "mirror", "ref_id"):
                np.testing.assert_array_equal(za[key], zb[key])
            np.testing.assert_allclose(za["refs"], zb["refs"], rtol=0,
                                       atol=rel * np.abs(zb["refs"]).max())
        elif name.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
        else:
            ta, tb = np.loadtxt(a), np.loadtxt(b)
            if name.startswith("resolution"):
                # the zero shell's FSC of a mean-subtracted reffree average
                # is the sign of two rounding residues (ROADMAP Queue 3)
                ta[0, 1] = tb[0, 1]
            np.testing.assert_allclose(ta, tb, atol=text_atol, err_msg=name)


ARGV_SPELLINGS = [
    [],
    ["--ou=36.0", "--xr=4 2 1 1", "--ts=2 1 0.5 0.25", "--yr=3"],
    ["--ir=2", "--rs=2", "--center=0", "--maxit=7.0", "--function",
     "ref_ali2d_no_filter", "--rand_seed=5", "--MPI", "--EQ"],
    ["--sampler=fused", "--gpu_info", "--resume", "--header_writeback",
     "--gpu_devices=0", "--devices=1"],
    ["--CTF", "--snr=2", "--ctf_file=x.star", "--apix=1.5", "--voltage=200",
     "--Cs=2.0", "--ac=0.07", "--ring_scheme=eman2", "--sampler=matmul"],
]
REFFREE_SPELLINGS = [
    ["--dst=15", "--nomirror", "--Fourvar", "--mode=H", "--random_method=SHC",
     "--randomize", "--orient", "--xr=1,1"],
]


PARSES = ([(cli, argv) for cli in CLIS for argv in ARGV_SPELLINGS]
          + [("reffree", argv) for argv in REFFREE_SPELLINGS])


@pytest.mark.parametrize("cli,argv", PARSES,
                         ids=[f"{c}{i}" for i, (c, _) in enumerate(PARSES)])
def test_parsers_match_jax(cli, argv):
    """Every flag, spelling and per-CLI default parses to the same
    namespace (``sampler`` keeps its value; only its meaning differs)."""
    port, jax_cli = CLIS[cli]
    pos = ["s.hdf", "r.hdf", "o"] if cli == "mref" else ["s.hdf", "o"]
    assert (vars(port.build_parser().parse_args(pos + argv))
            == vars(jax_cli.build_parser().parse_args(pos + argv)))


@pytest.mark.parametrize("cli,fmt,extra", [
    ("mref", "hdf", ["--maxit=2"]),
    ("mref", "mrcs", ["--maxit=2", "--center=0"]),
    ("reffree", "hdf", ["--maxit=3"]),
    ("reffree", "mrcs", ["--maxit=11", "--dst=90", "--nomirror"]),
], ids=["mref-hdf", "mref-mrcs", "reffree-hdf", "reffree-mrcs-dst"])
def test_cli_matches_jax(tmp_path, stacks, cli, fmt, extra):
    dirs = {w: str(tmp_path / w) for w in ("port", "jax")}
    for which, d in dirs.items():
        argv = (_positionals(stacks, cli, fmt, d) + COMMON + extra
                + ["--sampler=gather"])
        assert _run(cli, which, argv) == 0
    _assert_outputs_match(dirs["port"], dirs["jax"])


STAR_HEAD = ("data_\n\nloop_\n_rlnDefocusU #1\n_rlnDefocusV #2\n"
             "_rlnDefocusAngle #3\n_rlnVoltage #4\n"
             "_rlnSphericalAberration #5\n_rlnAmplitudeContrast #6\n"
             "_rlnDetectorPixelSize #7\n_rlnMagnification #8\n")


@pytest.fixture(scope="module")
def ctf_files(tmp_path_factory):
    """Per-particle defocus as a RELION STAR file and as a text table."""
    d = tmp_path_factory.mktemp("ctf")
    rng = np.random.default_rng(0)
    dfu = rng.uniform(8000.0, 25000.0, N)
    dfv = dfu + rng.uniform(-400.0, 400.0, N)
    ang = rng.uniform(0.0, 180.0, N)
    star, txt = d / "particles.star", d / "defocus.txt"
    star.write_text(STAR_HEAD + "".join(
        f"{u:.3f} {v:.3f} {a:.3f} 200.0 2.0 0.07 5.0 29411.76\n"
        for u, v, a in zip(dfu, dfv, ang)))
    np.savetxt(txt, np.stack([dfu, dfv, ang], axis=1))
    return {"star": str(star), "txt": str(txt)}


# the mode, CTF and ring-scheme flags, each against the JAX CLI's files
NEW_FLAGS = [
    ("mref", "mrcs", ["--maxit=2", "--CTF", "--ctf_file=star", "--snr=2"]),
    ("mref", "hdf", ["--maxit=2", "--CTF", "--ctf_file=txt", "--apix=1.7",
                     "--voltage=200", "--Cs=2.0", "--ac=0.07"]),
    ("mref", "hdf", ["--maxit=2", "--ring_scheme=eman2"]),
    ("mref", "mrcs", ["--maxit=2", "--ring_scheme=eman2", "--center=0"]),
    ("reffree", "hdf", ["--maxit=3", "--CTF", "--ctf_file=star"]),
    ("reffree", "mrcs", ["--maxit=3", "--random_method=SHC"]),
    ("reffree", "hdf", ["--maxit=3", "--random_method=SCF"]),
    ("reffree", "mrcs", ["--maxit=3", "--mode=H"]),
    ("reffree", "hdf", ["--maxit=3", "--ring_scheme=eman2"]),
    ("reffree", "mrcs", ["--maxit=11", "--mode=H", "--dst=45",
                         "--nomirror"]),
]


@pytest.mark.parametrize("cli,fmt,extra", NEW_FLAGS, ids=[
    f"{c}{''.join(a[1:3])}" for c, _f, a in NEW_FLAGS])
def test_cli_new_flags_match_jax(tmp_path, stacks, ctf_files, cli, fmt,
                                 extra):
    extra = [f"--ctf_file={ctf_files[a.split('=')[1]]}"
             if a.startswith("--ctf_file=") else a for a in extra]
    dirs = {w: str(tmp_path / w) for w in ("port", "jax")}
    for which, d in dirs.items():
        argv = (_positionals(stacks, cli, fmt, d) + COMMON + extra
                + ["--sampler=gather"])
        assert _run(cli, which, argv) == 0
    _assert_outputs_match(dirs["port"], dirs["jax"],
                          rel=1e-3 if "--CTF" in extra else 1e-4)


def test_cli_fourvar_matches_jax(tmp_path, stacks, monkeypatch):
    """``--Fourvar`` resumed after one plain iteration, so that the
    variance is taken at real params; both CLIs with their variance op at
    ``engine="exact"`` (the bilinear transform; the shear engine is held
    in tests/test_torch_fourvar.py).  Images within 1e-3 of
    their largest value (measured 1.003e-4 on ``aqfinal.hdf``): the
    division by the variance amplifies rounding where it is small; the
    params found against that average within 0.05 degree and px
    (measured 0.013 degree)."""
    import cryo_ralib_tpu.ops.fourvar as jfourvar

    shear = jfourvar.fourier_variance
    monkeypatch.setattr(
        jfourvar, "fourier_variance",
        lambda data, params, mask=None: shear(data, params, mask=mask,
                                              engine="exact"))
    from cryo_ralib_tpu_torch.models import reffree as port_reffree

    port_shear = port_reffree.fourier_variance
    monkeypatch.setattr(
        port_reffree, "fourier_variance",
        lambda data, params, mask=None, mesh=None: port_shear(
            data, params, mask=mask, mesh=mesh, engine="exact"))
    dirs = {w: str(tmp_path / w) for w in ("port", "jax")}
    for which, d in dirs.items():
        argv = (_positionals(stacks, "reffree", "hdf", d) + COMMON
                + ["--sampler=gather"])
        assert _run("reffree", which, argv + ["--maxit=1"]) == 0
        assert _run("reffree", which, argv + ["--maxit=2", "--resume",
                                              "--Fourvar"]) == 0
    assert "varf.hdf" in os.listdir(dirs["port"])
    _assert_outputs_match(dirs["port"], dirs["jax"], rel=1e-3,
                          text_atol=0.05)


@pytest.mark.parametrize("argv,match", [
    (["--ring_scheme=eman2", "--sampler=fused"], "sampler='kernel'"),
    (["--ring_scheme=eman2", "--random_method=SHC"], "eman2"),
])
def test_cli_refused_combinations_raise(tmp_path, stacks, argv, match):
    """What the JAX package refuses with a ``ValueError`` (the kernel
    forced where there is none, eman2 with a random method) raises one
    here too."""
    with pytest.raises(ValueError, match=match):
        _run("reffree", "port", _positionals(stacks, "reffree", "mrcs",
                                             str(tmp_path / "o")) + COMMON
             + argv)


def test_cli_shc_takes_the_kernel_sampler(tmp_path, stacks):
    """``--random_method=SHC --sampler=fused`` runs, where the JAX CLI
    refuses it: the port's kernel has an SHC pick.  On the CPU its search
    is the plain SHC search, so the files are those of
    ``--sampler=gather``, bit for bit."""
    dirs = {s: str(tmp_path / s) for s in ("fused", "gather")}
    for sampler, d in dirs.items():
        argv = (_positionals(stacks, "reffree", "mrcs", d) + COMMON
                + ["--maxit=3", "--random_method=SHC", f"--sampler={sampler}"])
        assert _run("reffree", "port", argv) == 0
    _assert_outputs_match(dirs["fused"], dirs["gather"], rel=0.0,
                          text_atol=0.0)


def test_cli_ctf_without_usable_file_exits_2(tmp_path, stacks, capsys):
    star = tmp_path / "noctf.star"
    star.write_text("data_\n\nloop_\n_rlnImageName #1\n"
                    + "".join(f"{i + 1}@a.mrcs\n" for i in range(N)))
    for extra, text in ((["--CTF"], "--ctf_file"),
                        (["--CTF", f"--ctf_file={star}"], "_rlnDefocusU")):
        with pytest.raises(SystemExit) as exc:
            _run("mref", "port", _positionals(
                stacks, "mref", "mrcs", str(tmp_path / text.strip("-_")))
                + COMMON + extra)
        assert exc.value.code == 2
        assert text in capsys.readouterr().err


def test_cli_maskfile_positional(tmp_path, stacks):
    """The optional maskfile (first image of a stack file) replaces the
    default mask: the port reads it from a file it wrote, the JAX CLI
    from one h5py wrote, and the outputs agree."""
    from cryo_ralib_tpu_torch.ops.masks import model_circle

    mask = np.asarray(model_circle(10, NX), np.float32)[None]
    masks = {"port": str(tmp_path / "mask_port.hdf"),
             "jax": str(tmp_path / "mask_jax.hdf")}
    write_hdf_stack(masks["port"], mask)
    jax_write_hdf(masks["jax"], mask)
    dirs = {}
    for which in ("port", "jax"):
        dirs[which] = str(tmp_path / which)
        argv = (_positionals(stacks, "mref", "hdf", dirs[which])
                + [masks[which]] + COMMON + ["--maxit=1", "--sampler=gather"])
        assert _run("mref", which, argv) == 0
    _assert_outputs_match(dirs["port"], dirs["jax"])
    plain = str(tmp_path / "plain")
    assert port_mref.main(_positionals(stacks, "mref", "hdf", plain) + COMMON
                          + ["--maxit=1", "--sampler=gather"],
                          device="cpu") == 0
    a, _ = read_own_hdf(os.path.join(plain, "aqm000.hdf"))
    b, _ = read_own_hdf(os.path.join(dirs["port"], "aqm000.hdf"))
    assert not np.allclose(a, b)


@pytest.mark.parametrize("cli", ["mref", "reffree"])
@pytest.mark.parametrize("first", ["port", "jax"])
def test_cli_resume(tmp_path, stacks, cli, first):
    """Two iterations by either package's CLI, then the port's
    ``--resume`` to four, against a straight four-iteration port run.
    The reffree resume extends the first run's ``aqc.hdf`` and ``aqf.hdf``
    (the JAX run's through h5py)."""
    argv = COMMON + ["--sampler=gather", "--function=ref_ali2d_no_filter"]
    straight = str(tmp_path / "straight")
    assert _run(cli, "port", _positionals(stacks, cli, "hdf", straight)
                + argv + ["--maxit=4"]) == 0
    d = str(tmp_path / "resumed")
    assert _run(cli, first, _positionals(stacks, cli, "hdf", d)
                + argv + ["--maxit=2"]) == 0
    assert _run(cli, "port", _positionals(stacks, cli, "hdf", d)
                + argv + ["--maxit=4", "--resume"]) == 0
    final = "final2Dparams.txt" if cli == "mref" else "initial2Dparams.txt"
    np.testing.assert_allclose(np.loadtxt(os.path.join(d, final)),
                               np.loadtxt(os.path.join(straight, final)),
                               atol=1e-3)
    names = ["aqm003.hdf"] if cli == "mref" else ["aqc.hdf", "aqf.hdf",
                                                  "aqfinal.hdf"]
    for name in names:
        got, got_h = read_own_hdf(os.path.join(d, name))
        want, want_h = read_own_hdf(os.path.join(straight, name))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        assert got_h == want_h


@pytest.mark.parametrize("cli", ["mref", "reffree"])
def test_cli_header_writeback(tmp_path, stacks, cli):
    """--header_writeback writes ``xform.align2d`` (and ``assign`` for
    mref) into the input stack: the port into a stack it wrote (its own
    rewrite), the JAX CLI into one h5py wrote; the headers agree."""
    imgs, _ = jax_read_hdf(stacks["stack", "hdf"])
    paths = {"port": str(tmp_path / "stack_port.hdf"),
             "jax": str(tmp_path / "stack_jax.hdf")}
    write_hdf_stack(paths["port"], imgs)
    jax_write_hdf(paths["jax"], imgs)
    headers = {}
    for which, path in paths.items():
        refs = [stacks["refs", "hdf"]] if cli == "mref" else []
        argv = ([path] + refs + [str(tmp_path / which)] + COMMON
                + ["--maxit=2", "--sampler=gather", "--header_writeback"])
        assert _run(cli, which, argv) == 0
        got, headers[which] = jax_read_hdf(path)
        np.testing.assert_array_equal(got, imgs)
    for hp, hj in zip(headers["port"], headers["jax"]):
        assert hp.keys() == hj.keys()
        assert hp.get("assign") == hj.get("assign")
        xp, xj = json.loads(hp["xform.align2d"]), json.loads(hj["xform.align2d"])
        assert xp.keys() == xj.keys() and xp["mirror"] == xj["mirror"]
        for key in ("tx", "ty", "scale"):
            assert abs(xp[key] - xj[key]) < 1e-3
        d = abs(xp["alpha"] - xj["alpha"])
        assert min(d, 360.0 - d) < 1e-3


@pytest.mark.parametrize("cli", ["mref", "reffree"])
def test_cli_existing_outdir_exits(tmp_path, stacks, cli):
    d = tmp_path / "exists"
    d.mkdir()
    with pytest.raises(SystemExit) as exc:
        _run(cli, "port", _positionals(stacks, cli, "hdf", str(d)) + COMMON)
    assert exc.value.code == 1


DEVICES = [
    ("mref", ["--devices=2"], 2),
    ("mref", ["--gpu_devices=0,1"], 2),
    ("reffree", ["--gpu_devices=4"], 4),
]


@pytest.mark.parametrize("cli,argv,want", DEVICES,
                         ids=[f"{c}{a[0]}" for c, a, _ in DEVICES])
def test_cli_device_flags_give_the_world_size(capsys, monkeypatch, cli, argv,
                                              want):
    """``--devices`` and ``--gpu_devices`` (a count, or card ids that are
    counted) parse into the number of ranks, as the JAX CLI's
    ``make_mesh_arg`` does: taken as asked where that many cards are
    visible, clamped to the visible cards with a logged note where not;
    0 means every visible card, and one process on the CPU."""
    from cryo_ralib_tpu_torch.cli.common import world_size

    args = CLIS[cli][0].build_parser().parse_args(["s", "r", "o"][:3 if cli
                                                   == "mref" else 2] + argv)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert world_size(args, "cuda") == want
    assert "NOTE" not in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert world_size(args, "cuda") == min(want, 2)
    err = capsys.readouterr().err
    assert ("NOTE" in err and "2 are visible" in err) == (want > 2)
    none = CLIS[cli][0].build_parser().parse_args(["s", "r", "o"][:3 if cli
                                                   == "mref" else 2])
    assert world_size(none, "cuda") == 2
    assert world_size(none, "cpu") == 1
    assert world_size(args, "cpu", n_visible=1) == 1


@pytest.mark.parametrize("cli,spec", [("mref", "bdb:refs"),
                                      ("reffree", "bdb:stack")])
def test_cli_bdb_reaches_load_stack(tmp_path, monkeypatch, stacks, cli,
                                    spec):
    """A ``bdb:`` path is taken (no longer refused with exit 2): it
    reaches ``load_stack``, which without libdb raises the JAX CLI's
    ``ValueError`` naming ``e2proc2d.py``, in both packages."""
    from cryo_ralib_tpu.io import bdb as jax_bdb
    from cryo_ralib_tpu_torch.io import bdb as port_bdb

    monkeypatch.chdir(tmp_path)
    for mod in (port_bdb, jax_bdb):
        monkeypatch.setattr(mod, "_load_libdb", lambda: None)
    _dbdir, dbfile = port_bdb.parse_bdb_path(spec)
    os.makedirs(os.path.dirname(dbfile))
    open(dbfile, "wb").close()
    for which in ("port", "jax"):
        out = str(tmp_path / f"out_{which}")
        pos = ([stacks["stack", "mrcs"], spec, out] if cli == "mref"
               else [spec, out])
        with pytest.raises(ValueError, match="e2proc2d.py") as err:
            _run(cli, which, pos + COMMON)
        assert spec in str(err.value) and "libdb" in str(err.value)


def test_cli_reffree_rejects_dst_with_random_method(capsys):
    with pytest.raises(SystemExit) as exc:
        port_reffree.main(["missing.hdf", "o", "--dst=90",
                           "--random_method=SHC"], device="cpu")
    assert exc.value.code == 2
    assert "--dst" in capsys.readouterr().err


@pytest.mark.parametrize("cli", ["mref", "reffree"])
def test_cli_default_device_needs_cuda(tmp_path, capsys, monkeypatch, cli):
    """Without ``device``, the CLI runs on the GPU: with no CUDA it exits
    1 naming CUDA, before it makes the output directory; ``--gpu_info``
    says that no CUDA device is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = CLIS[cli][0]
    pos = (["s.hdf", "r.hdf"] if cli == "mref" else ["s.hdf"])
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit) as exc:
        port.main(pos + [out])
    assert exc.value.code == 1
    assert "CUDA" in capsys.readouterr().err
    assert not os.path.exists(out)
    assert port.main(pos + [out, "--gpu_info"]) == 0
    assert "no CUDA device" in capsys.readouterr().out


def test_check_fails_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_check.main([]) != 0
    out = capsys.readouterr().out
    assert "[FAIL] CUDA device" in out and "FAILURES" in out
    assert port_check.main(["--mesh=2"]) == 2
