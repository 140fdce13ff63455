"""The port's copy of the numpy oracle (``cryo_ralib_tpu_torch/utils/
oracle.py``) against the JAX package's original, and the port's search
against the oracle directly.

Both oracles are numpy, so each of the 17 public functions must give
exactly the same output on the same seeded inputs.  The port's plain
search (``rotational_shift_search`` + ``decode_params``) is held to
``align_particle_np`` on 16 particles as tests/test_ops.py holds the JAX
search: winners (mirror, ref) equal, shifts within 1e-4, angles within
1e-3 degree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu.utils import oracle as jax_oracle
from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.ops.search import (decode_params,
                                             prepare_ref_spectra,
                                             rotational_shift_search)
from cryo_ralib_tpu_torch.params import params_from_numpy
from cryo_ralib_tpu_torch.utils import oracle
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack)

NX = 16
CFG = AlignConfig(img_dim=NX, ring_num=5, ring_len=32, shift_step=1.0,
                  shift_rng_x=1.0, shift_rng_y=1.0)


def _imgs(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, NX, NX)).astype(np.float64)


def _inputs(name):
    """(args, kwargs) of one oracle function on small seeded inputs."""
    img, r0, r1 = _imgs(3, 5)
    refs = np.stack([r0, r1])
    rings = oracle.numrinit(1, 5)
    geo = (CFG.polar_coords, CFG.ring_weights, CFG.shifts)
    polar = oracle.polar_resample_np(img, CFG.polar_coords, 0.5, -0.25)
    ref_polar = np.stack([oracle.polar_resample_np(r, CFG.polar_coords)
                          for r in refs])
    sbj_rings = oracle.polar_rings_np(img, rings, 0.5, 0.0)
    ref_rings = [oracle.polar_rings_np(r, rings) for r in refs]
    return {
        "bilinear_sample_np": ((img, 3.25, 7.5), {}),
        "polar_resample_np": ((img, CFG.polar_coords, 0.5, -1.0), {}),
        "ccf_table_np": ((polar, ref_polar, CFG.ring_weights), {}),
        "prb1d": ((np.array([0.1, 0.4, 0.8, 1.0, 0.7, 0.3, 0.2]),), {}),
        "align_particle_np": ((img, refs, *geo, 0.5, -0.5, CFG.shift_limit),
                              {"delta": 0.0}),
        "align_particle_shc_np": ((img, refs, *geo, 0.0, 0.0,
                                   CFG.shift_limit, 0.0), {}),
        "transform_np": ((img, 33.0, 1.5, -0.5, 1), {}),
        "quadri_np": ((img, 4.3, 9.7, 4, 10), {}),
        "rot_shift2d_np": ((img, 290.0, -3.0, 17.5), {"scale": 1.1}),
        "mirror_flip_np": ((img,), {}),
        "numrinit": ((1, 7, 2), {"mode": "H"}),
        "ringwe": ((rings,), {}),
        "polar_rings_np": ((img, rings, 0.5, -0.5), {}),
        "ccf_rows_eman_np": ((sbj_rings, ref_rings, oracle.ringwe(rings),
                              rings[-1][1]), {}),
        "align_particle_eman_np": ((img, refs, rings, CFG.shifts), {}),
        "scf_np": ((img,), {}),
        "align_particle_scf_np": ((img, r0, CFG.polar_coords,
                                   CFG.ring_weights, 1, 1, CFG.shift_limit),
                                  {}),
    }[name]


PUBLIC = sorted(n for n in dir(jax_oracle)
                if not n.startswith("_") and callable(getattr(jax_oracle, n))
                and getattr(getattr(jax_oracle, n), "__module__", "")
                == jax_oracle.__name__)


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_oracle_has_the_seventeen_functions():
    assert len(PUBLIC) == 17
    assert PUBLIC == sorted(
        n for n in dir(oracle) if not n.startswith("_")
        and callable(getattr(oracle, n))
        and getattr(getattr(oracle, n), "__module__", "") == oracle.__name__)


@pytest.mark.parametrize("name", PUBLIC)
def test_oracle_copy_equals_jax_oracle(name):
    args, kwargs = _inputs(name)
    _assert_same(getattr(oracle, name)(*args, **kwargs),
                 getattr(jax_oracle, name)(*args, **kwargs))


@pytest.mark.parametrize("chunk", [1, 9])
def test_search_and_decode_match_align_particle_np(chunk):
    """16 particles of two asymmetric templates with accumulated shifts:
    the port's search + decode against the per-particle oracle."""
    nx = 32
    cfg = AlignConfig(img_dim=nx, ring_num=12, ring_len=64, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    refs = asymmetric_templates(2, nx)
    imgs = scattered_stack(refs, 16, max_shift=1, noise=0.05,
                           seed=17)[0].numpy()
    rng = np.random.default_rng(4)
    acc = rng.choice(np.float32([0.0, 1.0, -1.0, 0.5]), (2, 16))
    params = params_from_numpy({
        "angle": np.zeros(16, np.float32), "shift_x": acc[0],
        "shift_y": acc[1], "mirror": np.zeros(16, np.int32),
        "ref_id": np.zeros(16, np.int32)})
    res = rotational_shift_search(torch.as_tensor(imgs),
                                  prepare_ref_spectra(torch.as_tensor(refs),
                                                      cfg),
                                  params, cfg, shift_chunk=chunk)
    new = decode_params(res, params, cfg)
    for i in range(16):
        want = oracle.align_particle_np(
            imgs[i].astype(np.float64), refs.astype(np.float64),
            cfg.polar_coords, cfg.ring_weights, cfg.shifts,
            float(acc[0, i]), float(acc[1, i]), cfg.shift_limit)
        assert int(new.mirror[i]) == want["mirror"], i
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.shift_x[i]) - want["shift_x"]) < 1e-4, i
        assert abs(float(new.shift_y[i]) - want["shift_y"]) < 1e-4, i
        d = abs(float(new.angle[i]) - want["angle"]) % 360.0
        assert min(d, 360.0 - d) < 1e-3, i
