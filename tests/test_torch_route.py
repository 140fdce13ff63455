"""The route (``models/steps.py::resolve_route``), on the CPU.

A job decides its search, its class sums and the kernel's plan once: an
``mref_ali2d`` job of several iterations, an ``ali2d_base`` SHC job and a
device loop each resolve their route once, and every step reads it.

The batch planner reads the route in place of a sampler's name; every
byte it charges is held here to the values it gave at the rib80s
geometry (90 px, R=36, 7 x 7 shifts, 105,247 particles) before it read
routes: the resident and the streamed footprints and the plans under a
2 and a 16 GiB limit, for each search under each ``random_method`` it
runs, at K = 1, 8 and 64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryo_ralib_tpu_torch.config import AlignConfig
from cryo_ralib_tpu_torch.models import device_loop, engine, mref, reffree
from cryo_ralib_tpu_torch.models import steps
from cryo_ralib_tpu_torch.parallel import batching
from cryo_ralib_tpu_torch.params import AlignParams
from cryo_ralib_tpu_torch.utils.log import RunLogger
from cryo_ralib_tpu_torch.utils.synthetic import (asymmetric_templates,
                                                  scattered_stack)
from tests.torch_template_common import one_torch_thread  # noqa: F401

NX, N, K = 32, 16, 2


@pytest.fixture
def resolutions(monkeypatch):
    """The sampler names resolved, wherever the resolver is called from."""
    calls = []
    orig = steps.resolve_route

    def counted(sampler, *a, **k):
        calls.append(sampler)
        return orig(sampler, *a, **k)

    for mod in (steps, engine, mref, reffree, device_loop):
        monkeypatch.setattr(mod, "resolve_route", counted, raising=False)
    return calls


def _stack(k=K):
    tmpl = asymmetric_templates(k, NX)
    imgs = scattered_stack(tmpl, N, max_shift=1, noise=0.05, seed=5)[0]
    return imgs.numpy(), tmpl


def _mref():
    imgs, tmpl = _stack()
    mref.mref_ali2d(imgs, tmpl, ou=12, xr=1, ts=1, maxit=3, device="cpu",
                    log=RunLogger(None, quiet=True))


def _reffree_shc():
    imgs, _ = _stack(1)
    reffree.ali2d_base(imgs, ou=12, xr=1, ts=1, maxit=3, device="cpu",
                       random_method="SHC", log=RunLogger(None, quiet=True))


def _device_loop():
    imgs, tmpl = _stack()
    cfg = AlignConfig(img_dim=NX, ring_num=12, shift_rng_x=1.0,
                      shift_rng_y=1.0)
    loop = device_loop.make_mref_device_loop(cfg, 3, K, np.full(3, 0.25),
                                             device="cpu")
    loop(torch.as_tensor(imgs), tmpl, AlignParams.zeros(N, "cpu"),
         torch.arange(N), torch.ones(N))


@pytest.mark.parametrize("job", [_mref, _reffree_shc, _device_loop],
                         ids=["mref", "reffree_shc", "device_loop"])
def test_a_job_resolves_its_route_once(job, resolutions):
    job()
    assert resolutions == ["auto"]


# (search, random_method, K, resident total, streamed total at 16384,
#  plan at 2 GiB, plan at 16 GiB), from the planner before it read routes
RIB80S = [
    ("kernel", "", 1, 5784307912, 3336854232, 1024, 105247),
    ("kernel", "SHC", 1, 5784307912, 3336854232, 1024, 105247),
    ("kernel", "SCF", 1, 6951284540, 3867695832, 1024, 105247),
    ("plain", "", 1, 100523866312, 16180271832, 128, 1024),
    ("plain", "SHC", 1, 100523866312, 16180271832, 128, 1024),
    ("plain", "SCF", 1, 103933869112, 16711113432, 128, 1024),
    ("template", "", 1, 6993743336, 4546289656, 1024, 105247),
    ("template", "SHC", 1, 6993743336, 4546289656, 1024, 105247),
    ("matmul", "", 1, 8142672808, 5509673184, 128, 105247),
    ("matmul", "SHC", 1, 8142672808, 5509673184, 128, 105247),
    ("matmul", "SCF", 1, 11552675608, 6040514784, 128, 105247),
    ("kernel", "", 8, 5786220088, 3339220008, 1024, 105247),
    ("kernel", "SCF", 8, 6953196716, 3870061608, 1024, 105247),
    ("plain", "", 8, 100525778488, 16182637608, 128, 1024),
    ("plain", "SHC", 8, 100525778488, 16182637608, 128, 1024),
    ("plain", "SCF", 8, 103935781288, 16713479208, 128, 1024),
    ("template", "", 8, 6999382872, 4552382792, 1024, 105247),
    ("template", "SHC", 8, 6999382872, 4552382792, 1024, 105247),
    ("matmul", "", 8, 8142127480, 5509581456, 128, 105247),
    ("matmul", "SHC", 8, 8142127480, 5509581456, 128, 105247),
    ("matmul", "SCF", 8, 11552130280, 6040423056, 128, 105247),
    ("kernel", "", 64, 5801517496, 3358146216, 1024, 105247),
    ("kernel", "SCF", 64, 6968494124, 3888987816, 1024, 105247),
    ("plain", "", 64, 100541075896, 16201563816, 128, 1024),
    ("plain", "SHC", 64, 100541075896, 16201563816, 128, 1024),
    ("plain", "SCF", 64, 103951078696, 16732405416, 128, 1024),
    ("template", "", 64, 9114333576, 5503657928, 1, 105247),
    ("template", "SHC", 64, 9114333576, 5503657928, 1, 105247),
    ("matmul", "", 64, 8142517072, 5513599848, 64, 105247),
    ("matmul", "SHC", 64, 8142517072, 5513599848, 64, 105247),
    ("matmul", "SCF", 64, 11552519872, 6044441448, 64, 105247),
]
# the eman2 rings at K=8, which only the plain and matmul searches take
RIB80S_EMAN2 = [
    ("plain", "", 8, 20307359288, 16182637608, 1024, 8192),
    ("matmul", "", 8, 8206561144, 5574015120, 256, 105247),
]
N_RIB80S = 105247


@pytest.mark.parametrize(
    "search,method,k,resident,streamed,plan_2g,plan_16g,scheme",
    [(*c, "cuda") for c in RIB80S] + [(*c, "eman2") for c in RIB80S_EMAN2])
def test_the_planner_charges_each_route_what_it_charged(
        search, method, k, resident, streamed, plan_2g, plan_16g, scheme):
    cfg = AlignConfig(img_dim=90, ring_num=36, ring_len=256, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0, ring_scheme=scheme)
    # the route as a CUDA device resolves it, its sums and plan included
    # (the plain search as "plain" asks for it there)
    route = steps.resolve_route(search, "cuda", cfg, method, n_refs=k)
    assert (route.search, route.refs, route.method) == (search, k, method)
    assert route.sums == ("shear" if search in ("template", "matmul")
                          else "kernel")
    assert batching.step_footprint(N_RIB80S, route, cfg).total == resident
    assert batching.step_footprint(16384, route, cfg,
                                   streamed=True).total == streamed
    assert [batching.plan_batch_size(N_RIB80S, route, cfg, limit_bytes=lim)
            for lim in (2 ** 31, 2 ** 34)] == [plan_2g, plan_16g]
