"""Particle-axis data parallelism over ``torch.distributed`` (counterpart
of ``cryo_ralib_tpu/parallel/mesh.py``).

The reference scales with MPI over GPUs: the particle range is split in
blocks by ``MPI_start_end``, every rank aligns its block, the class sums
are reduced and the new references broadcast (SURVEY.md §2.3).  The JAX
package puts one ``dp`` mesh axis over the chips instead.  Here it is
one process per card, one rank per process: ``ParticleMesh`` names the
rank, the world size, the rank's device, the backend and the group, and
the drivers take it as ``mesh=``.  Each rank holds the block of
particles ``shard_range`` gives it, with their global indices (so the
even/odd split of the class sums is the single-process one); the class
sums, counts and centering sums are all-reduced once per iteration,
rank 0 updates the references on the host and broadcasts them, and the
per-particle params are gathered to full length where a table or a
checkpoint needs them.  Ranks are not lock-stepped, so no stack is
padded: only the reduced tensors have equal shapes on every rank.

The backend is chosen by a rule, never by catching a failure:

* ``"cpu:gloo,cuda:nccl"`` when every rank of a host has a card of its
  own: CUDA tensors (the class sums) go through NCCL, CPU tensors (the
  params gather, the references) through gloo;
* ``"gloo"`` when ranks share a card (NCCL refuses two ranks on one
  device; gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``,
  staging them through the host) and on the CPU.

A rank's device is ``cuda:{LOCAL_RANK % device_count}`` unless the caller
asks for the CPU.  Every collective runs under the process group's
``timeout``, so a rank that dies fails the others instead of hanging
them.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..params import AlignParams

_log = logging.getLogger(__name__)

# seconds a collective may wait for the slowest rank (the first
# iteration of a rank builds or loads the kernel library)
DEFAULT_TIMEOUT = 300.0


@dataclass(frozen=True)
class ParticleMesh:
    """One rank's view of the data-parallel group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object = None        # None: the default (world) group
    ranks_on_device: int = 1    # ranks that share this rank's device

    @property
    def is_root(self) -> bool:
        return self.rank == 0


_current: ParticleMesh | None = None


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank ``local_rank`` of its host: the CPU where
    asked, else ``cuda:{local_rank % device_count}``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} needs CUDA, which is not available here; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, ranks_per_host: int) -> str:
    """The backend rule: NCCL for CUDA tensors where each rank of a host
    has a card of its own, gloo where ranks share a card and on the
    CPU."""
    if device.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize_distributed(rank: int | None = None,
                           world_size: int | None = None,
                           local_rank: int | None = None,
                           init_method: str | None = None,
                           device="cuda",
                           timeout: float = DEFAULT_TIMEOUT) -> ParticleMesh:
    """Join the process group and return this rank's ``ParticleMesh``.

    Thin wrapper over ``torch.distributed.init_process_group``.  Under
    ``torchrun`` (``python -m torch.distributed.run``) ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT`` come from the environment; a caller
    that starts the processes itself passes ``rank``, ``world_size`` and
    ``init_method`` (``tcp://localhost:<port>`` or ``file://<path>``).
    ``device`` "cuda" puts the rank on ``cuda:{local_rank %
    device_count}`` (set as the current device before any kernel is
    loaded); "cpu" keeps it on the CPU.  Each rank takes its share of the
    host's cores as torch's thread count.  ``timeout`` (seconds) bounds
    every collective.
    """
    global _current
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    per_host = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if init_method is None:
        if "MASTER_ADDR" not in env:
            raise ValueError("initialize_distributed needs init_method= "
                             "or torchrun's MASTER_ADDR/MASTER_PORT")
        init_method = "env://"
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, per_host)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    # the ranks of a host share its cores: each takes its part, or their
    # thread pools oversubscribe the host (torchrun sets one thread)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // per_host))
    if dev.type == "cuda":
        n_dev = torch.cuda.device_count()
        sharing = sum(1 for r in range(per_host)
                      if r % n_dev == local_rank % n_dev)
    else:
        sharing = per_host
    _current = ParticleMesh(rank, world_size, dev, backend, None, sharing)
    _log.info("process group: rank %d of %d on %s, backend %s (%d rank(s) "
              "on this device)", rank, world_size, dev, backend, sharing)
    return _current


def make_mesh(n_devices: int | None = None) -> ParticleMesh:
    """The ``ParticleMesh`` of the process group that
    ``initialize_distributed`` joined; ``n_devices``, where given, must
    be its world size (one rank per device)."""
    if _current is None or not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first (or run under torchrun)")
    if n_devices is not None and int(n_devices) != _current.world_size:
        raise ValueError(f"a mesh of {n_devices} devices in a process group "
                         f"of {_current.world_size} ranks")
    return _current


def shutdown():
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``)."""
    global _current
    if dist.is_initialized():
        dist.destroy_process_group()
    _current = None


def block_range(n: int, world_size: int, rank: int) -> tuple[int, int]:
    """[start, stop) of ``rank``'s block of ``n`` particles: the
    reference's ``MPI_start_end``, ``int(round(n / world * rank))`` with
    halves rounded up, in integers."""
    def edge(r):
        return (2 * n * r + world_size) // (2 * world_size)
    return edge(rank), edge(rank + 1)


def shard_range(n: int, mesh: ParticleMesh | None) -> tuple[int, int]:
    """The rank's [start, stop) of a stack of ``n``; the whole stack
    without a mesh."""
    if mesh is None:
        return 0, n
    return block_range(n, mesh.world_size, mesh.rank)


@dataclass(frozen=True)
class StackShard:
    """Rows ``start .. start+len(local)-1`` of a stack of ``n`` particles:
    what one rank holds (``cli.common.load_stack`` reads only these under
    a mesh).  ``shape`` is the whole stack's, so a driver sizes its run
    from it as from a full array."""

    local: object
    start: int
    n: int

    @property
    def shape(self) -> tuple:
        return (self.n,) + tuple(self.local.shape[1:])


def shard_stack(images, mesh: ParticleMesh | None):
    """(the rank's rows of ``images``, their global indices as an int64
    CPU tensor).  ``images`` is the whole stack (numpy or a tensor) or a
    ``StackShard`` of the rank's block."""
    n = int(images.shape[0])
    start, stop = shard_range(n, mesh)
    if isinstance(images, StackShard):
        got = (images.start, images.start + int(images.local.shape[0]))
        if got != (start, stop):
            raise ValueError(f"a shard of rows {got[0]}..{got[1] - 1} where "
                             f"rank {mesh.rank if mesh else 0} holds "
                             f"{start}..{stop - 1}")
        local = images.local
    else:
        local = images[start:stop]
    return local, torch.arange(start, stop)


def _multi(mesh) -> bool:
    return mesh is not None and mesh.world_size > 1


def all_reduce_sums(mesh: ParticleMesh | None, *tensors):
    """Sum each tensor over the ranks, in place, where it lies (CUDA
    tensors through NCCL or gloo, CPU tensors through gloo)."""
    if _multi(mesh):
        for t in tensors:
            dist.all_reduce(t, group=mesh.group)
    return tensors


def barrier(mesh: ParticleMesh | None):
    """Wait for every rank (a gloo all-reduce of one CPU number, so it
    needs no device)."""
    if _multi(mesh):
        dist.all_reduce(torch.zeros(1), group=mesh.group)


def broadcast_refs(refs, mesh: ParticleMesh | None, src: int = 0):
    """``src``'s array (numpy, e.g. the (K, H, W) references) on every
    rank; the others pass an array of the same shape and dtype, whose
    values are not read.  Host data goes through gloo."""
    if not _multi(mesh):
        return refs
    t = torch.from_numpy(np.ascontiguousarray(refs).copy())
    dist.broadcast(t, src, group=mesh.group)
    return t.numpy()


def broadcast_status(code: int, mesh: ParticleMesh | None) -> int:
    """Rank 0's integer (an exit status) on every rank."""
    if not _multi(mesh):
        return int(code)
    t = torch.tensor([int(code)], dtype=torch.int64)
    dist.broadcast(t, 0, group=mesh.group)
    return int(t)


def gather_rows(x: torch.Tensor, n: int, mesh: ParticleMesh | None):
    """The (n, ...) concatenation of every rank's block of rows of a stack
    of ``n`` (each rank passes its own ``shard_range`` rows), on every
    rank, as a CPU tensor; blocks are padded to the largest for the
    ``all_gather`` and cut again."""
    x = x.detach().cpu()
    if not _multi(mesh):
        return x
    sizes = [b - a for a, b in (block_range(n, mesh.world_size, r)
                                for r in range(mesh.world_size))]
    width = max(sizes)
    pad = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype)
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in sizes]
    dist.all_gather(parts, pad, group=mesh.group)
    return torch.cat([p[:m] for p, m in zip(parts, sizes)])


def gather_params(params: AlignParams, n: int,
                  mesh: ParticleMesh | None) -> AlignParams:
    """Every rank's block of AlignParams, concatenated to the whole stack
    of ``n`` on every rank, as numpy arrays: one ``all_gather`` of the
    five fields packed as int32 bits."""
    fields = [torch.as_tensor(np.asarray(f) if not torch.is_tensor(f)
                              else f).cpu() for f in params]
    packed = torch.stack([f.contiguous().view(torch.int32) for f in fields],
                         dim=1)
    full = gather_rows(packed, n, mesh)
    return AlignParams(*[full[:, i].contiguous().view(f.dtype).numpy()
                         for i, f in enumerate(fields)])


def block_owner(i: int, n: int, mesh: ParticleMesh | None) -> int:
    """The rank whose block of a stack of ``n`` holds particle ``i``."""
    if mesh is None:
        return 0
    for r in range(mesh.world_size):
        if i < block_range(n, mesh.world_size, r)[1]:
            return r
    raise IndexError(f"particle {i} of a stack of {n}")
