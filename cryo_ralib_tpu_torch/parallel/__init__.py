"""Device-memory planning and data parallelism (counterpart of
``cryo_ralib_tpu/parallel``): the batch planner, and the particle mesh
over ``torch.distributed`` that replaces the JAX ``dp`` and
``('dp', 'ref')`` meshes."""

from .batching import (StepFootprint, device_memory_bytes, plan_batch_size,
                       step_footprint)
from .mesh import (ParticleMesh, StackShard, initialize_distributed,
                   make_mesh, make_mesh_2d, ref_slice, shard_range,
                   shard_stack)

__all__ = ["ParticleMesh", "StackShard", "StepFootprint",
           "device_memory_bytes", "initialize_distributed", "make_mesh",
           "make_mesh_2d", "plan_batch_size", "ref_slice", "shard_range",
           "shard_stack", "step_footprint"]
