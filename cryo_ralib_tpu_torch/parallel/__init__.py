"""Device-memory planning and data parallelism (counterpart of
``cryo_ralib_tpu/parallel``): the batch planner, and the particle mesh
over ``torch.distributed`` that replaces the JAX ``dp`` mesh."""

from .batching import (StepFootprint, device_memory_bytes, plan_batch_size,
                       step_footprint)
from .mesh import (ParticleMesh, StackShard, initialize_distributed,
                   make_mesh, shard_range, shard_stack)

__all__ = ["ParticleMesh", "StackShard", "StepFootprint",
           "device_memory_bytes", "initialize_distributed", "make_mesh",
           "plan_batch_size", "shard_range", "shard_stack", "step_footprint"]
