"""Device-memory planning (counterpart of ``cryo_ralib_tpu/parallel``;
the port runs on one device, so only the batch planner is here)."""

from .batching import (StepFootprint, device_memory_bytes, plan_batch_size,
                       step_footprint)

__all__ = ["StepFootprint", "device_memory_bytes", "plan_batch_size",
           "step_footprint"]
