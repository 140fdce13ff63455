"""The program's own spans of the traced window's profiled job, read by
the ``program_span`` metrics: ``cryo_ralib_tpu_torch.utils.profiling``
keeps the spans of the last job recorded under a profile, which in a
``--trace 1`` run is that job alone."""

from __future__ import annotations


def span_ms(metric: str, name: str, device: bool, per_iteration: bool):
    """The ms of the profiled job's spans named ``name`` (device or host
    time), summed, and divided by its ``engine.iterate`` spans where
    ``per_iteration``.  None where the program records no spans (a
    checkout from before them); ``RuntimeError`` where it records spans
    but no job, or no such span, was recorded."""
    from cryo_ralib_tpu_torch.utils import profiling

    last_job = getattr(profiling, "last_job", None)
    if last_job is None:
        return None
    spans = last_job()
    if not spans:
        raise RuntimeError(f"{metric}: no job was recorded")
    picked = [s.device_ms() if device else s.host_ms
              for s in spans if s.name == name]
    iterations = sum(s.name == "engine.iterate" for s in spans)
    if not picked or (per_iteration and not iterations):
        raise RuntimeError(f"{metric}: the recorded job has no {name} "
                           f"span or no engine.iterate span")
    return sum(picked) / (iterations if per_iteration else 1)
