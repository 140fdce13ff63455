"""``step.search_roofline_pct``: the frozen bound (``bound.search_bound``)
of every ``step.search`` span of the profiled job, at the span's own
particles, box, rings, shifts, references and mirror channels, over the
spans' device ms, in %; nothing from a program that does not declare
the spans' size counters (they came with ``SPANS``)."""

from bound import search_bound
from declared import declared

SIZE = ("N", "box", "rings", "shifts", "K", "mirrors")


def read(obs):
    if not declared("step.search"):
        return None
    from cryo_ralib_tpu_torch.utils import profiling

    spans = profiling.last_job()
    if not spans:
        raise RuntimeError("step.search_roofline_pct: no job was recorded")
    searches = [s for s in spans if s.name == "step.search"]
    if not searches:
        raise RuntimeError("step.search_roofline_pct: the recorded job has "
                           "no step.search span")
    bound_ms = device_ms = 0.0
    for s in searches:
        size = s.attrs
        missing = [a for a in SIZE if a not in size]
        if missing:
            raise RuntimeError("step.search_roofline_pct: a step.search "
                               f"span lacks {', '.join(missing)}")
        bound_ms += search_bound(*(int(size[a]) for a in SIZE))[0]
        device_ms += s.device_ms()
    return 100.0 * bound_ms / device_ms
