"""``driver.update_ms``: host ms of the profiled job's ``driver.update``
spans (every iteration's host work outside ``AlignmentEngine.iterate``:
the reference or average update, FSC, filter, the params' host copy,
QC) per ``engine.iterate`` span."""

from spans import span_ms


def read(obs):
    return span_ms("driver.update_ms", "driver.update", device=False,
                   per_iteration=True)
