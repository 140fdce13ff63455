"""``driver.refs_ms``: host ms of the profiled job's ``driver.refs``
spans (``mref_ali2d``'s per-class reference update on the host:
reseeding, FSC, the average, the user function's filter and the mask
normalisation of each class) per ``engine.iterate`` span; nothing from
a program that does not declare the span."""

from declared import declared
from spans import span_ms


def read(obs):
    if not declared("driver.refs"):
        return None
    return span_ms("driver.refs_ms", "driver.refs", device=False,
                   per_iteration=True)
