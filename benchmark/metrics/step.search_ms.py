"""``step.search_ms``: device ms of the profiled job's ``step.search``
spans (the search of every step: the kernel, the PyTorch search or
SHC's) per ``engine.iterate`` span."""

from spans import span_ms


def read(obs):
    return span_ms("step.search_ms", "step.search", device=True,
                   per_iteration=True)
