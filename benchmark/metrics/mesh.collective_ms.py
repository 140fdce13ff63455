"""``mesh.collective_ms``: device ms of the profiled job's
``mesh.collective`` spans on rank 0 (the class sums' all-reduce, the
params' gather and the references' broadcast) per ``engine.iterate``
span.  A collective's device time holds rank 0's wait for the slowest
rank.  Nothing from a program that does not declare the span;
``RuntimeError`` where it does and the job recorded none (a mesh job
records one at least every iteration)."""

from declared import declared
from spans import span_ms


def read(obs):
    if not declared("mesh.collective"):
        return None
    return span_ms("mesh.collective_ms", "mesh.collective", device=True,
                   per_iteration=True)
