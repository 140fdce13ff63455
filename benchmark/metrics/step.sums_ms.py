"""``step.sums_ms``: device ms of the profiled job's ``step.sums`` spans
(each step's transform by the new params and its even/odd class and
centering sums) per ``engine.iterate`` span."""

from spans import span_ms


def read(obs):
    return span_ms("step.sums_ms", "step.sums", device=True,
                   per_iteration=True)
