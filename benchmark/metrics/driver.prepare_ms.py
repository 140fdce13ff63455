"""``driver.prepare_ms``: device ms of the profiled job's
``driver.prepare`` span: the stack's upload from the host array and its
normalisation (reffree: the masked mean taken off) in blocks, as the
drivers' ``prepare_stack`` runs them."""

from spans import span_ms


def read(obs):
    return span_ms("driver.prepare_ms", "driver.prepare", device=True,
                   per_iteration=False)
