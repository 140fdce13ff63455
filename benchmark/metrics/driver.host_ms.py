"""``driver.host_ms``: per iteration, the host-clock time between two
iteration marks of a job less the ``iterate`` time inside it, mean over
the window: the work of ``mref_ali2d`` / ``ali2d_base`` around the
engine (the reference or average update: FSC, filter, centering, the QC
and the params' host copies)."""


def read(obs):
    parts = []
    for _t0, _t1, marks, spans in obs["job_spans"]:
        for a, b in zip(marks, marks[1:]):
            inside = sum(e - s for s, e in spans if a <= s and e <= b)
            parts.append((b - a) - inside)
    if not parts:
        raise RuntimeError("driver.host_ms: no two iteration marks in a job")
    return 1e3 * sum(parts) / len(parts)
