"""``step.search_interior_pct``: the share of the search kernel's ring
samplings (one ring at one shift) that took its unclamped path, in %:
the ``interior_rings`` of the profiled job's ``step.search`` spans over
their ``rings_full`` (under SHC, the samplings of the shift groups run).
Nothing where no span carries the count: a checkout whose kernel does
not count, or a job that searched off the kernel."""


def read(obs):
    from cryo_ralib_tpu_torch.utils import profiling

    last_job = getattr(profiling, "last_job", None)
    if last_job is None:
        return None
    counts = [s.attrs for s in last_job() if s.name == "step.search"]
    counts = [a for a in counts if "interior_rings" in a]
    full = sum(a["rings_full"] for a in counts)
    if not full:
        return None
    return 100.0 * sum(a["interior_rings"] for a in counts) / full
