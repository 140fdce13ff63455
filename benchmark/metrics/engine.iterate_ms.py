"""``engine.iterate_ms``: host-clock ms of ``AlignmentEngine.iterate``,
mean over every call of the window (the call ends in a host read, so
it is synchronised; rank 0's on four ranks)."""


def read(obs):
    calls = obs["iterate_s"]
    if not calls:
        raise RuntimeError("engine.iterate_ms: no iterate call was seen")
    return 1e3 * sum(calls) / len(calls)
