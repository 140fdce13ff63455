"""``search.roofline_pct``: the frozen bound of every ``_search`` call of
the traced window (``bound.search_bound`` at the call's shapes) over
its device time from CUDA events around the call, in %."""


def read(obs):
    calls = obs.get("search") or []
    if not calls:
        raise RuntimeError("search.roofline_pct: no _search call was seen")
    return 100.0 * sum(b for b, _ in calls) / sum(t for _, t in calls)
