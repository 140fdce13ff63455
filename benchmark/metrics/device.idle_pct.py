"""``device.idle_pct``: the share of one profiled job's span in which no
kernel, copy or memset ran on the card, in %; on several ranks the
ranks' mean busy time over the mean of their jobs' spans (an NCCL
kernel that waits for a slower rank counts as busy)."""


def read(obs):
    t = obs.get("trace")
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
