"""``memory.peak_gib``: ``torch.cuda.max_memory_allocated`` over the
window, the fullest card's, in GiB."""


def read(obs):
    peak = obs["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
