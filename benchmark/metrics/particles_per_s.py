"""``particles_per_s``: particles times iterations of every job in the
window, over the window's wall seconds (host clock)."""


def read(obs):
    return obs["n"] * obs["iterations"] / obs["window_s"]
