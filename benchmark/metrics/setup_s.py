"""``setup_s``: seconds from the process's start to the window's: the
CUDA context, the seeded inputs, the kernel's build or load and the
warm-up (host clock; on four ranks from the launcher's start)."""


def read(obs):
    return obs["setup_s"]
