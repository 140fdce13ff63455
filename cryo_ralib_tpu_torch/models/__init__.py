from .mref import MrefResult, mref_ali2d  # noqa: F401
