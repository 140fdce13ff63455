from .mref import MrefResult, mref_ali2d  # noqa: F401
from .reffree import RefFreeResult, ali2d_base  # noqa: F401
