from .device_loop import (make_device_loop,  # noqa: F401
                          make_mref_device_loop, ref_free_alignment_2d)
from .mref import MrefResult, mref_ali2d  # noqa: F401
from .reffree import RefFreeResult, ali2d_base  # noqa: F401
