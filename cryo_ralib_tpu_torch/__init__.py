"""cryo_ralib_tpu_torch — the PyTorch/CUDA port of ``cryo_ralib_tpu``.

Same module layout and names as the JAX package, so every function has
its counterpart at the same path.  Plain tensor code is PyTorch; the
search hot loop is a hand-written CUDA kernel for Hopper (``csrc/``,
built with ``nvcc`` at first use, see ``ops/fused_search.py``) with a
plain PyTorch twin that runs on the CPU.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
never ``cryo_ralib_tpu``; the numpy-only modules it shares with the JAX
package (``config``, ``rings``, ``ops/fsc``, ``io/star``, the host
helpers of ``ops/fourvar``) are copies, held against their originals by
the tests.
"""

from .config import AlignConfig  # noqa: F401
from .params import AlignParams  # noqa: F401

__version__ = "0.1.0"
