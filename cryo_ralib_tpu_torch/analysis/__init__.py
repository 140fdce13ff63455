"""Exploratory-analysis layer: CTF, poses, dimensionality reduction,
clustering metrics, plots (counterpart of ``cryo_ralib_tpu/analysis``).
``ctf``, ``poses``, ``metrics`` and ``plots`` are numpy copies of the JAX
package's modules; ``reduction`` (MPCA, TwoSDR) runs on torch."""

from .ctf import compute_ctf, ctf_freqs, print_ctf_params  # noqa: F401
from .poses import (  # noqa: F401
    R_from_eman,
    R_from_relion,
    parse_pose_hdf,
    parse_pose_star,
)
from .reduction import MPCA, TwoSDR  # noqa: F401
from .metrics import c_purity_score, matlab2py, purity_score  # noqa: F401
