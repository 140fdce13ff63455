"""Multilinear PCA and two-stage dimension reduction for aligned stacks
(PyTorch).

Counterpart of ``cryo_ralib_tpu/analysis/reduction.py`` (the reference's
``MPCA`` / ``TwoSDR``, src/utils_ralib.py:436-564, used by notebook 03
before clustering): the alternating row/column subspace iteration over
an (N, p, q) aligned particle stack.  Every scatter matrix is an einsum
over the stack on the device and the eigendecompositions are dense
``torch.linalg.eigh`` of the small (p, p) / (q, q) matrices; only the
captured energy (one number per iteration, for the stop rule) and the
final factors come back to the host.  Each call logs its iterations
(``logging``, logger ``cryo_ralib_tpu_torch.analysis.reduction``).

Eigenvectors are defined up to sign, and eigenvectors of near-equal
eigenvalues up to a rotation inside their subspace: two libraries agree
on the subspaces and on the factors up to the sign of each column.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

_log = logging.getLogger(__name__)


def _top_eigvecs(S, k: int):
    """Top-k eigenpairs of a small symmetric matrix, descending."""
    w, v = torch.linalg.eigh(S)   # ascending
    return w.flip(0)[:k], v.flip(1)[:, :k]


def _alternate(X, p0: int, q0: int, iters: int = 30, tol: float = 1e-7):
    """Alternating projection subspace iteration shared by MPCA/TwoSDR.

    X: (n, p, q) centered stack.  Returns (At (p, p0), Bt (q, q0),
    iterations run).  Stops when the captured energy gain per sample
    drops below ``tol`` (the reference's ``rss`` criterion), an absolute
    threshold, so f32 rounding can stop two libraries one iteration
    apart.
    """
    n = X.shape[0]
    SA = torch.einsum("npq,npr->qr", X, X)    # column scatter (q, q)
    At = Bt = None
    prev_energy = None
    it = 0
    for it in range(1, iters + 1):
        _, Bt = _top_eigvecs(SA, q0)               # (q, q0)
        XB = torch.einsum("npq,qb->npb", X, Bt)    # (n, p, q0)
        SB = torch.einsum("npb,nrb->pr", XB, XB)   # row scatter (p, p)
        _, At = _top_eigvecs(SB, p0)               # (p, p0)
        XA = torch.einsum("npq,pa->naq", X, At)    # (n, p0, q)
        SA = torch.einsum("naq,nar->qr", XA, XA)
        # captured energy |At^T X Bt|^2 per sample
        energy = float((_core(X, At, Bt) ** 2).sum()) / n
        if prev_energy is not None and energy - prev_energy < tol:
            break
        prev_energy = energy
    return At, Bt, it


def _core(X, At, Bt):
    """(n, p0, q0) cores ``At^T X_i Bt``."""
    return torch.einsum("npq,qb->npb", torch.einsum("npq,pa->naq", X, At),
                        Bt)


def _centered(arr, device):
    """The stack as float32 on ``device`` (CUDA raises where there is
    none), its (p*q,) mean, and the stack minus the mean."""
    from ..models.engine import resolve_device

    dev = resolve_device(device)
    arr = torch.as_tensor(np.asarray(arr, np.float32), device=dev)
    n, p, q = arr.shape
    mY = arr.reshape(n, p * q).mean(0)
    return mY, arr - mY.reshape(p, q)[None]


def MPCA(arr, p0: int, q0: int, device="cuda"):
    """Multilinear PCA: project each image onto the top p0 x q0 row/column
    subspaces.

    Returns numpy (factors (n, p0*q0), At (p, p0), Bt (q, q0), mean
    (p*q,)) with the reference's ``Y @ kron(At, Bt)`` factor ordering:
    factors[i, a*q0+b] = (At^T X_i Bt)[a, b].  Runs on ``device``, the
    GPU unless the caller passes ``device="cpu"``.
    """
    mY, X = _centered(arr, device)
    At, Bt, it = _alternate(X, p0, q0)
    _log.info("MPCA(%d, %d): %d iterations", p0, q0, it)
    factors = _core(X, At, Bt).reshape(X.shape[0], p0 * q0)
    return tuple(t.cpu().numpy() for t in (factors, At, Bt, mY))


def TwoSDR(arr, p0: int, q0: int, r: int, device="cuda"):
    """Two-stage dimension reduction: MPCA to p0 x q0, then a rank-r PCA
    of the cores (the reference's src/utils_ralib.py:497-564).

    Returns numpy (factors (n, r), Gt (p0*q0, r), At, Bt, mean) matching
    the reference's ``Y @ (kron(At, Bt) @ Gt)``.  Runs on ``device``,
    the GPU unless the caller passes ``device="cpu"``.
    """
    mY, X = _centered(arr, device)
    At, Bt, it = _alternate(X, p0, q0)
    _log.info("TwoSDR(%d, %d, %d): %d iterations", p0, q0, r, it)
    core = _core(X, At, Bt).reshape(X.shape[0], p0 * q0)
    # top-r left singular vectors of core.T (p0q0, n), descending: eigh
    # of the small (p0q0, p0q0) gram matrix
    _, Gt = _top_eigvecs(core.T @ core, r)
    return tuple(t.cpu().numpy() for t in (core @ Gt, Gt, At, Bt, mY))
