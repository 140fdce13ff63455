"""Clustering quality metrics (a copy of
``cryo_ralib_tpu/analysis/metrics.py``).

Port of ``purity_score`` / ``c_purity_score`` / ``matlab2py``
(reference src/utils_ralib.py:416-433), with the contingency matrix
built in plain numpy instead of sklearn.
"""

from __future__ import annotations

import numpy as np


def contingency_matrix(y_true, y_pred) -> np.ndarray:
    """(n_true_classes, n_pred_clusters) co-occurrence counts
    (sklearn ``metrics.cluster.contingency_matrix`` equivalent)."""
    t_vals, t_idx = np.unique(np.asarray(y_true), return_inverse=True)
    p_vals, p_idx = np.unique(np.asarray(y_pred), return_inverse=True)
    m = np.zeros((len(t_vals), len(p_vals)), np.int64)
    np.add.at(m, (t_idx, p_idx), 1)
    return m


def purity_score(y_true, y_pred) -> float:
    """Cluster purity: every predicted cluster votes for its majority true
    class (src/utils_ralib.py:423-427)."""
    m = contingency_matrix(y_true, y_pred)
    return float(np.sum(np.amax(m, axis=0)) / np.sum(m))


def c_purity_score(y_true, y_pred) -> float:
    """Class purity: every true class votes for its majority cluster
    (src/utils_ralib.py:429-433)."""
    m = contingency_matrix(y_true, y_pred)
    return float(np.sum(np.amax(m, axis=1)) / np.sum(m))


def matlab2py(i_matrix):
    """Axis-order fix for MATLAB-exported stacks
    (src/utils_ralib.py:416-418)."""
    tmp = np.swapaxes(i_matrix, 0, 2)
    return np.swapaxes(tmp, 1, 2).copy()
