"""Plotting helpers for the EDA workflow (matplotlib-gated; a copy of
``cryo_ralib_tpu/analysis/plots.py``).

Port of the reference's visualization surface
(src/utils_ralib.py:292-352,388-414): cluster scatter plots, Euler-angle
and defocus distributions, CTF heatmap, image grids.  Import of
matplotlib is deferred so the compute stack has no hard GUI dependency.
"""

from __future__ import annotations

import numpy as np

from .ctf import compute_ctf, ctf_freqs


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _get_colors(k, cmap=None):
    plt = _plt()
    if cmap is not None:
        cm = plt.get_cmap(cmap)
        return [cm(i / float(k)) for i in range(k)]
    colors = ["C{}".format(i) for i in range(10)]
    return [colors[i % len(colors)] for i in range(k)]


def plot_by_cluster(x, y, k, labels, s=10, alpha=0.9, colors=None,
                    cmap=None, ax=None):
    """2D scatter colored by cluster id (src/utils_ralib.py:302-314)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    if colors is None:
        colors = _get_colors(k, cmap)
    labels = np.asarray(labels)
    for i in range(k):
        ii = labels == i
        ax.scatter(np.asarray(x)[ii], np.asarray(y)[ii], s=s, alpha=alpha,
                   label=str(i), color=colors[i])
    return ax


def plot_euler(euler, trans, classes=None, plot_psi=True, plot_trans=True,
               plot_class=False):
    """Histogram the psi angles / translations / class occupancy
    (src/utils_ralib.py:316-344)."""
    plt = _plt()
    n_plots = int(plot_psi) + int(plot_trans) + int(plot_class)
    fig, axes = plt.subplots(1, max(n_plots, 1), figsize=(4 * n_plots, 3))
    axes = np.atleast_1d(axes)
    i = 0
    if plot_psi:
        axes[i].hist(np.asarray(euler)[:, 2], bins=60)
        axes[i].set_title("psi")
        i += 1
    if plot_trans:
        t = np.asarray(trans)
        axes[i].hist2d(t[:, 0], t[:, 1], bins=30)
        axes[i].set_title("translations")
        i += 1
    if plot_class and classes is not None:
        vals, counts = np.unique(np.asarray(classes), return_counts=True)
        axes[i].bar(vals, counts)
        axes[i].set_title("class occupancy")
    return fig


def plot_defocus(ctfs):
    """DefocusU/V scatter (src/utils_ralib.py:346-352)."""
    plt = _plt()
    c = np.asarray(ctfs)
    fig, ax = plt.subplots()
    ax.scatter(c[:, 2], c[:, 3], s=4, alpha=0.5)
    ax.set_xlabel("DefocusU (A)")
    ax.set_ylabel("DefocusV (A)")
    return fig


def plot_ctf(ctf_params):
    """2D CTF heatmap from a 9-element param row
    (src/utils_ralib.py:388-398)."""
    plt = _plt()
    assert len(ctf_params) == 9
    d = int(ctf_params[0])
    apix = float(ctf_params[1])
    c = compute_ctf(ctf_freqs(d, apix), *ctf_params[2:])
    fig, ax = plt.subplots()
    im = ax.imshow(np.asarray(c).reshape(d, d), cmap="RdBu_r")
    fig.colorbar(im, ax=ax)
    return fig


def visualise_images(x, n_images, n_columns, randomise=True, rng=None):
    """Grid of sample images (src/utils_ralib.py:400-414)."""
    plt = _plt()
    x = np.asarray(x)
    indices = np.arange(x.shape[0])
    if randomise:
        (rng or np.random.default_rng()).shuffle(indices)
    indices = indices[:n_images]
    n_rows = int(np.ceil(n_images / n_columns))
    fig = plt.figure(figsize=(2 * n_columns, 2 * n_rows))
    fig.subplots_adjust(left=0, right=1, bottom=0, top=1,
                        hspace=0.05, wspace=0.05)
    for i, e in enumerate(indices):
        ax = fig.add_subplot(n_rows, n_columns, i + 1, xticks=[], yticks=[])
        ax.imshow(x[e], cmap=plt.cm.Greys_r, interpolation="nearest")
    return fig
