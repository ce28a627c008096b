"""Temporal visualizations: trajectories, contributions, network evolution.

Counterpart of :mod:`tame.visualization.temporal`: the same functions,
signatures and content, drawn from host copies of the inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import matplotlib.pyplot as plt
import numpy as np
from matplotlib.figure import Figure

from tame_torch.visualization.static import _finish, _host


def _state_label(k: int, r: int) -> str:
    """Human label for state dimension k in layout [a, b, U_1..r, V_1..r]."""
    if k == 0:
        return "a (sender effect)"
    if k == 1:
        return "b (receiver effect)"
    if k < 2 + r:
        return f"U_{k - 1}"
    return f"V_{k - 1 - r}"


def plot_state_trajectories(X, node_indices: Optional[List[int]] = None,
                            state_indices: Optional[List[int]] = None,
                            figsize: Tuple[int, int] = (12, 8),
                            title: Optional[str] = None,
                            save_path: Optional[str] = None) -> Figure:
    """Per-state-dimension trajectory panels with a/b/U_k/V_k labels."""
    X = _host(X)
    n, T, d = X.shape
    r = (d - 2) // 2
    if node_indices is None:
        node_indices = list(range(min(5, n)))
    if state_indices is None:
        state_indices = list(range(d))

    n_panels = len(state_indices)
    ncols = 2
    nrows = (n_panels + 1) // 2
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize, squeeze=False)
    ts = np.arange(T)
    for panel, k in enumerate(state_indices):
        ax = axes[panel // ncols][panel % ncols]
        for i in node_indices:
            ax.plot(ts, X[i, :, k], lw=1.2, alpha=0.8, label=f"node {i}")
        ax.set_xlabel("Time")
        ax.set_ylabel(_state_label(k, r))
        ax.grid(alpha=0.3)
        if panel == 0:
            ax.legend(fontsize=7, ncol=2)
    for panel in range(n_panels, nrows * ncols):
        axes[panel // ncols][panel % ncols].axis("off")
    if title:
        fig.suptitle(title)
    return _finish(fig, save_path)


def plot_temporal_contributions(additive_contribs, multiplicative_contribs,
                                figsize: Tuple[int, int] = (12, 6),
                                title: Optional[str] = None,
                                save_path: Optional[str] = None) -> Figure:
    """Contribution-over-time and A/M-ratio panels."""
    add = _host(additive_contribs)
    mult = _host(multiplicative_contribs)
    ts = np.arange(len(add))
    fig, axes = plt.subplots(1, 2, figsize=figsize)

    axes[0].plot(ts, add, "o-", label="Additive", color="tab:blue")
    axes[0].plot(ts, mult, "s-", label="Multiplicative", color="tab:orange")
    axes[0].set_xlabel("Time")
    axes[0].set_ylabel("Variance contribution")
    axes[0].set_title("Effect contributions over time")
    axes[0].legend()
    axes[0].grid(alpha=0.3)

    ratio = np.sqrt(np.divide(add, np.maximum(mult, 1e-10)))
    axes[1].plot(ts, ratio, "d-", color="tab:green")
    axes[1].axhline(1.0, color="gray", ls="--", lw=1)
    axes[1].set_xlabel("Time")
    axes[1].set_ylabel("A/M ratio")
    axes[1].set_title("Additive/multiplicative balance")
    axes[1].grid(alpha=0.3)

    if title:
        fig.suptitle(title)
    return _finish(fig, save_path)


def plot_trajectory_comparison(X_true, X_est, node_index: int = 0,
                               state_indices: Optional[List[int]] = None,
                               figsize: Tuple[int, int] = (12, 8),
                               title: Optional[str] = None,
                               save_path: Optional[str] = None) -> Figure:
    """True-vs-estimated trajectory overlay for one node."""
    X_true = _host(X_true)
    X_est = _host(X_est)
    n, T, d = X_true.shape
    r = (d - 2) // 2
    if state_indices is None:
        state_indices = list(range(d))

    ncols = 2
    nrows = (len(state_indices) + 1) // 2
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize, squeeze=False)
    ts = np.arange(T)
    for panel, k in enumerate(state_indices):
        ax = axes[panel // ncols][panel % ncols]
        ax.plot(ts, X_true[node_index, :, k], "o-", color="black",
                label="true", lw=1.5)
        ax.plot(ts, X_est[node_index, :, k], "s--", color="tab:red",
                label="estimated", lw=1.2, alpha=0.8)
        ax.set_xlabel("Time")
        ax.set_ylabel(_state_label(k, r))
        ax.grid(alpha=0.3)
        if panel == 0:
            ax.legend(fontsize=8)
    for panel in range(len(state_indices), nrows * ncols):
        axes[panel // ncols][panel % ncols].axis("off")
    fig.suptitle(title or f"Trajectory comparison: node {node_index}")
    return _finish(fig, save_path)


def plot_network_evolution(Y, time_indices: Optional[List[int]] = None,
                           component: int = 0,
                           figsize: Tuple[int, int] = (15, 4),
                           title: Optional[str] = None,
                           save_path: Optional[str] = None) -> Figure:
    """Grid of network snapshots over time."""
    Y = _host(Y)
    T = Y.shape[2]
    if time_indices is None:
        time_indices = sorted(set(
            int(t) for t in np.linspace(0, T - 1, min(5, T))))
    vmax = float(np.abs(Y[..., component]).max() or 1.0)

    fig, axes = plt.subplots(1, len(time_indices), figsize=figsize,
                             squeeze=False)
    for ax, t in zip(axes[0], time_indices):
        im = ax.imshow(Y[:, :, t, component], cmap="RdBu_r",
                       vmin=-vmax, vmax=vmax)
        ax.set_title(f"t = {t}")
        ax.set_xticks([])
        ax.set_yticks([])
    fig.colorbar(im, ax=axes[0].tolist(), shrink=0.8, label="Edge weight")
    if title:
        fig.suptitle(title)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_latent_trajectory_2d(M, node_indices: Optional[List[int]] = None,
                              plot_type: str = "U",
                              figsize: Tuple[int, int] = (10, 8),
                              title: Optional[str] = None,
                              save_path: Optional[str] = None,
                              projection: Optional[str] = None) -> Figure:
    """2-D latent trajectories with start/end markers and direction arrows;
    requires r = 2.  ``projection="pca"`` lifts the restriction:
    r>2 trajectories are projected onto ONE shared
    top-2 principal-component frame fitted across all (node, time) points
    of the selected block, so paths stay mutually comparable."""
    M = _host(M)  # (n, T, 2r)
    n, T, two_r = M.shape
    r = two_r // 2
    if r != 2 and projection is None:
        raise ValueError(
            f"plot_latent_trajectory_2d requires latent_dim=2, got {r} "
            "(pass projection='pca' for a principal-component frame)")
    if plot_type not in ("U", "V"):
        raise ValueError(f"plot_type must be 'U' or 'V', got {plot_type}")
    sl = slice(0, r) if plot_type == "U" else slice(r, 2 * r)
    if node_indices is None:
        node_indices = list(range(min(5, n)))
    if r != 2:
        from tame_torch.visualization.static import _pca_2d

        flat, _ = _pca_2d(M[:, :, sl].reshape(n * T, r))
        M = flat.reshape(n, T, 2)
        sl = slice(0, 2)

    fig, ax = plt.subplots(figsize=figsize)
    cmap = plt.get_cmap("tab10")
    for idx, i in enumerate(node_indices):
        traj = M[i, :, sl]
        color = cmap(idx % 10)
        ax.plot(traj[:, 0], traj[:, 1], "-", color=color, lw=1.2,
                alpha=0.8, label=f"node {i}")
        ax.scatter(*traj[0], color=color, marker="o", s=80, zorder=3)
        ax.scatter(*traj[-1], color=color, marker="s", s=80, zorder=3)
        if T > 1:
            mid = T // 2
            ax.annotate("", xy=tuple(traj[min(mid + 1, T - 1)]),
                        xytext=tuple(traj[mid]),
                        arrowprops=dict(arrowstyle="->", color=color))
    ax.axhline(0, color="gray", lw=0.5)
    ax.axvline(0, color="gray", lw=0.5)
    ax.set_xlabel(f"{plot_type} dimension 1")
    ax.set_ylabel(f"{plot_type} dimension 2")
    ax.set_title(title or
                 f"Latent {plot_type} trajectories (o = start, sq = end)")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    return _finish(fig, save_path)


def plot_prediction_horizon(mse_by_horizon: Dict[int, float],
                            figsize: Tuple[int, int] = (10, 6),
                            title: Optional[str] = None,
                            save_path: Optional[str] = None) -> Figure:
    """Forecast MSE vs horizon."""
    horizons = sorted(mse_by_horizon)
    mses = [mse_by_horizon[h] for h in horizons]
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(horizons, mses, "o-", color="tab:red", lw=1.5)
    ax.set_xlabel("Prediction horizon (steps ahead)")
    ax.set_ylabel("MSE")
    ax.set_title(title or "Forecast error vs horizon")
    ax.grid(alpha=0.3)
    return _finish(fig, save_path)
