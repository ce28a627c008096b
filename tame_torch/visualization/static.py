"""Static visualizations: convergence, networks, latent spaces, residuals.

Counterpart of :mod:`tame.visualization.static`: the same functions,
signatures and figure content, drawn with matplotlib from host copies of
the inputs (:func:`_host`) — plotting is not device work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import matplotlib.pyplot as plt
import numpy as np
import torch
from matplotlib.figure import Figure
from scipy import stats


def _host(x) -> np.ndarray:
    """A numpy copy of ``x`` for drawing: tensors on any device, also ones
    that require grad, are detached and copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _finish(fig: Figure, save_path: Optional[str]) -> Figure:
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_convergence(history: Dict[str, List[float]],
                     figsize: Tuple[int, int] = (12, 5),
                     title: Optional[str] = None,
                     save_path: Optional[str] = None) -> Figure:
    """ELBO + reconstruction-error convergence panels."""
    fig, axes = plt.subplots(1, 2, figsize=figsize)

    elbo = history.get("elbo", [])
    if elbo:
        axes[0].plot(elbo, color="tab:blue", lw=1.5)
    axes[0].set_xlabel("Iteration")
    axes[0].set_ylabel("ELBO")
    axes[0].set_title("ELBO Convergence")
    axes[0].grid(alpha=0.3)

    mse = history.get("reconstruction_error", [])
    if mse:
        axes[1].plot(mse, color="tab:red", lw=1.5)
    axes[1].set_xlabel("Iteration")
    axes[1].set_ylabel("Reconstruction MSE")
    axes[1].set_title("Reconstruction Error")
    axes[1].grid(alpha=0.3)

    if title:
        fig.suptitle(title)
    return _finish(fig, save_path)


def plot_network(Y, time_index: Optional[int] = None, component: int = 0,
                 figsize: Tuple[int, int] = (8, 7),
                 title: Optional[str] = None,
                 save_path: Optional[str] = None, cmap: str = "RdBu_r",
                 vmin: Optional[float] = None,
                 vmax: Optional[float] = None) -> Figure:
    """Adjacency heatmap of one network snapshot."""
    Y = _host(Y)
    if Y.ndim == 4:  # temporal (n, n, T, 2)
        t = 0 if time_index is None else time_index
        mat = Y[:, :, t, component]
    else:  # static (n, n, 2)
        mat = Y[:, :, component]

    if vmax is None:
        vmax = float(np.abs(mat).max() or 1.0)
    if vmin is None:
        vmin = -vmax

    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(mat, cmap=cmap, vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax, label="Edge weight")
    ax.set_xlabel("Receiver node")
    ax.set_ylabel("Sender node")
    ax.set_title(title or "Network adjacency")
    return _finish(fig, save_path)


def _pca_2d(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Top-2 principal-component projection of (m, r) points; returns
    (projected (m, 2), explained-variance fractions (2,)).  r=1 input is
    padded with a zero second axis (the 1-D latent line)."""
    c = pts - pts.mean(0)
    _, s, vt = np.linalg.svd(c, full_matrices=False)
    denom = max(float((s ** 2).sum()), 1e-12)
    proj = c @ vt[:2].T
    ev = (s[:2] ** 2) / denom
    if proj.shape[1] < 2:
        proj = np.concatenate([proj, np.zeros_like(proj)], axis=1)
        ev = np.concatenate([ev, np.zeros(2 - len(ev))])
    return proj, ev


def plot_latent_space(M, labels: Optional[np.ndarray] = None,
                      time_index: Optional[int] = None,
                      plot_U: bool = True, plot_V: bool = True,
                      figsize: Tuple[int, int] = (10, 5),
                      title: Optional[str] = None,
                      save_path: Optional[str] = None,
                      projection: Optional[str] = None) -> Figure:
    """2-D scatter of latent sender/receiver positions; requires r = 2.

    ``projection="pca"`` lifts the r=2 restriction: r>2 positions are
    projected onto their top-2 principal components per panel, with
    explained variance in the axis labels."""
    M = _host(M)
    if M.ndim == 3:  # (n, T, 2r)
        t = 0 if time_index is None else time_index
        M = M[:, t, :]
    r = M.shape[1] // 2
    if r != 2 and projection is None:
        raise ValueError(
            f"plot_latent_space requires latent_dim=2, got {r} "
            "(pass projection='pca' to plot the top-2 principal "
            "components)")

    n_panels = int(plot_U) + int(plot_V)
    if n_panels == 0:
        raise ValueError("At least one of plot_U/plot_V must be True")
    fig, axes = plt.subplots(1, n_panels, figsize=figsize, squeeze=False)
    axes = axes[0]

    panel = 0
    for flag, sl, name in ((plot_U, slice(0, r), "U (sender)"),
                           (plot_V, slice(r, 2 * r), "V (receiver)")):
        if not flag:
            continue
        ax = axes[panel]
        pts = M[:, sl]
        xlab, ylab = "Dimension 1", "Dimension 2"
        if pts.shape[1] != 2:
            pts, ev = _pca_2d(pts)
            xlab, ylab = (f"PC1 ({ev[0]:.0%} var)",
                          f"PC2 ({ev[1]:.0%} var)")
        ax.scatter(pts[:, 0], pts[:, 1], s=60, alpha=0.8,
                   c=np.arange(len(pts)), cmap="viridis")
        for i, (x, y) in enumerate(pts):
            lbl = str(labels[i]) if labels is not None else str(i)
            ax.annotate(lbl, (x, y), fontsize=8,
                        xytext=(3, 3), textcoords="offset points")
        ax.axhline(0, color="gray", lw=0.5)
        ax.axvline(0, color="gray", lw=0.5)
        ax.set_xlabel(xlab)
        ax.set_ylabel(ylab)
        ax.set_title(name)
        ax.grid(alpha=0.3)
        panel += 1

    if title:
        fig.suptitle(title)
    return _finish(fig, save_path)


def plot_contribution_breakdown(additive_contrib: float,
                                multiplicative_contrib: float,
                                figsize: Tuple[int, int] = (8, 6),
                                title: Optional[str] = None,
                                save_path: Optional[str] = None) -> Figure:
    """Bar chart of effect contributions with A/M-ratio box."""
    fig, ax = plt.subplots(figsize=figsize)
    names = ["Additive\n(a_i + b_j)", "Multiplicative\n(U_i . V_j)"]
    values = [additive_contrib, multiplicative_contrib]
    bars = ax.bar(names, values, color=["tab:blue", "tab:orange"],
                  alpha=0.8)
    for bar, v in zip(bars, values):
        ax.text(bar.get_x() + bar.get_width() / 2, v, f"{v:.4f}",
                ha="center", va="bottom")
    ratio = (np.sqrt(additive_contrib / multiplicative_contrib)
             if multiplicative_contrib > 1e-10 else np.inf)
    ax.text(0.95, 0.95, f"A/M ratio: {ratio:.2f}",
            transform=ax.transAxes, ha="right", va="top",
            bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.6))
    ax.set_ylabel("Variance contribution")
    ax.set_title(title or "Effect contribution breakdown")
    ax.grid(axis="y", alpha=0.3)
    return _finish(fig, save_path)


def plot_parameter_comparison(X_true, X_est,
                              parameter_names: Optional[List[str]] = None,
                              figsize: Tuple[int, int] = (10, 8),
                              title: Optional[str] = None,
                              save_path: Optional[str] = None) -> Figure:
    """True-vs-estimated scatter with correlation/MSE box."""
    xt = _host(X_true).ravel()
    xe = _host(X_est).ravel()
    fig, ax = plt.subplots(figsize=figsize)
    ax.scatter(xt, xe, s=15, alpha=0.5)
    lims = [min(xt.min(), xe.min()), max(xt.max(), xe.max())]
    ax.plot(lims, lims, "r--", lw=1, label="y = x")
    mse = float(np.mean((xt - xe) ** 2))
    corr = float(np.corrcoef(xt, xe)[0, 1]) if xt.size > 1 else 0.0
    ax.text(0.05, 0.95, f"r = {corr:.3f}\nMSE = {mse:.4f}",
            transform=ax.transAxes, va="top",
            bbox=dict(boxstyle="round", facecolor="lightblue", alpha=0.6))
    ax.set_xlabel("True value")
    ax.set_ylabel("Estimated value")
    ax.set_title(title or "Parameter recovery")
    ax.legend()
    ax.grid(alpha=0.3)
    return _finish(fig, save_path)


def plot_residuals(Y_true, Y_pred, figsize: Tuple[int, int] = (12, 5),
                   title: Optional[str] = None,
                   save_path: Optional[str] = None) -> Figure:
    """Residual histogram + normal Q-Q plot."""
    resid = (_host(Y_true) - _host(Y_pred)).ravel()
    fig, axes = plt.subplots(1, 2, figsize=figsize)

    axes[0].hist(resid, bins=50, density=True, alpha=0.7,
                 color="tab:blue", edgecolor="white")
    mu, sigma = float(resid.mean()), float(resid.std() or 1.0)
    xs = np.linspace(resid.min(), resid.max(), 200)
    axes[0].plot(xs, stats.norm.pdf(xs, mu, sigma), "r-", lw=1.5,
                 label=f"N({mu:.3f}, {sigma:.3f}²)")
    axes[0].set_xlabel("Residual")
    axes[0].set_ylabel("Density")
    axes[0].set_title("Residual distribution")
    axes[0].legend()

    stats.probplot(resid, dist="norm", plot=axes[1])
    axes[1].set_title("Normal Q-Q plot")
    axes[1].grid(alpha=0.3)

    if title:
        fig.suptitle(title)
    return _finish(fig, save_path)
