"""Method-comparison visualizations, including the three-way mega-figure.

Counterpart of :mod:`tame.visualization.comparison`:
metric bars, convergence overlays, sorted reconstruction bars with
improvement percentages, recovery scatter grids, runtime bars,
posterior-correlation heatmap panels, and the 3 x 3 three-way figure.
Consumes the standard results dict ``{'history', 'X_est', 'vi', 'runtime',
'iterations', 'method_name'}``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import matplotlib.pyplot as plt
import numpy as np
from matplotlib.figure import Figure

from tame_torch.visualization.static import _finish, _host

_METHOD_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red",
                  "tab:purple"]


def plot_method_comparison(results: Dict[str, Dict[str, Any]],
                           metrics: List[str] = ["reconstruction_error",
                                                 "state_error"],
                           figsize: Tuple[int, int] = (12, 6),
                           title: Optional[str] = None,
                           save_path: Optional[str] = None) -> Figure:
    """Final-value bar chart per metric across methods."""
    present = [m for m in metrics
               if any(m in r.get("history", {}) for r in results.values())]
    if not present:
        present = ["reconstruction_error"]
    fig, axes = plt.subplots(1, len(present), figsize=figsize,
                             squeeze=False)
    names = list(results)
    for ax, metric in zip(axes[0], present):
        values = [
            (results[n]["history"].get(metric) or [np.nan])[-1]
            for n in names]
        bars = ax.bar(names, values,
                      color=_METHOD_COLORS[:len(names)], alpha=0.8)
        for bar, v in zip(bars, values):
            if np.isfinite(v):
                ax.text(bar.get_x() + bar.get_width() / 2, v, f"{v:.4f}",
                        ha="center", va="bottom", fontsize=8)
        ax.set_ylabel(metric)
        ax.set_title(f"Final {metric}")
        ax.tick_params(axis="x", rotation=20)
        ax.grid(axis="y", alpha=0.3)
    if title:
        fig.suptitle(title)
    return _finish(fig, save_path)


def plot_convergence_comparison(results: Dict[str, Dict[str, Any]],
                                metric: str = "elbo",
                                figsize: Tuple[int, int] = (12, 6),
                                title: Optional[str] = None,
                                log_scale: bool = False,
                                save_path: Optional[str] = None) -> Figure:
    """Overlayed convergence curves across methods."""
    fig, ax = plt.subplots(figsize=figsize)
    for idx, (name, result) in enumerate(results.items()):
        values = result.get("history", {}).get(metric, [])
        if values:
            ax.plot(values, lw=1.5, alpha=0.85, label=name,
                    color=_METHOD_COLORS[idx % len(_METHOD_COLORS)])
    ax.set_xlabel("Iteration")
    ax.set_ylabel(metric)
    if log_scale:
        ax.set_yscale("log")
    ax.set_title(title or f"{metric} convergence comparison")
    ax.legend()
    ax.grid(alpha=0.3)
    return _finish(fig, save_path)


def plot_reconstruction_comparison(results: Dict[str, Dict[str, Any]],
                                   figsize: Tuple[int, int] = (10, 6),
                                   title: Optional[str] = None,
                                   save_path: Optional[str] = None
                                   ) -> Figure:
    """Sorted horizontal reconstruction-error bars annotated with
    improvement over the worst method."""
    scores = {
        name: (r.get("history", {}).get("reconstruction_error")
               or [np.nan])[-1]
        for name, r in results.items()}
    ranked = sorted(scores.items(), key=lambda kv: kv[1])
    names = [n for n, _ in ranked]
    values = [v for _, v in ranked]

    fig, ax = plt.subplots(figsize=figsize)
    bars = ax.barh(names, values, color=_METHOD_COLORS[:len(names)],
                   alpha=0.8)
    worst = values[-1] if values else 1.0
    for bar, v in zip(bars, values):
        label = f"{v:.4f}"
        if v != worst and worst > 0:
            label += f"  ({(1 - v / worst) * 100:+.1f}%)"
        ax.text(v, bar.get_y() + bar.get_height() / 2, " " + label,
                va="center", fontsize=9)
    ax.set_xlabel("Final reconstruction MSE")
    ax.set_title(title or "Reconstruction error (best to worst)")
    ax.invert_yaxis()
    ax.grid(axis="x", alpha=0.3)
    return _finish(fig, save_path)


def plot_parameter_recovery_grid(X_true, results: Dict[str, Dict[str, Any]],
                                 figsize: Tuple[int, int] = (15, 5),
                                 title: Optional[str] = None,
                                 save_path: Optional[str] = None) -> Figure:
    """Per-method true-vs-estimated scatter grid."""
    X_true = _host(X_true).ravel()
    names = [n for n in results if results[n].get("X_est") is not None]
    fig, axes = plt.subplots(1, max(len(names), 1), figsize=figsize,
                             squeeze=False)
    for ax, name in zip(axes[0], names):
        xe = _host(results[name]["X_est"]).ravel()
        ax.scatter(X_true, xe, s=8, alpha=0.4)
        lims = [min(X_true.min(), xe.min()), max(X_true.max(), xe.max())]
        ax.plot(lims, lims, "r--", lw=1)
        corr = np.corrcoef(X_true, xe)[0, 1] if X_true.size > 1 else 0.0
        ax.set_title(f"{name}\nr = {corr:.3f}")
        ax.set_xlabel("True")
        ax.set_ylabel("Estimated")
        ax.grid(alpha=0.3)
    if title:
        fig.suptitle(title)
    return _finish(fig, save_path)


def plot_computational_efficiency(results: Dict[str, Dict[str, Any]],
                                  figsize: Tuple[int, int] = (12, 6),
                                  title: Optional[str] = None,
                                  save_path: Optional[str] = None
                                  ) -> Figure:
    """Runtime and iteration-count bars."""
    names = list(results)
    runtimes = [results[n].get("runtime", 0.0) for n in names]
    iters = [results[n].get("iterations", 0) for n in names]

    fig, axes = plt.subplots(1, 2, figsize=figsize)
    axes[0].bar(names, runtimes, color=_METHOD_COLORS[:len(names)],
                alpha=0.8)
    axes[0].set_ylabel("Runtime (s)")
    axes[0].set_title("Wall-clock time")
    axes[0].tick_params(axis="x", rotation=20)
    axes[0].grid(axis="y", alpha=0.3)

    axes[1].bar(names, iters, color=_METHOD_COLORS[:len(names)], alpha=0.8)
    axes[1].set_ylabel("Iterations")
    axes[1].set_title("Iterations to stop")
    axes[1].tick_params(axis="x", rotation=20)
    axes[1].grid(axis="y", alpha=0.3)

    if title:
        fig.suptitle(title)
    return _finish(fig, save_path)


def _cov_to_corr(cov: np.ndarray) -> np.ndarray:
    std = np.sqrt(np.clip(np.diag(cov), 1e-12, None))
    return cov / np.outer(std, std)


def add_correlation_panels_to_figure(fig, gs, results: Dict[str, Dict[str, Any]],
                                     method_names: List[str],
                                     row_index: int = 2, t_plot: int = 0,
                                     node_plot: int = 0,
                                     latent_dim: int = 2) -> None:
    """Posterior-correlation heatmaps (one per method) appended as a row of
    an existing GridSpec figure; highlights the diagonal/block/full
    covariance structure of each factorization."""
    for col, name in enumerate(method_names):
        if name not in results:
            continue
        ax = fig.add_subplot(gs[row_index, col])
        try:
            vi = results[name].get("vi")
            cov = _host(vi.X_cov[node_plot, t_plot])
            corr = _cov_to_corr(cov)
            im = ax.imshow(corr, cmap="RdBu_r", vmin=-1, vmax=1)
            d = corr.shape[0]
            # Mark the additive/multiplicative block boundary.
            ax.axhline(1.5, color="black", lw=0.8)
            ax.axvline(1.5, color="black", lw=0.8)
            ax.set_title(f"{name}\nposterior corr (i={node_plot}, "
                         f"t={t_plot})", fontsize=9)
            ax.set_xticks(range(d))
            ax.set_yticks(range(d))
            labels = (["a", "b"] + [f"U{k+1}" for k in range(latent_dim)]
                      + [f"V{k+1}" for k in range(latent_dim)])[:d]
            ax.set_xticklabels(labels, fontsize=7)
            ax.set_yticklabels(labels, fontsize=7)
            fig.colorbar(im, ax=ax, shrink=0.8)
        except (AttributeError, IndexError, TypeError, ValueError) as e:
            ax.text(0.5, 0.5, f"unavailable\n({e})", ha="center",
                    va="center", transform=ax.transAxes, fontsize=8)
            ax.axis("off")


def plot_three_way_comparison(results: Dict[str, Dict[str, Any]],
                              X_true=None,
                              figsize: Tuple[int, int] = (16, 14),
                              title: Optional[str] = None,
                              save_path: Optional[str] = None) -> Figure:
    """3 x 3 mega-figure: ELBO + MSE convergence, final bars, recovery
    scatters, posterior-correlation row."""
    names = list(results)
    fig = plt.figure(figsize=figsize)
    gs = fig.add_gridspec(3, max(len(names), 3), hspace=0.45, wspace=0.35)

    # Row 0: convergence curves.
    ax_elbo = fig.add_subplot(gs[0, 0])
    ax_mse = fig.add_subplot(gs[0, 1])
    ax_bars = fig.add_subplot(gs[0, 2])
    for idx, name in enumerate(names):
        hist = results[name].get("history", {})
        color = _METHOD_COLORS[idx % len(_METHOD_COLORS)]
        if hist.get("elbo"):
            ax_elbo.plot(hist["elbo"], label=name, color=color, lw=1.3)
        if hist.get("reconstruction_error"):
            ax_mse.plot(hist["reconstruction_error"], label=name,
                        color=color, lw=1.3)
    ax_elbo.set_title("ELBO")
    ax_elbo.set_xlabel("Iteration")
    ax_elbo.legend(fontsize=8)
    ax_elbo.grid(alpha=0.3)
    ax_mse.set_title("Reconstruction MSE")
    ax_mse.set_xlabel("Iteration")
    ax_mse.grid(alpha=0.3)

    finals = [(results[n].get("history", {}).get("reconstruction_error")
               or [np.nan])[-1] for n in names]
    ax_bars.bar(names, finals, color=_METHOD_COLORS[:len(names)], alpha=0.8)
    ax_bars.set_title("Final MSE")
    ax_bars.tick_params(axis="x", rotation=20)
    ax_bars.grid(axis="y", alpha=0.3)

    # Row 1: recovery scatters.
    if X_true is not None:
        xt = _host(X_true).ravel()
        for col, name in enumerate(names[:gs.ncols]):
            X_est = results[name].get("X_est")
            if X_est is None:
                continue
            ax = fig.add_subplot(gs[1, col])
            xe = _host(X_est).ravel()
            ax.scatter(xt, xe, s=6, alpha=0.3)
            lims = [min(xt.min(), xe.min()), max(xt.max(), xe.max())]
            ax.plot(lims, lims, "r--", lw=1)
            corr = np.corrcoef(xt, xe)[0, 1] if xt.size > 1 else 0.0
            ax.set_title(f"{name} recovery (r = {corr:.3f})", fontsize=9)
            ax.grid(alpha=0.3)

    # Row 2: posterior-correlation structure.
    add_correlation_panels_to_figure(fig, gs, results, names, row_index=2)

    fig.suptitle(title or "Three-way method comparison", fontsize=14)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig
