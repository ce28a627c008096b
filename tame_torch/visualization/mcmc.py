"""MCMC chain-diagnostic plots.

Counterpart of :mod:`tame.visualization.mcmc`: visual companions to
:func:`tame_torch.utils.diagnostics.chain_diagnostics` — trace plots of the
worst-mixing parameters, rank histograms (uniform when chains mix), the
per-parameter ESS distribution, and the log-density trace.
Host-side matplotlib like the rest of ``tame_torch.visualization``.
"""

from __future__ import annotations

from typing import Optional

import matplotlib.pyplot as plt
import numpy as np
from matplotlib.figure import Figure

from tame_torch.visualization.static import _host


def plot_chain_diagnostics(positions, logdensities=None, n_worst: int = 3,
                           figsize=(14, 8),
                           save_path: Optional[str] = None) -> Figure:
    """Four-panel convergence report for a ``(chains, draws, ...)`` stack.

    Panels: (1) traces of the ``n_worst`` parameters ranked by
    split-R-hat, chains overlaid; (2) rank histogram of the single worst
    parameter (flat == mixed); (3) histogram of per-parameter ESS;
    (4) per-chain log-density traces (when given).
    """
    from tame_torch.utils.diagnostics import effective_sample_size, split_rhat

    pos = _host(positions)
    C, N = pos.shape[:2]
    flat = pos.reshape(C, N, -1)
    P = flat.shape[-1]

    rhat = _host(split_rhat(flat)).ravel()
    ess = _host(effective_sample_size(flat)).ravel()
    worst = np.argsort(-rhat)[:min(n_worst, P)]

    fig, axes = plt.subplots(2, 2, figsize=figsize)
    fig.suptitle(
        f"Chain diagnostics: {C} chains x {N} draws, "
        f"max R-hat {rhat.max():.3f}, min ESS {ess.min():.0f}")

    ax = axes[0, 0]
    for p in worst:
        for c in range(C):
            ax.plot(flat[c, :, p], lw=0.6, alpha=0.7)
    ax.set_title(f"Traces of {len(worst)} worst-R-hat parameters")
    ax.set_xlabel("Draw")
    ax.grid(alpha=0.3)

    ax = axes[0, 1]
    p0 = int(worst[0])
    ranks = np.argsort(np.argsort(flat[:, :, p0].ravel())).reshape(C, N)
    # Shared bins over the FULL global rank range [0, C*N): per-chain
    # auto-ranged bins would render a stuck chain's concentrated ranks as
    # a deceptively flat histogram — exactly the pathology this panel
    # exists to expose.
    n_bins = min(20, N // 2)
    edges = np.linspace(0, C * N, n_bins + 1)
    for c in range(C):
        ax.hist(ranks[c], bins=edges, histtype="step", lw=1.2,
                label=f"chain {c}" if C <= 6 else None)
    ax.axhline(N / n_bins, color="k", ls="--", lw=0.8)
    ax.set_title(f"Rank histogram, worst parameter "
                 f"(R-hat {rhat[p0]:.3f})")
    if C <= 6:
        ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    ax = axes[1, 0]
    ax.hist(ess, bins=30, color="tab:blue", alpha=0.8)
    ax.axvline(C * N, color="k", ls="--", lw=0.8, label="chains x draws")
    ax.set_title("Per-parameter effective sample size")
    ax.set_xlabel("ESS")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)

    ax = axes[1, 1]
    if logdensities is not None:
        ld = _host(logdensities)
        for c in range(C):
            ax.plot(ld[c], lw=0.8, alpha=0.8)
        ax.set_title("Log density per chain")
        ax.set_xlabel("Draw")
    else:
        ax.axis("off")
        ax.set_title("(no log densities provided)")
    ax.grid(alpha=0.3)

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_smc_diagnostics(result, figsize=(14, 4),
                         save_path: Optional[str] = None) -> Figure:
    """Three-panel report for an adaptive-tempered SMC run
    (:func:`tame_torch.inference.smc.run_smc` / ``TemporalAMESMC.sample``):
    the realized temperature schedule (log scale — adaptive schedules
    spend most stages at small beta), the particle-ESS trajectory
    against the resampling threshold, and the per-stage move
    acceptance.  NaN-padded history slots past ``n_stages`` are
    dropped."""
    ns = int(result.n_stages)
    betas = _host(result.beta_history)[:ns]
    ess = _host(result.ess_history)[:ns]
    acc = _host(result.accept_history)[:ns]
    stages = np.arange(1, ns + 1)

    fig, axes = plt.subplots(1, 3, figsize=figsize)
    axes[0].semilogy(stages, np.maximum(betas, 1e-12))
    axes[0].set_xlabel("stage")
    axes[0].set_ylabel(r"$\beta$ (log scale)")
    axes[0].set_title(f"temperature schedule ({ns} stages)")

    axes[1].plot(stages, ess)
    n_particles = int(_host(result.log_weights).shape[0])
    axes[1].axhline(0.5 * n_particles, ls="--", color="gray",
                    label="resample threshold")
    axes[1].set_xlabel("stage")
    axes[1].set_ylabel("particle ESS")
    axes[1].set_title(
        f"ESS ({int(result.n_resamples)} resampling events)")
    axes[1].legend()

    axes[2].plot(stages, acc)
    axes[2].set_ylim(0, 1)
    axes[2].set_xlabel("stage")
    axes[2].set_ylabel("move acceptance")
    axes[2].set_title(
        f"MCMC moves (log-evidence {float(result.log_evidence):.1f})")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig
