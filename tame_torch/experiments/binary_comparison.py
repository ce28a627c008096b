"""Binary-network comparison: JJ-bound VI vs Gaussian engines on ties
(counterpart of :mod:`tame.experiments.binary_comparison`).

Generates a binary dynamic network from the temporal-AME latents on the
device, hides a fraction of dyads, and compares

* **Binary JJ-VI** — the dedicated Jaakkola-Jordan CAVI engine
  (:class:`tame_torch.inference.TemporalAMEBernoulliVI`, warm init), the
  correct observation model; on the card one K1 and one K2 launch per
  iteration;
* **Smoothed binary** — the joint-trajectory JJ E-step
  (:func:`tame_torch.inference.fit_smoothed_family`), a strictly tighter
  temporal family; one K4 launch per iteration;
* **Gaussian Good SMF** — the structured Gaussian engine applied to
  ±1-coded ties: the standard "pretend it's continuous" baseline a
  practitioner would otherwise reach for.

Scoreboard: held-out link-prediction accuracy and AUC on the hidden
dyads (every method produces a per-dyad score — tie probability for the
binary engines, the Gaussian predictor for the control), convergence
curves, and network-vs-probability heatmaps (with matplotlib).  Results
flow through the standard harness (timestamped dirs, pickle + JSON,
markdown report).  The scores and the AUC stay on the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tame_torch.experiments.utils import (
    can_draw,
    print_experiment_header,
    save_results,
    set_random_seeds,
    setup_experiment_dir,
)
from tame_torch.scripts._common import resolve_device


def _auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney): P(score_pos > score_neg)."""
    pos = scores[labels > 0.5]
    neg = scores[labels < 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([neg, pos]), kind="mergesort")
    ranks = np.empty(len(order), dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ties (exact for binary-ish score ties)
    allv = np.concatenate([neg, pos])
    for v in np.unique(allv):
        sel = allv == v
        if sel.sum() > 1:
            ranks[sel] = ranks[sel].mean()
    r_pos = ranks[len(neg):].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2)
                 / (len(pos) * len(neg)))


def run_binary_comparison(
    n_nodes: int = 30,
    n_time: int = 8,
    latent_dim: int = 1,
    ar_coefficient: float = 0.8,
    missing_frac: float = 0.2,
    max_iter: int = 200,
    seed: int = 42,
    save_outputs: bool = True,
    verbose: bool = True,
    device: str = "cuda",
) -> tuple:
    """Run the binary comparison on ``device``; returns ``(results,
    exp_dir)``.

    ``results`` maps method name to the standard results dict plus
    ``scores`` (per-dyad (n, n, T) link score), ``holdout_accuracy`` and
    ``holdout_auc``.
    """
    import time

    import torch

    from tame_torch.inference import (
        TemporalAMEBernoulliVI,
        TemporalAMEStructuredMFVI,
        fit_smoothed_family,
        warm_init_smoothed_family,
    )
    from tame_torch.models import (
        TemporalAMEModel,
        random_dyad_mask,
        sample_observations,
    )
    from tame_torch.ops import dyad as dyad_ops

    def host(x) -> np.ndarray:
        return x.detach().cpu().numpy()

    def clock() -> float:
        if device == "cuda":
            torch.cuda.synchronize()
        return time.time()

    device = resolve_device(device).type
    set_random_seeds(seed)
    print_experiment_header("Binary Comparison", {
        "n_nodes": n_nodes, "n_time": n_time, "latent_dim": latent_dim,
        "ar_coefficient": ar_coefficient, "missing_frac": missing_frac,
        "max_iter": max_iter, "seed": seed,
    })

    model = TemporalAMEModel(n_nodes=n_nodes, n_time=n_time,
                             latent_dim=latent_dim,
                             ar_coefficient=ar_coefficient, seed=seed,
                             device=device)
    model.generate_data(return_latents=True)
    Yb = sample_observations(
        model.params, torch.Generator(device=device).manual_seed(seed + 7),
        model.X, family="bernoulli")
    model.Y = Yb
    mask = random_dyad_mask(
        torch.Generator(device=device).manual_seed(seed + 1), n_nodes,
        n_time, missing_frac)
    off = 1.0 - np.eye(n_nodes)[:, :, None]
    held = off * (1.0 - host(mask))
    y0 = host(Yb[..., 0])

    def holdout_metrics(scores: np.ndarray) -> Dict[str, float]:
        sel = held > 0
        acc = float(((scores[sel] > 0.5) == (y0[sel] > 0.5)).mean())
        return {"holdout_accuracy": acc,
                "holdout_auc": _auc(scores[sel], y0[sel])}

    results: Dict[str, Dict] = {}

    # --- Binary JJ-VI (mean-field) ---------------------------------------
    t0 = clock()
    vi = TemporalAMEBernoulliVI(model, init_mode="warm", mask=mask)
    hist = vi.fit(max_iter=max_iter, verbose=False)
    proba = host(vi.predict_proba())
    results["Binary JJ-VI"] = {
        "vi": vi, "history": hist, "X_est": vi.X_mean,
        "runtime": clock() - t0, "iterations": len(hist["elbo"]),
        "method_name": "Binary JJ-VI", "scores": proba,
        **holdout_metrics(proba)}

    # --- Smoothed binary (joint-trajectory JJ) ---------------------------
    t0 = clock()
    params = model.params.to(device)
    init = warm_init_smoothed_family(Yb, params, "bernoulli", obs_mask=mask)
    sm = fit_smoothed_family(Yb, params, init, family="bernoulli",
                             max_iter=max_iter, learning_rate=0.7,
                             tolerance=1e-5, mask=mask)
    k = int(sm.n_iter)
    m_sm = host(dyad_ops.dyadic_fwd_temporal(sm.state.X_mean, latent_dim))
    proba_sm = 1.0 / (1.0 + np.exp(-m_sm))
    results["Smoothed binary"] = {
        "vi": None, "history": {
            "elbo": sm.elbo_history[:k].tolist()},
        "X_est": sm.state.X_mean, "runtime": clock() - t0,
        "iterations": k, "method_name": "Smoothed binary",
        "scores": proba_sm, **holdout_metrics(proba_sm)}

    # --- Gaussian Good SMF on +-1 coded ties (control) -------------------
    t0 = clock()
    model_g = TemporalAMEModel(n_nodes=n_nodes, n_time=n_time,
                               latent_dim=latent_dim,
                               ar_coefficient=ar_coefficient, seed=seed,
                               device=device)
    model_g.generate_data()
    model_g.Y = 2.0 * Yb - 1.0
    gvi = TemporalAMEStructuredMFVI(model_g, factorization="good",
                                    learning_rate=0.8, init_mode="warm",
                                    mask=mask)
    ghist = gvi.fit(max_iter=max_iter, verbose=False)
    m_g = host(dyad_ops.dyadic_fwd_temporal(gvi.X_mean, latent_dim))
    # calibrate the Gaussian predictor to a probability via its sign
    proba_g = 1.0 / (1.0 + np.exp(-2.0 * m_g))
    results["Gaussian Good SMF"] = {
        "vi": gvi, "history": ghist, "X_est": gvi.X_mean,
        "runtime": clock() - t0, "iterations": len(ghist["elbo"]),
        "method_name": "Gaussian Good SMF", "scores": proba_g,
        **holdout_metrics(proba_g)}

    if verbose:
        print(f"\n{'Method':24s} {'held-out acc':>12s} "
              f"{'held-out AUC':>12s} {'runtime':>9s}")
        for name, res in results.items():
            print(f"{name:24s} {res['holdout_accuracy']:12.4f} "
                  f"{res['holdout_auc']:12.4f} "
                  f"{res['runtime']:8.2f}s")

    exp_dir = None
    if save_outputs:
        exp_dir = setup_experiment_dir("binary_comparison")
        if can_draw("the binary-comparison figures"):
            _draw(results, y0, n_time, exp_dir)
        save_results({k: {kk: vv for kk, vv in v.items() if kk != "vi"}
                      for k, v in results.items()}, exp_dir)
        report = exp_dir / "report.md"
        with open(report, "w") as f:
            f.write("# Binary comparison\n\n")
            f.write(f"n={n_nodes}, T={n_time}, r={latent_dim}, "
                    f"phi={ar_coefficient}, missing={missing_frac:.0%}, "
                    f"seed={seed}\n\n")
            f.write("| method | held-out accuracy | held-out AUC | "
                    "runtime (s) | iterations |\n|---|---|---|---|---|\n")
            for name, res in results.items():
                f.write(f"| {name} | {res['holdout_accuracy']:.4f} | "
                        f"{res['holdout_auc']:.4f} | "
                        f"{res['runtime']:.2f} | "
                        f"{res['iterations']} |\n")
        if verbose:
            print(f"\nOutputs written to {exp_dir}")
    return results, exp_dir


def _draw(results: Dict[str, Dict], y0: np.ndarray, n_time: int,
          exp_dir) -> None:
    """The convergence curves and the observed-vs-predicted heatmaps."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # convergence curves (objectives are on different scales — one
    # panel per method)
    fig, axes = plt.subplots(1, len(results),
                             figsize=(5 * len(results), 4))
    for ax, (name, res) in zip(np.atleast_1d(axes), results.items()):
        ax.plot(res["history"]["elbo"])
        ax.set_title(name)
        ax.set_xlabel("iteration")
        ax.set_ylabel("objective")
    fig.tight_layout()
    fig.savefig(exp_dir / "figures" / "convergence.png", dpi=120)
    plt.close(fig)

    # observed adjacency vs predicted probabilities at t = T-1
    t = n_time - 1
    fig, axes = plt.subplots(1, 1 + len(results),
                             figsize=(4 * (1 + len(results)), 4))
    axes[0].imshow(y0[:, :, t], cmap="Greys", vmin=0, vmax=1)
    axes[0].set_title(f"observed ties (t={t})")
    for ax, (name, res) in zip(axes[1:], results.items()):
        ax.imshow(res["scores"][:, :, t], cmap="viridis",
                  vmin=0, vmax=1)
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(exp_dir / "figures" / "adjacency_probabilities.png",
                dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    run_binary_comparison()
