"""Multiplicative-strength comparison: weak vs strong multiplicative regimes
(counterpart of :mod:`tame.experiments.multiplicative_strength_comparison`).

Two scenarios (weak: additive_scale=2.0/multiplicative_scale=0.2; strong:
1.0/2.0), true states rescaled and observations regenerated from the
scaled means in one batched symmetrized draw on the device, all three
methods run at lr=0.7 for 150 iterations (on the card at n=20 each is one
K3 launch), the per-time U'V-product correlation metric, a publication
comparison figure (with matplotlib) and a printed caption.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from tame_torch.experiments.utils import sync_device
from tame_torch.inference import (
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)
from tame_torch.models import TemporalAMEModel
from tame_torch.ops import dyad as dyad_ops
from tame_torch.scripts._common import resolve_device
from tame_torch.utils import (
    compute_alignment_error,
    compute_temporal_contributions,
    compute_uv_product_correlation,
)


def _rescale_noise(seed: int, shape, device) -> torch.Tensor:
    """Standard-normal noise for the rescaled scenario's observations, from
    a generator on ``device`` seeded from the pair ``(seed, 1)`` (the
    counterpart of ``fold_in(PRNGKey(seed), 1)``)."""
    pair_seed = int(np.random.SeedSequence((seed, 1)).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(pair_seed)
    return torch.randn(shape, generator=gen, device=device)


def compute_uv_correlation_over_time(X_est, X_true, latent_dim: int
                                     ) -> np.ndarray:
    """Correlation of the identified U'V product, per time step."""
    X_est = torch.as_tensor(X_est)
    X_true = torch.as_tensor(X_true).to(X_est.device)
    T = X_est.shape[1]
    return np.array([
        compute_uv_product_correlation(
            X_est[:, t, 2:], X_true[:, t, 2:], latent_dim)
        for t in range(T)])


def run_experiment(
    scenario_name: str,
    rho_additive: float = 0.5,
    rho_multiplicative: float = 0.5,
    additive_scale: float = 1.0,
    multiplicative_scale: float = 1.0,
    n_nodes: int = 20,
    n_time: int = 10,
    seed: int = 42,
    max_iter: int = 150,
    learning_rate: float = 0.7,
    verbose: bool = True,
    device: str = "cuda",
) -> Tuple[Dict, TemporalAMEModel, torch.Tensor]:
    """Run one scenario on ``device``.

    Returns ``(results, model, X_true)``.
    """
    device = resolve_device(device).type
    if verbose:
        print("\n" + "=" * 70)
        print(f"SCENARIO: {scenario_name}")
        print("=" * 70)
        print(f"  additive_scale={additive_scale}  "
              f"multiplicative_scale={multiplicative_scale}  "
              f"n={n_nodes}  T={n_time}")

    model = TemporalAMEModel(
        n_nodes=n_nodes, n_time=n_time, latent_dim=2, ar_coefficient=0.8,
        rho_additive=rho_additive, rho_multiplicative=rho_multiplicative,
        rho_dyadic=0.5, process_noise_scale=0.1, seed=seed, device=device)
    Y, X_true = model.generate_data(return_latents=True)

    if additive_scale != 1.0 or multiplicative_scale != 1.0:
        # Rescale true effects and regenerate observations from the scaled
        # means — one batched draw.
        scale = torch.tensor([additive_scale] * 2 + [multiplicative_scale]
                             * (X_true.shape[-1] - 2), device=X_true.device)
        X_true = X_true * scale
        mu = dyad_ops.dyadic_mean_temporal(X_true, model.r)
        LR = torch.linalg.cholesky(model.R).to(mu.device)
        noise = _rescale_noise(seed, mu.shape, mu.device) @ LR.T
        Y = dyad_ops.symmetrize_dyads(mu + noise)
        model.Y = Y
        model.X = X_true

    add_true, mult_true = compute_temporal_contributions(X_true, 2)
    if verbose:
        add_m, mult_m = float(add_true.mean()), float(mult_true.mean())
        am = float(np.sqrt(add_m / (mult_m + 1e-10)))
        print(f"  true contributions: additive={add_m:.4f}  "
              f"multiplicative={mult_m:.4f}  A/M={am:.2f}")

    methods = [
        ("Naive MF", TemporalAMENaiveMFVI, {}),
        ("Good SMF", TemporalAMEStructuredMFVI, {"factorization": "good"}),
        ("Bad SMF", TemporalAMEStructuredMFVI, {"factorization": "bad"}),
    ]
    results = {}
    for name, cls, kwargs in methods:
        if verbose:
            print(f"\n  Running {name}...")
        vi = cls(model, learning_rate=learning_rate, seed=seed, **kwargs)
        sync_device(vi.X_mean)
        start = time.time()
        history = vi.fit(max_iter=max_iter, verbose=False)
        sync_device(vi.X_mean)
        runtime = time.time() - start
        error, X_aligned = compute_alignment_error(
            vi.X_mean, X_true, latent_dim=2, align=True)
        uv_corr = compute_uv_correlation_over_time(X_aligned, X_true, 2)
        results[name] = {
            "vi": vi,
            "history": history,
            "X_est": vi.X_mean,
            "X_aligned": X_aligned,
            "alignment_error": error,
            "uv_correlation": uv_corr,
            "runtime": runtime,
            "iterations": len(history["elbo"]),
            "method_name": name,
        }
        if verbose:
            print(f"    final MSE={history['reconstruction_error'][-1]:.4f}  "
                  f"align-err={error:.4f}  "
                  f"max|UV corr|={np.abs(uv_corr).max():.2f}  "
                  f"({runtime:.1f} s)")
    return results, model, X_true


def create_comparison_figure(weak_results: Dict, strong_results: Dict,
                             X_true_weak, X_true_strong,
                             save_path=None):
    """3 x 4 publication figure: per-regime convergence, final MSE, U'V
    correlation over time, recovery scatter
    (needs matplotlib)."""
    import matplotlib.pyplot as plt

    from tame_torch.visualization.static import _host

    fig, axes = plt.subplots(3, 4, figsize=(20, 12))
    for row_pair, (tag, results, X_true) in enumerate([
            ("Weak multiplicative", weak_results, X_true_weak),
            ("Strong multiplicative", strong_results, X_true_strong)]):
        row = row_pair
        colors = {"Naive MF": "tab:blue", "Good SMF": "tab:orange",
                  "Bad SMF": "tab:red"}
        ax = axes[row][0]
        for name, r in results.items():
            ax.plot(r["history"]["reconstruction_error"], lw=1.3,
                    label=name, color=colors[name])
        ax.set_title(f"{tag}: MSE convergence")
        ax.set_xlabel("Iteration")
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)

        ax = axes[row][1]
        names = list(results)
        finals = [results[n]["history"]["reconstruction_error"][-1]
                  for n in names]
        ax.bar(names, finals, color=[colors[n] for n in names], alpha=0.8)
        ax.set_title(f"{tag}: final MSE")
        ax.tick_params(axis="x", rotation=20)
        ax.grid(axis="y", alpha=0.3)

        ax = axes[row][2]
        for name, r in results.items():
            ax.plot(r["uv_correlation"], "o-", lw=1.2, label=name,
                    color=colors[name])
        ax.set_ylim(-1.05, 1.05)
        ax.axhline(0, color="gray", lw=0.5)
        ax.set_title(f"{tag}: U'V correlation over time")
        ax.set_xlabel("Time")
        ax.grid(alpha=0.3)

        ax = axes[row][3]
        xt = _host(X_true).ravel()
        xe = _host(results["Good SMF"]["X_aligned"]).ravel()
        ax.scatter(xt, xe, s=5, alpha=0.3)
        lims = [min(xt.min(), xe.min()), max(xt.max(), xe.max())]
        ax.plot(lims, lims, "r--", lw=1)
        ax.set_title(f"{tag}: Good SMF recovery")
        ax.grid(alpha=0.3)

    # Third row: cross-regime summary.
    for col, metric, label in [
            (0, "alignment_error", "Alignment error"),
            (1, "runtime", "Runtime (s)")]:
        ax = axes[2][col]
        names = list(weak_results)
        width = 0.35
        xs = np.arange(len(names))
        ax.bar(xs - width / 2, [weak_results[n][metric] for n in names],
               width, label="weak", alpha=0.8)
        ax.bar(xs + width / 2, [strong_results[n][metric] for n in names],
               width, label="strong", alpha=0.8)
        ax.set_xticks(xs)
        ax.set_xticklabels(names, rotation=20)
        ax.set_title(label)
        ax.legend()
        ax.grid(axis="y", alpha=0.3)
    axes[2][2].axis("off")
    axes[2][3].axis("off")

    fig.suptitle("Multiplicative-strength comparison", fontsize=15)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def main(save_outputs: bool = True, n_nodes: int = 20, n_time: int = 10,
         max_iter: int = 150, seed: int = 42, device: str = "cuda"):
    """Run both regimes on ``device`` and print the summary caption; the
    comparison figure is drawn where matplotlib is installed (into the
    experiment directory under ``save_outputs``)."""
    from tame_torch.experiments.utils import can_draw, setup_experiment_dir

    weak_results, _, X_weak = run_experiment(
        "Weak Multiplicative", rho_additive=0.5, rho_multiplicative=0.5,
        additive_scale=2.0, multiplicative_scale=0.2,
        n_nodes=n_nodes, n_time=n_time, seed=seed, max_iter=max_iter,
        device=device)
    strong_results, _, X_strong = run_experiment(
        "Strong Multiplicative", rho_additive=0.5, rho_multiplicative=0.5,
        additive_scale=1.0, multiplicative_scale=2.0,
        n_nodes=n_nodes, n_time=n_time, seed=seed, max_iter=max_iter,
        device=device)

    save_path = None
    if save_outputs:
        exp_dir = setup_experiment_dir("multiplicative_strength")
        save_path = str(exp_dir / "figures" / "comparison.png")
    if can_draw("the comparison figure"):
        import matplotlib.pyplot as plt

        fig = create_comparison_figure(weak_results, strong_results,
                                       X_weak, X_strong, save_path=save_path)
        plt.close(fig)

    print("\n" + "=" * 70)
    print("SUMMARY")
    print("=" * 70)
    for tag, results in (("Weak", weak_results), ("Strong", strong_results)):
        finals = {n: r["history"]["reconstruction_error"][-1]
                  for n, r in results.items()}
        print(f"{tag} multiplicative final MSE: "
              + "  ".join(f"{n}={v:.2f}" for n, v in finals.items()))
        good_uv = np.abs(results["Good SMF"]["uv_correlation"]).max()
        print(f"  Good-SMF max |U'V corr| = {good_uv:.2f}")
    return weak_results, strong_results


if __name__ == "__main__":
    main()
