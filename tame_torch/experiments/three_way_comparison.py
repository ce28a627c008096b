"""Three-way comparison: Naive MF vs Good SMF vs Bad SMF (counterpart of
:mod:`tame.experiments.three_way_comparison`).

Generate data on the device, run the methods timed, align, print
summaries, rank, produce the figure set (with matplotlib), persist pickle +
JSON, and write the markdown report.  On the card at the default n=15 each
of Naive, Good and Bad is one K3 launch; the Smoothed VI method runs
through K4.
"""

from __future__ import annotations

from tame_torch.experiments.utils import (
    can_draw,
    generate_experiment_report,
    print_experiment_header,
    run_method_with_timing,
    save_results,
    set_random_seeds,
    setup_experiment_dir,
)
from tame_torch.scripts._common import resolve_device
from tame_torch.inference import (
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)
from tame_torch.models import TemporalAMEModel
from tame_torch.utils import (
    align_temporal_states,
    compare_methods,
    print_diagnostic_summary,
)


def run_three_way_comparison(
    n_nodes: int = 15,
    n_time: int = 10,
    latent_dim: int = 2,
    rho_dyadic: float = 0.5,
    ar_coefficient: float = 0.8,
    max_iter: int = 200,
    learning_rate: float = 0.01,
    seed: int = 42,
    save_outputs: bool = True,
    verbose: bool = True,
    include_smoothed: bool = True,
    device: str = "cuda",
):
    """Run the three-method comparison on ``device``.

    ``include_smoothed=True`` (default) adds the joint-trajectory
    smoothed engine (:class:`tame_torch.inference.TemporalAMESmoothedVI`)
    as a fourth method; all comparison plots/reports are
    method-count-generic.  Pass ``False`` for the three-method run.

    Returns ``(results, exp_dir)`` where ``results`` maps method name to the
    standard results dict plus ``X_aligned``.
    """
    device = resolve_device(device).type
    set_random_seeds(seed)
    print_experiment_header("Three-Way Comparison", {
        "n_nodes": n_nodes, "n_time": n_time, "latent_dim": latent_dim,
        "rho_dyadic": rho_dyadic, "ar_coefficient": ar_coefficient,
        "max_iter": max_iter, "learning_rate": learning_rate, "seed": seed,
    })

    exp_dir = None
    if save_outputs:
        exp_dir = setup_experiment_dir("three_way_comparison")
        print(f"Results will be saved to: {exp_dir}\n")

    # -- data --------------------------------------------------------------
    model = TemporalAMEModel(
        n_nodes=n_nodes, n_time=n_time, latent_dim=latent_dim,
        ar_coefficient=ar_coefficient, rho_dyadic=rho_dyadic, seed=seed,
        device=device)
    Y, X_true = model.generate_data(return_latents=True)
    print(f"Generated data: Y {tuple(Y.shape)}, X {tuple(X_true.shape)}")

    # -- fits --------------------------------------------------------------
    methods = [
        ("Naive MF", TemporalAMENaiveMFVI, {}),
        ("Good SMF", TemporalAMEStructuredMFVI, {"factorization": "good"}),
        ("Bad SMF", TemporalAMEStructuredMFVI, {"factorization": "bad"}),
    ]
    if include_smoothed:
        from tame_torch.inference import TemporalAMESmoothedVI

        methods.append(("Smoothed VI", TemporalAMESmoothedVI, {}))
    results = {}
    for name, cls, kwargs in methods:
        results[name] = run_method_with_timing(
            cls, model, name, max_iter=max_iter, verbose=verbose,
            learning_rate=learning_rate, seed=seed, **kwargs)

    # -- alignment ---------------------------------------------------------
    for name, result in results.items():
        result["X_aligned"] = align_temporal_states(
            result["X_est"], X_true, latent_dim=latent_dim)

    # -- diagnostics -------------------------------------------------------
    if verbose:
        for name, result in results.items():
            print_diagnostic_summary(
                name, result["history"], X_true=X_true,
                X_est=result["X_aligned"], latent_dim=latent_dim)
        compare_methods(results, X_true=X_true)

    # -- figures + persistence --------------------------------------------
    if save_outputs:
        if can_draw("the three-way figures"):
            _draw(results, X_true, latent_dim, exp_dir / "figures")
        save_results(
            {name: {k: v for k, v in r.items() if k != "vi"}
             for name, r in results.items()},
            exp_dir)
        generate_experiment_report(
            results, exp_dir, X_true=X_true,
            experiment_name="Three-Way Comparison", latent_dim=latent_dim)

    return results, exp_dir


def _draw(results, X_true, latent_dim: int, figdir) -> None:
    """The comparison, convergence, efficiency and per-method contribution
    figures into ``figdir``."""
    import matplotlib.pyplot as plt

    from tame_torch.utils import compute_temporal_contributions
    from tame_torch.visualization import (
        plot_computational_efficiency,
        plot_convergence_comparison,
        plot_temporal_contributions,
        plot_three_way_comparison,
    )

    plot_three_way_comparison(
        results, X_true=X_true,
        save_path=str(figdir / "three_way_comparison.png"))
    plot_convergence_comparison(
        results, metric="elbo",
        save_path=str(figdir / "elbo_convergence.png"))
    plot_convergence_comparison(
        results, metric="reconstruction_error",
        save_path=str(figdir / "mse_convergence.png"))
    plot_computational_efficiency(
        results, save_path=str(figdir / "efficiency.png"))
    for name, result in results.items():
        add, mult = compute_temporal_contributions(
            result["X_aligned"], latent_dim)
        slug = name.lower().replace(" ", "_")
        plot_temporal_contributions(
            add, mult, title=f"Contributions: {name}",
            save_path=str(figdir / f"contributions_{slug}.png"))
    plt.close("all")


if __name__ == "__main__":
    # lr=0.01 barely moves; the working damping of the multiplicative
    # experiment instead.
    run_three_way_comparison(
        n_nodes=15, n_time=10, latent_dim=2, rho_dyadic=0.8,
        ar_coefficient=0.8, max_iter=500, learning_rate=0.7, seed=42)
