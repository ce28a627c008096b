"""Demo: the canonical temporal-AME workflow in 9 steps (counterpart of
the JAX package's root ``demo.py``).

n=15, T=10, r=2, phi=0.8, rho_dyadic=0.5, seed=42: generate data on the
device, fit the Naive / Good / Bad engines, align, summarize, compare, and
save four figures.  The default lr=0.01 for 100 iterations barely moves;
pass ``--lr 0.7`` for a converging run.  Runs on the card unless
``--device cpu`` is given; the figures need matplotlib (without it, step
8 says so and draws nothing).

    python -m tame_torch.demo --lr 0.7 --max-iter 150
"""

import argparse
from pathlib import Path

from tame_torch.inference import (
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)
from tame_torch.models import TemporalAMEModel
from tame_torch.utils import (
    align_temporal_states,
    compare_methods,
    compute_temporal_contributions,
    print_diagnostic_summary,
)


def main(lr: float = 0.01, max_iter: int = 100, outdir: str = "demo_output",
         n_nodes: int = 15, n_time: int = 10, seed: int = 42,
         device: str = "cuda"):
    from tame_torch.experiments.utils import can_draw
    from tame_torch.scripts._common import resolve_device

    device = resolve_device(device).type
    out = Path(outdir)
    out.mkdir(exist_ok=True)

    # Step 1: model + data ------------------------------------------------
    print("Step 1: Generating synthetic temporal network data...")
    model = TemporalAMEModel(
        n_nodes=n_nodes, n_time=n_time, latent_dim=2, ar_coefficient=0.8,
        rho_dyadic=0.5, seed=seed, device=device)
    Y, X_true = model.generate_data(return_latents=True)
    print(f"  Y: {tuple(Y.shape)}   X: {tuple(X_true.shape)}")

    # Steps 2-4: fit the three engines -------------------------------------
    results = {}
    for step, (name, cls, kwargs) in enumerate([
            ("Naive MF", TemporalAMENaiveMFVI, {}),
            ("Good SMF", TemporalAMEStructuredMFVI,
             {"factorization": "good"}),
            ("Bad SMF", TemporalAMEStructuredMFVI,
             {"factorization": "bad"})], start=2):
        print(f"\nStep {step}: Fitting {name} (lr={lr}, "
              f"max_iter={max_iter})...")
        vi = cls(model, learning_rate=lr, seed=seed, **kwargs)
        history = vi.fit(max_iter=max_iter, verbose=True, check_every=20)
        results[name] = {"vi": vi, "history": history, "X_est": vi.X_mean}

    # Step 5: alignment -----------------------------------------------------
    print("\nStep 5: Aligning estimates with ground truth...")
    for name, r in results.items():
        r["X_aligned"] = align_temporal_states(r["X_est"], X_true,
                                               latent_dim=2)
        r["X_est"] = r["X_aligned"]

    # Step 6: summaries -----------------------------------------------------
    print("\nStep 6: Diagnostic summaries...")
    for name, r in results.items():
        print_diagnostic_summary(name, r["history"], X_true=X_true,
                                 X_est=r["X_aligned"], latent_dim=2)

    # Step 7: comparison ----------------------------------------------------
    print("\nStep 7: Method comparison...")
    compare_methods(results, X_true=X_true)

    # Step 8: figures -------------------------------------------------------
    print("\nStep 8: Saving figures...")
    if can_draw("the 4 figures"):
        from tame_torch.visualization import (
            plot_convergence,
            plot_state_trajectories,
            plot_temporal_contributions,
            plot_three_way_comparison,
        )
        import matplotlib.pyplot as plt

        plot_convergence(results["Good SMF"]["history"],
                         title="Good SMF convergence",
                         save_path=str(out / "convergence.png"))
        plot_state_trajectories(X_true, title="True state trajectories",
                                save_path=str(out / "trajectories.png"))
        add, mult = compute_temporal_contributions(X_true, latent_dim=2)
        plot_temporal_contributions(add, mult, title="True contributions",
                                    save_path=str(out / "contributions.png"))
        plot_three_way_comparison(results, X_true=X_true,
                                  save_path=str(out / "three_way.png"))
        plt.close("all")
        print(f"  4 figures saved to {out}/")

    # Step 9: verdict -------------------------------------------------------
    print("\nStep 9: Verdict")
    finals = {n: r["history"]["reconstruction_error"][-1]
              for n, r in results.items()}
    best = min(finals, key=finals.get)
    print(f"  Best method by final reconstruction MSE: {best} "
          f"({finals[best]:.6f})")
    print("  Expected pattern: Naive ~= Good << Bad (the deliberately "
          "wrong factorization underperforms).")
    return results


if __name__ == "__main__":
    from tame_torch.scripts._common import add_device_flag

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--lr", type=float, default=0.01,
                        help="CAVI damping (reference demo: 0.01)")
    parser.add_argument("--max-iter", type=int, default=100)
    parser.add_argument("--outdir", default="demo_output")
    parser.add_argument("--n-nodes", type=int, default=15)
    parser.add_argument("--n-time", type=int, default=10)
    parser.add_argument("--seed", type=int, default=42)
    add_device_flag(parser)
    args = parser.parse_args()
    main(lr=args.lr, max_iter=args.max_iter, outdir=args.outdir,
         n_nodes=args.n_nodes, n_time=args.n_time, seed=args.seed,
         device=args.device)
