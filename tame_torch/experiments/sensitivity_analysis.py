"""Sensitivity analysis: sweep one model parameter x replicate seeds
(counterpart of :mod:`tame.experiments.sensitivity_analysis`).

Naive MF vs Good SMF over a parameter grid, mean +/- std of final MSE and
runtime, errorbar/runtime/improvement plots (with matplotlib) and a
markdown report.  Each replicate has its own data, init and mask, drawn
from generators seeded from the pair (sweep seed, replicate).  Two
deliberate differences from ``tame``:

* the replicates run one after another, one Jacobi fit each (one K3
  launch on the card where the fit is inside K3's envelope), where
  ``tame`` ``vmap``s them into one compiled batch; each replicate stops at
  its own iteration either way;
* the sweep seed is ``seed + crc32(parameter) % 1000``, stable across
  processes, where ``tame`` adds ``hash(parameter) % 1000``, which Python
  randomizes per process (``PYTHONHASHSEED``), so ``tame``'s sweep draws
  other data on every run.
"""

from __future__ import annotations

import time
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from tame_torch.config import ModelConfig
from tame_torch.experiments.utils import (
    can_draw,
    print_experiment_header,
    save_results,
    setup_experiment_dir,
)
from tame_torch.scripts._common import resolve_device
from tame_torch.inference import cavi
from tame_torch.models import AMEParams, build_params, random_dyad_mask, sample

SWEEPABLE = ("n_nodes", "n_time", "ar_coefficient", "rho_dyadic",
             "missing_frac")
_METHODS = {"Naive MF": "diag", "Good SMF": "full"}


def sweep_seed(seed: int, parameter: str) -> int:
    """The seed of a parameter's sweep: ``seed`` plus a stable offset from
    the parameter's name (the same in every process)."""
    return seed + zlib.crc32(parameter.encode()) % 1000


def _pair_seed(seed: int, replicate: int) -> int:
    return int(np.random.SeedSequence((seed, replicate)).generate_state(1)[0])


def replicate_inputs(params: AMEParams, cfg: ModelConfig, structure: str,
                     seed: int, replicate: int, missing_frac: float = 0.0,
                     device: str = "cuda"):
    """One replicate's ``(Y, init, mask)``: data and mask from a generator
    on ``device``, the init from a CPU generator (as the engines draw
    theirs), both seeded from the pair ``(seed, replicate)``."""
    s = _pair_seed(seed, replicate)
    gen = torch.Generator(device=device).manual_seed(s)
    Y, _ = sample(params, gen, cfg.n_nodes, cfg.n_time)
    init = cavi.init_state(torch.Generator().manual_seed(s), cfg.n_nodes,
                           cfg.n_time, cfg.d, structure, 0.1, 0.5,
                           device=device)
    mask = (random_dyad_mask(gen, cfg.n_nodes, cfg.n_time, missing_frac)
            if missing_frac else None)
    return Y, init, mask


def fit_replicate(Y, params: AMEParams, init, structure: str, max_iter: int,
                  learning_rate: float, mask=None):
    """One replicate's Jacobi fit: ``(final MSE, iterations)`` (per-dyad
    normalization)."""
    out = cavi.fit_cavi(Y, params, init, structure=structure,
                        update_mode="jacobi", max_iter=max_iter,
                        learning_rate=learning_rate, mask=mask)
    return float(out.mse_history[out.n_iter - 1]), int(out.n_iter)


def _replicate_fits(cfg: ModelConfig, structure: str, n_replicates: int,
                    max_iter: int, learning_rate: float, seed: int,
                    missing_frac: float = 0.0, device: str = "cuda"):
    """Generate data, initialize and fit ``n_replicates`` instances, one
    after another.  Returns final per-replicate MSE and iteration counts.
    ``missing_frac > 0`` hides that fraction of dyads per replicate (each
    replicate gets its own random mask) and fits on the rest — the
    missing-data sweep axis."""
    params = build_params(cfg).to(device)
    mses, iters = [], []
    for replicate in range(n_replicates):
        Y, init, mask = replicate_inputs(params, cfg, structure, seed,
                                         replicate, missing_frac, device)
        mse, n_iter = fit_replicate(Y, params, init, structure, max_iter,
                                    learning_rate, mask)
        mses.append(mse)
        iters.append(n_iter)
    return np.asarray(mses), np.asarray(iters)


def run_sensitivity_analysis(
    parameter: str = "n_nodes",
    values: Optional[list] = None,
    base_params: Optional[dict] = None,
    max_iter: int = 150,
    learning_rate: float = 0.01,
    n_replicates: int = 3,
    seed: int = 42,
    save_outputs: bool = True,
    device: str = "cuda",
):
    """Sweep ``parameter`` over ``values`` with ``n_replicates`` seeded
    replicates per value, on ``device``.

    Returns ``(results, exp_dir)``; ``results['data'][value]`` holds
    per-method ``{'mse_mean','mse_std','mses','runtime','iterations'}``.
    """
    device = resolve_device(device).type
    if parameter not in SWEEPABLE:
        raise ValueError(
            f"Unknown parameter '{parameter}'; choose from {SWEEPABLE}")
    if values is None:
        values = ([0.0, 0.1, 0.3, 0.5] if parameter == "missing_frac"
                  else [10, 15, 20, 25, 30])
    if base_params is None:
        base_params = {"n_nodes": 15, "n_time": 10, "latent_dim": 2,
                       "ar_coefficient": 0.8, "rho_dyadic": 0.5}

    print_experiment_header(f"Sensitivity Analysis: {parameter}", {
        **base_params, "varied_parameter": parameter,
        "parameter_values": values, "max_iter": max_iter,
        "n_replicates": n_replicates, "seed": seed})

    exp_dir = None
    if save_outputs:
        exp_dir = setup_experiment_dir(f"sensitivity_{parameter}")
        print(f"Results will be saved to: {exp_dir}\n")

    results = {"parameter": parameter, "values": list(values),
               "base_params": dict(base_params), "data": {}}

    for value in values:
        print("\n" + "=" * 70)
        print(f"{parameter.upper()} = {value}")
        print("=" * 70)
        model_kwargs = dict(base_params)
        model_kwargs.pop("missing_frac", None)
        missing_frac = float(base_params.get("missing_frac", 0.0))
        if parameter == "missing_frac":
            missing_frac = float(value)
        else:
            model_kwargs[parameter] = value
        cfg = ModelConfig(**model_kwargs, seed=seed)

        per_value = {}
        for method_name, structure in _METHODS.items():
            start = time.time()
            mses, iters = _replicate_fits(
                cfg, structure, n_replicates, max_iter, learning_rate,
                sweep_seed(seed, parameter), missing_frac=missing_frac,
                device=device)
            runtime = time.time() - start
            per_value[method_name] = {
                "mses": mses.tolist(),
                "mse_mean": float(mses.mean()),
                "mse_std": float(mses.std()),
                "runtime": runtime / n_replicates,
                "iterations": iters.tolist(),
            }
            print(f"  {method_name}: MSE = {mses.mean():.4f} "
                  f"+/- {mses.std():.4f}  "
                  f"({runtime / n_replicates:.2f} s/replicate)")
        results["data"][value] = per_value

    if save_outputs:
        if can_draw("the sensitivity figure"):
            _plot_sensitivity(results, exp_dir)
        save_results(results, exp_dir)
        _generate_sensitivity_report(results, exp_dir)
    return results, exp_dir


def _plot_sensitivity(results: Dict, exp_dir) -> None:
    """Errorbar / runtime / improvement plots."""
    import matplotlib.pyplot as plt

    values = results["values"]
    figdir = exp_dir / "figures"

    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    for method, color in (("Naive MF", "tab:blue"), ("Good SMF", "tab:orange")):
        means = [results["data"][v][method]["mse_mean"] for v in values]
        stds = [results["data"][v][method]["mse_std"] for v in values]
        axes[0].errorbar(values, means, yerr=stds, marker="o", capsize=4,
                         label=method, color=color)
        runtimes = [results["data"][v][method]["runtime"] for v in values]
        axes[1].plot(values, runtimes, marker="s", label=method, color=color)
    axes[0].set_xlabel(results["parameter"])
    axes[0].set_ylabel("Final MSE")
    axes[0].set_title("Reconstruction error")
    axes[0].legend()
    axes[0].grid(alpha=0.3)
    axes[1].set_xlabel(results["parameter"])
    axes[1].set_ylabel("Runtime per replicate (s)")
    axes[1].set_title("Runtime")
    axes[1].legend()
    axes[1].grid(alpha=0.3)

    improvements = []
    for v in values:
        naive = results["data"][v]["Naive MF"]["mse_mean"]
        good = results["data"][v]["Good SMF"]["mse_mean"]
        improvements.append((1 - good / naive) * 100 if naive > 0 else 0.0)
    axes[2].bar([str(v) for v in values], improvements, color="tab:green",
                alpha=0.8)
    axes[2].axhline(0, color="gray", lw=1)
    axes[2].set_xlabel(results["parameter"])
    axes[2].set_ylabel("Good SMF improvement over Naive (%)")
    axes[2].set_title("Relative improvement")
    axes[2].grid(axis="y", alpha=0.3)

    fig.tight_layout()
    fig.savefig(figdir / "sensitivity.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def _generate_sensitivity_report(results: Dict, exp_dir) -> None:
    """Markdown report."""
    path = exp_dir / "report.md"
    with open(path, "w") as f:
        f.write(f"# Sensitivity Analysis: {results['parameter']}\n\n")
        f.write(f"Base parameters: `{results['base_params']}`\n\n")
        f.write("| Value | Naive MF MSE | Good SMF MSE | Improvement |\n")
        f.write("|-------|--------------|--------------|-------------|\n")
        for v in results["values"]:
            naive = results["data"][v]["Naive MF"]
            good = results["data"][v]["Good SMF"]
            imp = ((1 - good["mse_mean"] / naive["mse_mean"]) * 100
                   if naive["mse_mean"] > 0 else 0.0)
            f.write(f"| {v} | {naive['mse_mean']:.4f} +/- "
                    f"{naive['mse_std']:.4f} | {good['mse_mean']:.4f} +/- "
                    f"{good['mse_std']:.4f} | {imp:+.1f}% |\n")
        f.write("\nReplicates run one after another, each from its own "
                "seeded generators (one fit per replicate).\n")
    print(f"Sensitivity report saved to: {path}")


if __name__ == "__main__":
    run_sensitivity_analysis(
        parameter="n_nodes", values=[10, 15, 20, 25, 30],
        max_iter=150, learning_rate=0.7, n_replicates=3, seed=42)
