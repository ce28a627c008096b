"""Experiment harness utilities: result dirs, persistence, timing, reports
(counterpart of :mod:`tame.experiments.utils`).

Timestamped ``results/<name>_<ts>/{figures,data}`` trees, pickle + JSON
persistence, a timed method runner producing the standard results dict
(the lingua franca consumed by ``compare_methods`` and the comparison
plots), markdown report generation and header printing.  Tensors, on any
device, are pickled as numpy arrays and left out of the JSON summary, so
results saved on the card load on a machine without one.
``set_random_seeds`` seeds numpy only: randomness in this package flows
through explicit ``torch.Generator`` objects.
"""

from __future__ import annotations

import importlib.util
import json
import pickle
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def setup_experiment_dir(experiment_name: str,
                         base_dir: str = "results") -> Path:
    """Create ``<base>/<name>_<timestamp>/{figures,data}``."""
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    exp_dir = Path(base_dir) / f"{experiment_name}_{timestamp}"
    exp_dir.mkdir(parents=True, exist_ok=True)
    (exp_dir / "figures").mkdir(exist_ok=True)
    (exp_dir / "data").mkdir(exist_ok=True)
    return exp_dir


def _convert_to_json_serializable(obj: Any) -> Any:
    """Strip arrays and tensors; keep scalars/strings/containers."""
    if isinstance(obj, dict):
        return {k: _convert_to_json_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_convert_to_json_serializable(v) for v in obj]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return None
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (int, float, str, bool, type(None))):
        return obj
    return str(obj)


def _to_host(obj: Any) -> Any:
    """The same containers with every tensor replaced by a numpy array."""
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def save_results(results: Dict[str, Any], exp_dir: Path,
                 filename: str = "results.pkl") -> None:
    """Pickle full results (tensors as numpy) + JSON summary with arrays
    stripped."""
    pkl_path = exp_dir / "data" / filename
    with open(pkl_path, "wb") as f:
        pickle.dump(_to_host(results), f)
    print(f"Results saved to: {pkl_path}")

    try:
        json_results = _convert_to_json_serializable(results)
        json_path = exp_dir / "data" / filename.replace(".pkl", ".json")
        with open(json_path, "w") as f:
            json.dump(json_results, f, indent=2)
        print(f"JSON summary saved to: {json_path}")
    except (TypeError, ValueError, OSError) as e:
        print(f"Could not save JSON summary: {e}")


def load_results(exp_dir: Path, filename: str = "results.pkl"
                 ) -> Dict[str, Any]:
    """Load a pickled results dict."""
    with open(Path(exp_dir) / "data" / filename, "rb") as f:
        return pickle.load(f)


def sync_device(x) -> None:
    """Wait for the card if ``x`` lives there (host clocks stop after the
    device's work, not after its enqueue)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def run_method_with_timing(vi_class, model, method_name: str,
                           max_iter: int = 100, verbose: bool = True,
                           **vi_kwargs) -> Dict[str, Any]:
    """Instantiate + fit a VI engine with wall-clock timing (the card
    synchronized before the clock starts and stops); returns the standard
    results dict ``{vi, history, X_est, runtime, iterations,
    method_name}``."""
    if verbose:
        print(f"\n{'=' * 70}")
        print(f"Running: {method_name}")
        print(f"{'=' * 70}")

    vi = vi_class(model, **vi_kwargs)
    sync_device(vi.X_mean)
    start = time.time()
    history = vi.fit(max_iter=max_iter, verbose=verbose)
    sync_device(vi.X_mean)
    runtime = time.time() - start

    X_est = getattr(vi, "X_mean", None)
    if X_est is None and hasattr(vi, "get_variational_means"):
        X_est = vi.get_variational_means()

    result = {
        "vi": vi,
        "history": history,
        "X_est": X_est,
        "runtime": runtime,
        "iterations": len(history.get("elbo", [])) or max_iter,
        "method_name": method_name,
    }
    if verbose:
        print(f"\nCompleted in {runtime:.2f} seconds")
        if history.get("reconstruction_error"):
            print(f"Final MSE: {history['reconstruction_error'][-1]:.6f}")
    return result


def generate_experiment_report(results: Dict[str, Dict[str, Any]],
                               exp_dir: Path,
                               X_true=None,
                               experiment_name: str = "Experiment",
                               latent_dim: int = 2) -> None:
    """Markdown report: summary table, rankings, improvements, parameter
    recovery, figure listing."""
    report_path = Path(exp_dir) / "report.md"
    with open(report_path, "w") as f:
        f.write(f"# {experiment_name} Report\n\n")
        f.write(f"**Generated:** "
                f"{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}\n\n")
        f.write(f"**Output Directory:** `{exp_dir}`\n\n")

        f.write("## Summary\n\n")
        f.write("| Method | Final MSE | Runtime (s) | Iterations |\n")
        f.write("|--------|-----------|-------------|------------|\n")
        for name, result in results.items():
            history = result.get("history", {})
            mse = (history.get("reconstruction_error") or [0])[-1]
            f.write(f"| {name} | {mse:.6f} | "
                    f"{result.get('runtime', 0):.2f} | "
                    f"{result.get('iterations', 0)} |\n")

        ranked = sorted(
            ((name, (r.get("history", {}).get("reconstruction_error")
                     or [np.inf])[-1])
             for name, r in results.items()),
            key=lambda kv: kv[1])
        if ranked:
            f.write("\n## Rankings\n\n")
            f.write("### By Reconstruction Error (Best to Worst)\n\n")
            for rank, (name, mse) in enumerate(ranked, 1):
                f.write(f"{rank}. **{name}**: {mse:.6f}\n")
            if len(ranked) > 1:
                base_name, base_mse = ranked[-1]
                f.write(f"\n### Improvement over Baseline ({base_name})\n\n")
                for name, mse in ranked[:-1]:
                    f.write(f"- **{name}**: "
                            f"{(1 - mse / base_mse) * 100:+.1f}%\n")

        if X_true is not None:
            from tame_torch.utils import compute_alignment_error

            X_true = torch.as_tensor(X_true)
            f.write("\n## Parameter Recovery\n\n")
            f.write("| Method | Alignment Error |\n")
            f.write("|--------|----------------|\n")
            for name, result in results.items():
                if result.get("X_est") is not None:
                    error, _ = compute_alignment_error(
                        torch.as_tensor(result["X_est"]).to(X_true.device),
                        X_true, latent_dim=latent_dim, align=True)
                    f.write(f"| {name} | {error:.6f} |\n")

        f.write("\n## Figures\n\n")
        f.write("Generated figures can be found in the `figures/` "
                "subdirectory:\n\n")
        figures_dir = Path(exp_dir) / "figures"
        if figures_dir.exists():
            for fig_file in sorted(figures_dir.glob("*.png")):
                f.write(f"- `{fig_file.name}`\n")
        f.write("\n---\n\n*Report generated automatically by "
                "tame_torch.experiments.utils*\n")
    print(f"\nExperiment report saved to: {report_path}")


def set_random_seeds(seed: int = 42) -> None:
    """Seeds numpy's global RNG for any host-side randomness.  Device
    randomness in this package is seeded explicitly per model/engine."""
    np.random.seed(seed)


def print_experiment_header(experiment_name: str,
                            params: Dict[str, Any]) -> None:
    """Formatted experiment banner."""
    print("\n" + "=" * 70)
    print(f"EXPERIMENT: {experiment_name}")
    print("=" * 70)
    print("\nParameters:")
    for key, value in params.items():
        print(f"  {key:20s}: {value}")
    print("=" * 70 + "\n")


def can_draw(what: str) -> bool:
    """Whether matplotlib is installed; if not, say that ``what`` was not
    drawn and why.  Figures are the one part of the host layers that needs
    it (a machine without it still runs every fit and saves every
    result)."""
    if importlib.util.find_spec("matplotlib") is not None:
        return True
    print(f"matplotlib is not installed: {what} not drawn.")
    return False
