"""Reproducible experiment harness and entry points (counterpart of
:mod:`tame.experiments`)."""

from tame_torch.experiments.utils import (
    generate_experiment_report,
    load_results,
    print_experiment_header,
    run_method_with_timing,
    save_results,
    set_random_seeds,
    setup_experiment_dir,
)

__all__ = [
    "setup_experiment_dir",
    "save_results",
    "load_results",
    "run_method_with_timing",
    "generate_experiment_report",
    "set_random_seeds",
    "print_experiment_header",
]
