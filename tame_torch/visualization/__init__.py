"""Visualization: static, temporal, comparison and sampler plots
(counterpart of :mod:`tame.visualization`; 21 exports).

matplotlib on host copies of the inputs: numpy arrays, or tensors on any
device (also ones that require grad), which are detached and copied to the
host first.  Plotting is not device work.  Importing this package imports
matplotlib, which the rest of ``tame_torch`` never does at import time.
"""

import matplotlib

# Headless-safe default; callers can switch backends before importing.
if matplotlib.get_backend().lower() not in ("agg",):
    try:
        matplotlib.use("Agg")
    except (ImportError, ValueError):  # pragma: no cover
        pass

from tame_torch.visualization.static import (  # noqa: E402
    plot_contribution_breakdown,
    plot_convergence,
    plot_latent_space,
    plot_network,
    plot_parameter_comparison,
    plot_residuals,
)
from tame_torch.visualization.temporal import (  # noqa: E402
    plot_latent_trajectory_2d,
    plot_network_evolution,
    plot_prediction_horizon,
    plot_state_trajectories,
    plot_temporal_contributions,
    plot_trajectory_comparison,
)
from tame_torch.visualization.mcmc import (  # noqa: E402
    plot_chain_diagnostics,
    plot_smc_diagnostics,
)
from tame_torch.visualization.comparison import (  # noqa: E402
    add_correlation_panels_to_figure,
    plot_computational_efficiency,
    plot_convergence_comparison,
    plot_method_comparison,
    plot_parameter_recovery_grid,
    plot_reconstruction_comparison,
    plot_three_way_comparison,
)

__all__ = [
    "plot_chain_diagnostics",
    "plot_smc_diagnostics",
    "plot_convergence",
    "plot_network",
    "plot_latent_space",
    "plot_contribution_breakdown",
    "plot_parameter_comparison",
    "plot_residuals",
    "plot_state_trajectories",
    "plot_temporal_contributions",
    "plot_trajectory_comparison",
    "plot_network_evolution",
    "plot_latent_trajectory_2d",
    "plot_prediction_horizon",
    "plot_method_comparison",
    "plot_convergence_comparison",
    "plot_reconstruction_comparison",
    "plot_parameter_recovery_grid",
    "plot_computational_efficiency",
    "plot_three_way_comparison",
    "add_correlation_panels_to_figure",
]
