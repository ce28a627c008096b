"""Evaluation utilities (counterpart of :mod:`tame.utils`): alignment,
metrics, diagnostics, and the profiling helpers of the scripts."""

from tame_torch.utils.alignment import (
    align_latent_positions,
    align_signs,
    align_temporal_states,
    compute_alignment_error,
    compute_correlation_after_alignment,
    procrustes_alignment,
)
from tame_torch.utils.diagnostics import (
    chain_diagnostics,
    compare_methods,
    compute_additive_contribution,
    compute_contribution_ratio,
    compute_elbo_gap,
    compute_multiplicative_contribution,
    compute_reconstruction_error,
    compute_state_prediction_error,
    compute_temporal_contributions,
    compute_uv_product_correlation,
    effective_sample_size,
    print_diagnostic_summary,
    split_rhat,
    track_convergence,
)
from tame_torch.utils.metrics import (
    calibration_error,
    compute_coverage,
    link_prediction_metrics,
    mean_absolute_error,
    mean_squared_error,
    pearson_correlation,
    r_squared,
    relative_error,
    root_mean_squared_error,
    temporal_consistency_score,
    temporal_prediction_metrics,
)

__all__ = [
    # Diagnostics
    "compute_reconstruction_error",
    "compute_additive_contribution",
    "compute_multiplicative_contribution",
    "compute_temporal_contributions",
    "compute_contribution_ratio",
    "compute_state_prediction_error",
    "print_diagnostic_summary",
    "compare_methods",
    "track_convergence",
    "compute_elbo_gap",
    "compute_uv_product_correlation",
    # MCMC chain diagnostics
    "split_rhat",
    "effective_sample_size",
    "chain_diagnostics",
    # Alignment
    "procrustes_alignment",
    "align_signs",
    "align_latent_positions",
    "align_temporal_states",
    "compute_alignment_error",
    "compute_correlation_after_alignment",
    # Metrics
    "mean_squared_error",
    "root_mean_squared_error",
    "mean_absolute_error",
    "r_squared",
    "pearson_correlation",
    "temporal_consistency_score",
    "link_prediction_metrics",
    "calibration_error",
    "compute_coverage",
    "temporal_prediction_metrics",
    "relative_error",
]
