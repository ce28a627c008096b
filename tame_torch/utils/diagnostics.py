"""Diagnostics, formatted summaries, multi-method comparison and MCMC chain
diagnostics (counterpart of :mod:`tame.utils.diagnostics`).

Reconstruction error for static and temporal shapes, additive and
multiplicative variance contributions (per time step as one batched
expression over T), contribution ratio, state MSE, console summaries,
method ranking, windowed convergence tracking, the ELBO gap, the U V'
product correlation, and split R-hat / effective sample size for sample
stacks (chains, draws, ...).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tame_torch.ops import dyad as dyad_ops


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def compute_reconstruction_error(Y_true, Y_pred,
                                 exclude_diagonal: bool = True) -> float:
    """Per-*entry* MSE over (optionally off-diagonal) elements of a
    static (n, n, 2) or temporal (n, n, T, 2) dyad tensor: it divides by
    ``n (n-1) [T] 2``, half the fit history's per-dyad normalization (the
    reference's convention, kept)."""
    Y_true, Y_pred = _t(Y_true), _t(Y_pred)
    sq = (Y_true - Y_pred) ** 2
    if exclude_diagonal:
        n = Y_true.shape[0]
        mask = dyad_ops.offdiag_mask(n, sq.dtype, sq.device)
        if Y_true.ndim == 3:
            sq = sq * mask[:, :, None]
            n_elements = n * (n - 1) * 2
        else:
            sq = sq * mask[:, :, None, None]
            n_elements = n * (n - 1) * Y_true.shape[2] * 2
    else:
        n_elements = sq.numel()
    return float(torch.sum(sq) / n_elements)


def compute_additive_contribution(A, exclude_diagonal: bool = True) -> float:
    """Variance of a_i + b_j over pairs."""
    return float(dyad_ops.additive_contribution(_t(A), exclude_diagonal))


def compute_multiplicative_contribution(M, exclude_diagonal: bool = True
                                        ) -> float:
    """Variance of U_i . V_j over pairs."""
    return float(dyad_ops.multiplicative_contribution(_t(M),
                                                      exclude_diagonal))


def compute_temporal_contributions(X, latent_dim: int,
                                   exclude_diagonal: bool = True
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-time (additive, multiplicative) contributions, each (T,)."""
    X = _t(X).transpose(0, 1)                       # (T, n, d)
    return (dyad_ops.additive_contribution(X[..., :2], exclude_diagonal),
            dyad_ops.multiplicative_contribution(X[..., 2:],
                                                 exclude_diagonal))


def compute_contribution_ratio(A, M) -> float:
    """sqrt(Var_additive / Var_multiplicative); inf when the latter
    vanishes."""
    va = compute_additive_contribution(A)
    vm = compute_multiplicative_contribution(M)
    if vm < 1e-10:
        return float("inf")
    return math.sqrt(va / vm)


def compute_state_prediction_error(X_true, X_pred) -> float:
    """State-space MSE."""
    X_true = _t(X_true)
    return float(torch.mean((X_true - _t(X_pred).to(X_true.device)) ** 2))


def print_diagnostic_summary(method_name: str,
                             history: Dict[str, List[float]],
                             X_true=None, X_est=None,
                             latent_dim: Optional[int] = None,
                             final_only: bool = False) -> None:
    """Formatted console summary of a fit."""
    print("\n" + "=" * 70)
    print(f"Diagnostic Summary: {method_name}")
    print("=" * 70)

    n_iter = len(history["elbo"])
    print(f"Number of iterations: {n_iter}")

    if not final_only and n_iter > 0:
        print(f"Initial ELBO: {history['elbo'][0]:10.2f}")
        print(f"Final ELBO:   {history['elbo'][-1]:10.2f}")
        if n_iter > 1:
            print(f"ELBO change:  "
                  f"{history['elbo'][-1] - history['elbo'][0]:10.2f}")

    if history.get("reconstruction_error"):
        final_mse = history["reconstruction_error"][-1]
        print(f"\nFinal reconstruction MSE: {final_mse:.6f}")
        if not final_only and n_iter > 1:
            init_mse = history["reconstruction_error"][0]
            improvement = (1 - final_mse / init_mse) * 100 if init_mse > 0 else 0
            print(f"MSE improvement: {improvement:.1f}%")

    if X_true is not None and X_est is not None:
        print(f"\nState prediction MSE: "
              f"{compute_state_prediction_error(X_true, X_est):.6f}")

    if X_est is not None and latent_dim is not None:
        X_est = _t(X_est)
        if X_est.ndim == 3:
            A_final, M_final = X_est[:, -1, :2], X_est[:, -1, 2:]
        else:
            A_final, M_final = X_est[:, :2], X_est[:, 2:]
        add = compute_additive_contribution(A_final)
        mult = compute_multiplicative_contribution(M_final)
        ratio = compute_contribution_ratio(A_final, M_final)
        print("\nEffect contributions (final):")
        print(f"  Additive:       {add:.4f}")
        print(f"  Multiplicative: {mult:.4f}")
        print(f"  A/M ratio:      {ratio:.2f}")

    if not final_only:
        extra = [k for k in history
                 if k not in ("elbo", "reconstruction_error")]
        if extra:
            print("\nAdditional metrics:")
            for metric in extra:
                if history[metric]:
                    print(f"  {metric}: {history[metric][-1]:.6f}")

    print("=" * 70)


def compare_methods(results: Dict[str, Dict[str, Any]],
                    metric: str = "reconstruction_error",
                    X_true=None) -> None:
    """Ranked multi-method comparison table."""
    print("\n" + "=" * 70)
    print("Method Comparison")
    print("=" * 70)

    scores = {}
    for name, result in results.items():
        hist = result["history"]
        if metric in hist and hist[metric]:
            scores[name] = hist[metric][-1]
    ranked = sorted(scores.items(), key=lambda kv: kv[1])

    print(f"\nFinal {metric}:")
    for rank, (name, score) in enumerate(ranked, 1):
        print(f"  {rank}. {name:20s}: {score:.6f}")

    if X_true is not None:
        print("\nState prediction MSE:")
        state_errors = {
            name: compute_state_prediction_error(X_true, result["X_est"])
            for name, result in results.items() if "X_est" in result}
        for rank, (name, err) in enumerate(
                sorted(state_errors.items(), key=lambda kv: kv[1]), 1):
            print(f"  {rank}. {name:20s}: {err:.6f}")

    if len(ranked) > 1:
        base_name, base_score = ranked[-1]
        print(f"\nImprovement over {base_name}:")
        for name, score in ranked[:-1]:
            print(f"  {name:20s}: {(1 - score / base_score) * 100:+.1f}%")

    print("=" * 70)


def track_convergence(history: Dict[str, List[float]],
                      window_size: int = 10) -> Dict[str, bool]:
    """Windowed convergence check: converged iff every relative change
    over the last window is below 1e-4."""
    status = {}
    for metric, values in history.items():
        if len(values) < window_size + 1:
            status[metric] = False
            continue
        recent = values[-window_size:]
        rel_changes = [abs(recent[i] - recent[i - 1]) / abs(recent[i - 1])
                       for i in range(1, len(recent))
                       if abs(recent[i - 1]) > 1e-8]
        status[metric] = bool(rel_changes) and max(rel_changes) < 1e-4
    return status


def compute_elbo_gap(elbo_history: List[float],
                     true_log_likelihood: Optional[float] = None
                     ) -> Optional[float]:
    """Gap between a known log p(Y) and the final ELBO."""
    if true_log_likelihood is None or not elbo_history:
        return None
    return true_log_likelihood - elbo_history[-1]


def split_rhat(samples) -> torch.Tensor:
    """Split-chain potential-scale-reduction R-hat (Gelman et al. 2013)
    of a (chains, draws, ...) stack, each chain split in half; shape
    ``samples.shape[2:]``."""
    x = _t(samples)
    half = x.shape[1] // 2
    if half < 2:
        raise ValueError("split_rhat needs at least 4 draws per chain")
    x = torch.cat([x[:, :half], x[:, half:2 * half]], 0)
    n = half
    W = x.var(dim=1, correction=1).mean(0)
    B = n * x.mean(dim=1).var(dim=0, correction=1)
    var_plus = (n - 1) / n * W + B / n
    return torch.sqrt(var_plus / torch.clamp(W, min=1e-12))


def effective_sample_size(samples) -> torch.Tensor:
    """Per-parameter multi-chain effective sample size of a (chains,
    draws, ...) stack: FFT autocovariances, the combined-chain correlation
    ``rho_t = 1 - (W - mean_t) / var_plus`` (Vehtari et al. 2021) and
    Geyer's initial positive sequence.  Host numpy in float64 (not hot-path
    work); returns a float64 tensor of shape ``samples.shape[2:]``."""
    x = (samples.detach().cpu().numpy() if isinstance(samples, torch.Tensor)
         else np.asarray(samples)).astype(np.float64)
    C, N = x.shape[:2]
    P_shape = x.shape[2:]
    flat = x.reshape(C, N, -1)
    P = flat.shape[-1]

    centered = flat - flat.mean(axis=1, keepdims=True)
    nfft = 1
    while nfft < 2 * N:
        nfft *= 2
    f = np.fft.rfft(centered, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :N].real / N
    acov_mean = acov.mean(axis=0)                    # (N, P)

    W = flat.var(axis=1, ddof=1).mean(axis=0)
    B = (N * flat.mean(axis=1).var(axis=0, ddof=1) if C > 1
         else np.zeros(P))
    var_plus = np.maximum((N - 1) / N * W + B / N, 1e-12)

    rho = 1.0 - (W[None] - acov_mean) / var_plus[None]   # (N, P)
    # Geyer's initial positive sequence on the pair sums rho_2t +
    # rho_2t+1: a cumulative-product mask zeroes every pair from the first
    # negative one on.
    n_pairs = (N - 1) // 2
    pair = rho[1:2 * n_pairs + 1].reshape(n_pairs, 2, P).sum(axis=1)
    keep = np.cumprod(pair >= 0, axis=0)
    tau = 1.0 + 2.0 * (pair * keep).sum(axis=0)
    return torch.from_numpy(C * N / np.maximum(tau, 1e-12)).reshape(P_shape)


def chain_diagnostics(positions, logdensities=None) -> Dict[str, float]:
    """Convergence report of a (chains, draws, ...) sample stack: max
    split R-hat, min / median ESS and, given per-draw log densities, the
    R-hat of the log density."""
    rhat = split_rhat(positions)
    ess = effective_sample_size(positions)
    out = {
        "max_rhat": float(torch.max(rhat)),
        "min_ess": float(torch.min(ess)),
        "median_ess": float(np.median(ess.numpy())),
    }
    if logdensities is not None:
        out["logdensity_rhat"] = float(torch.max(split_rhat(logdensities)))
    return out


def compute_uv_product_correlation(M_est, M_true, latent_dim: int) -> float:
    """Correlation of the identified quantity U V' between an estimate and
    the truth."""
    r = latent_dim
    M_est, M_true = _t(M_est), _t(M_true)
    UV_est = (M_est[:, :r] @ M_est[:, r:].T).reshape(-1)
    UV_true = (M_true[:, :r] @ M_true[:, r:].T).reshape(-1)
    xc, yc = UV_true - UV_true.mean(), UV_est - UV_est.mean()
    den = torch.sqrt(torch.sum(xc ** 2) * torch.sum(yc ** 2))
    if float(den) < 1e-10:
        return 0.0
    return float(torch.sum(xc * yc) / den)
