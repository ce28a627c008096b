"""Performance metrics for AME model evaluation (counterpart of
:mod:`tame.utils.metrics`): masked MSE/RMSE/MAE/R^2/Pearson, temporal
smoothness, link-prediction metrics, calibration, coverage, horizon
metrics and relative error.  Tensor math on the inputs' device, Python
floats at the boundary.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def _np(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _masked_mean(values: torch.Tensor, mask) -> float:
    if mask is not None:
        mask = torch.as_tensor(mask, device=values.device)
        count = float(torch.sum(mask))
        if count == 0:
            return 0.0
        return float(torch.sum(values * mask) / count)
    return float(torch.mean(values))


def mean_squared_error(y_true, y_pred, mask=None) -> float:
    """Masked mean squared error."""
    return _masked_mean((_t(y_true) - _t(y_pred)) ** 2, mask)


def root_mean_squared_error(y_true, y_pred, mask=None) -> float:
    """sqrt(MSE)."""
    return math.sqrt(mean_squared_error(y_true, y_pred, mask))


def mean_absolute_error(y_true, y_pred, mask=None) -> float:
    """Masked mean absolute error."""
    return _masked_mean(torch.abs(_t(y_true) - _t(y_pred)), mask)


def _selected(y_true, y_pred, mask):
    y_true, y_pred = _t(y_true), _t(y_pred)
    if mask is not None:
        sel = torch.as_tensor(mask, device=y_true.device) > 0
        return y_true[sel], y_pred[sel]
    return y_true.reshape(-1), y_pred.reshape(-1)


def r_squared(y_true, y_pred, mask=None) -> float:
    """Coefficient of determination over the (masked) entries."""
    y_true, y_pred = _selected(y_true, y_pred, mask)
    if y_true.numel() == 0:
        return 0.0
    ss_tot = float(torch.sum((y_true - y_true.mean()) ** 2))
    ss_res = float(torch.sum((y_true - y_pred) ** 2))
    return 0.0 if ss_tot < 1e-10 else 1.0 - ss_res / ss_tot


def pearson_correlation(y_true, y_pred, mask=None) -> float:
    """Pearson correlation over the (masked) entries."""
    y_true, y_pred = _selected(y_true, y_pred, mask)
    if y_true.numel() < 2:
        return 0.0
    xc, yc = y_true - y_true.mean(), y_pred - y_pred.mean()
    den = torch.sqrt(torch.sum(xc ** 2) * torch.sum(yc ** 2))
    if float(den) < 1e-10:
        return 0.0
    return float(torch.sum(xc * yc) / den)


def temporal_consistency_score(X, order: int = 1) -> float:
    """Mean norm of order-k finite differences along time of (n, T, d)
    states; lower is smoother."""
    X = _t(X)
    if X.shape[1] < order + 1:
        return 0.0
    diffs = X[:, 1:] - X[:, :-1]
    for _ in range(order - 1):
        if diffs.shape[1] < 2:
            break
        diffs = diffs[:, 1:] - diffs[:, :-1]
    return float(torch.linalg.norm(diffs, dim=-1).mean())


def link_prediction_metrics(Y_true, Y_pred,
                            threshold: float = 0.0) -> Dict[str, float]:
    """Binary link-prediction accuracy/precision/recall/F1 at a threshold,
    diagonal excluded (as a negative in both)."""
    Y_true, Y_pred = _t(Y_true), _t(Y_pred)
    n = Y_true.shape[0]
    mask = 1.0 - torch.eye(n, dtype=Y_true.dtype, device=Y_true.device)
    tb = Y_true * mask > threshold
    pb = Y_pred * mask > threshold
    tp = float(torch.sum(tb & pb))
    tn = float(torch.sum(~tb & ~pb))
    fp = float(torch.sum(~tb & pb))
    fn = float(torch.sum(tb & ~pb))
    total = tp + tn + fp + fn
    accuracy = (tp + tn) / total if total > 0 else 0.0
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return {"accuracy": accuracy, "precision": precision,
            "recall": recall, "f1": f1}


def calibration_error(predictions, uncertainties, targets,
                      n_bins: int = 10) -> float:
    """Expected calibration error by uncertainty-sorted bins (host numpy:
    a sort and a short loop over bins)."""
    predictions = _np(predictions).ravel()
    uncertainties = _np(uncertainties).ravel()
    targets = _np(targets).ravel()
    errors = np.abs(predictions - targets)
    order = np.argsort(uncertainties)
    errors_sorted = errors[order]
    unc_sorted = uncertainties[order]
    n = len(predictions)
    bin_size = n // n_bins
    ece = 0.0
    for i in range(n_bins):
        start = i * bin_size
        end = (i + 1) * bin_size if i < n_bins - 1 else n
        if end <= start:
            continue
        ece += (end - start) / n * abs(errors_sorted[start:end].mean()
                                       - unc_sorted[start:end].mean())
    return float(ece)


def compute_coverage(predictions, lower_bounds, upper_bounds,
                     targets) -> float:
    """Empirical coverage of prediction intervals."""
    targets = _t(targets)
    inside = ((targets >= _t(lower_bounds).to(targets.device))
              & (targets <= _t(upper_bounds).to(targets.device)))
    return float(inside.float().mean())


def temporal_prediction_metrics(Y_true, Y_pred,
                                horizon: int = 1) -> Dict[str, float]:
    """MSE/MAE/R^2 over the off-diagonal dyads at times >= ``horizon``."""
    Y_true, Y_pred = _t(Y_true), _t(Y_pred)
    n, _, T, _ = Y_true.shape
    if T <= horizon:
        return {"mse": float("inf"), "mae": float("inf"), "r2": 0.0}
    Yt, Yp = Y_true[:, :, horizon:], Y_pred[:, :, horizon:]
    mask = (1.0 - torch.eye(n, device=Yt.device))[:, :, None, None].expand(
        Yt.shape)
    return {"mse": mean_squared_error(Yt, Yp, mask),
            "mae": mean_absolute_error(Yt, Yp, mask),
            "r2": r_squared(Yt, Yp, mask)}


def relative_error(y_true, y_pred, epsilon: float = 1e-8) -> float:
    """Mean of |err| / (|true| + eps)."""
    y_true, y_pred = _t(y_true), _t(y_pred)
    return float((torch.abs(y_true - y_pred)
                  / (torch.abs(y_true) + epsilon)).mean())
