"""Fits run by the reference, and the numbers that decide ``correct``.

``reference_fit`` replays one fit of a cell from the inputs the benchmark
handed the program (the network, its mask, the configuration, and the
engine's seed or the warm start), in a given precision: float64 to judge,
TF32 for the control (the precision just below the float32 the
configurations state).  The replay of each kind of fit, and the settings
it implements, are ``tbench/reference/kinds/<kind>.py``'s: a cell whose
configuration or traffic states a setting its kind does not replay is
refused before it runs, never judged against another fit.

The numbers compared, each over the sampled fits:

* ``mu_gap``: the widest gap between the program's and the reference's
  dyadic means ``a_i + b_j + U_i . V_j`` (i != j, every t) after the
  program's last iteration, over the largest reference mean;
* ``elbo_median_gap``: the median over the fit's iterations of the
  relative gap between the two ELBO histories;
* ``elbo_tail_gap``: the widest of those gaps after the first ``settle``
  iterations (the checks file's): while a random start settles, float32
  rounding is amplified (the float32 reference reads as the program
  there), so the widest gap over every iteration cannot tell float32 from
  the control, and the median alone would pass an ELBO wrong on a few
  late iterations;
* ``stop_gap``: how far the program's stop lies from where the stopping
  rule (relative ELBO change under the tolerance on ``patience``
  consecutive iterations, in float32, or a non-finite ELBO, or
  ``max_iter``) puts it on the program's own ELBO history.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from tbench import spec
from tbench.reference import fits
from tbench.reference.model import PRECISIONS, Precision, build_params


class Outcome(NamedTuple):
    """What a fit produced: its final means (n, T, d) and ELBO history."""

    X: torch.Tensor
    elbo: List[float]


def stop_index(elbo: Sequence[float], tolerance: float, patience: int,
               max_iter: int) -> int:
    """The number of iterations after which the stopping rule ends a fit
    with this ELBO history."""
    prev = np.float32(-np.inf)
    tol = np.float32(tolerance)
    pat = 0
    for i, e in enumerate(elbo):
        e32 = np.float32(e)
        if not math.isfinite(e):
            return i + 1
        with np.errstate(invalid="ignore", over="ignore"):
            rel = np.abs(e32 - prev) / (np.abs(prev) + np.float32(1e-8))
        pat = pat + 1 if (np.isfinite(prev) and rel < tol) else 0
        prev = e32
        if pat >= patience:
            return i + 1
    return max_iter


def refuse_unless(config: dict, traffic: dict, replays: dict) -> None:
    """Raise ``ValueError`` where the configuration's ``fit`` group or the
    traffic states a setting outside ``replays``: ``{"fit": {key:
    allowed values}, "traffic": {...}}``."""
    for group, allowed in replays.items():
        stated = config["fit"] if group == "fit" else traffic
        for key, values in allowed.items():
            if stated.get(key) not in values:
                raise ValueError(
                    f"the reference replays {group} {key} in {values}, "
                    f"the cell states {stated.get(key)!r}")


def check_cell(cell) -> None:
    """Refuse a cell whose fits the reference of its kind does not
    replay."""
    spec.reference_kind(cell.traffic["kind"]).check(cell.config,
                                                    cell.traffic)


def reference_fit(cell, Y: torch.Tensor, mask: Optional[torch.Tensor],
                  engine_seed: int, precision: str,
                  n_iter: Optional[int] = None, device=None) -> Outcome:
    """Replay one fit of ``cell`` in ``precision`` ("f64", "f32" or
    "tf32") on ``device`` (default ``Y``'s): ``n_iter`` iterations, or to
    the stopping rule (at most ``max_iter``) when None."""
    kind = spec.reference_kind(cell.traffic["kind"])
    kind.check(cell.config, cell.traffic)
    prec: Precision = PRECISIONS[precision]
    fit = cell.config["fit"]
    dev = torch.device(device) if device is not None else Y.device
    Y = Y.to(dev)
    mask = None if mask is None else mask.to(dev)
    T = Y.shape[2]
    params = build_params(cell.config["model"], prec.dtype, dev)
    data = fits.prepare(Y, mask, params, prec)
    pri = fits.prior(params, T, prec)
    X, step = kind.start(data, params, pri, prec, cell.config, cell.traffic,
                         engine_seed)
    budget = fit["max_iter"] if n_iter is None else n_iter
    elbo: List[float] = []
    for _ in range(budget):
        elbo.append(float(step()))
        if n_iter is None and stop_index(
                elbo, fit["tolerance"], fit["patience"],
                fit["max_iter"]) <= len(elbo):
            break
    return Outcome(X=X, elbo=elbo)


def dyadic_gap(X: torch.Tensor, X_ref: torch.Tensor, chunk: int = 5):
    """``(max |mu - mu_ref|, max |mu_ref|)`` over i != j and every t, in
    float64, time steps in chunks."""
    r = (X.shape[-1] - 2) // 2
    n = X.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=X_ref.device)
    gap = top = 0.0
    for t0 in range(0, X.shape[1], chunk):
        mus = []
        for Z in (X, X_ref):
            Z = Z[:, t0:t0 + chunk].to(device=X_ref.device,
                                      dtype=torch.float64)
            a, b, U, V = Z[..., 0], Z[..., 1], Z[..., 2:2 + r], Z[..., 2 + r:]
            mus.append(a[:, None] + b[None, :]
                       + torch.einsum("itr,jtr->ijt", U, V))
        gap = max(gap, float((mus[0] - mus[1]).abs()[off].max()))
        top = max(top, float(mus[1].abs()[off].max()))
    return gap, top


def elbo_gaps(elbo: Sequence[float], ref_elbo: Sequence[float]):
    """The relative gap ``|e - e_ref| / |e_ref|`` at each iteration both
    ELBO histories hold."""
    k = min(len(elbo), len(ref_elbo))
    e, er = np.asarray(elbo[:k]), np.asarray(ref_elbo[:k])
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.abs(e - er) / np.abs(er)


def tail_gap(rel, settle: int) -> float:
    """The widest of the gaps ``rel`` after ``settle`` iterations (never
    all of them)."""
    return float(np.max(rel[min(settle, len(rel) - 1):])) if len(rel) \
        else math.inf


def fit_numbers(got: Outcome, ref: Outcome, fit: dict, settle: int) -> dict:
    """The compared numbers for one fit (see the module docstring)."""
    gap, top = dyadic_gap(got.X, ref.X)
    rel = elbo_gaps(got.elbo, ref.elbo)
    elbo_gap = float(np.median(rel)) if len(rel) else math.inf
    tail = tail_gap(rel, settle)
    if not np.all(np.isfinite(rel)) or len(ref.elbo) < len(got.elbo):
        elbo_gap = tail = math.inf
    stop = stop_index(got.elbo, fit["tolerance"], fit["patience"],
                      fit["max_iter"])
    return {"mu_gap": gap / top if top > 0 else math.inf,
            "elbo_median_gap": elbo_gap, "elbo_tail_gap": tail,
            "stop_gap": float(abs(len(got.elbo) - stop))}


KEYS = ("mu_gap", "elbo_median_gap", "elbo_tail_gap", "stop_gap")


def worst(readings: Sequence[dict]) -> dict:
    """The largest of each number over several fits."""
    return {k: max((r[k] for r in readings), default=math.inf) for k in KEYS}
