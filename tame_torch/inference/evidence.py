"""Exact ELBO, a true lower bound on log p(Y), for the smoothed family
(counterpart of :mod:`tame.inference.evidence`).

The per-iteration "ELBO" of the engines follows the reference's
conventions (plug-in likelihood at the means plus an ad-hoc trace
correction) and is not a bound.  This module computes

    ELBO(q) = E_q[log p(Y | X)] + E_q[log p(X)] + H[q]

in closed form: the expected Gaussian dyad quadratic with the exact
posterior moments of the bilinear predictor
(:func:`tame_torch.inference.em._residual_moments` and
``_residual_moment_corrections``), and the smoothed family's exact
cross-time prior and entropy terms
(:func:`tame_torch.inference.smoothed.smoothed_prior_entropy`).
"""

from __future__ import annotations

import torch

from tame_torch.inference import cavi
from tame_torch.inference.em import (
    _residual_moment_corrections,
    _residual_moments,
)
from tame_torch.inference.smoothed import (
    SmoothedState,
    smoothed_prior_entropy,
)
from tame_torch.models.params import AMEParams

_LOG2PI = 1.8378770664093453


def exact_elbo(Y: torch.Tensor, params: AMEParams, state: SmoothedState,
               mask=None) -> torch.Tensor:
    """The exact evidence lower bound of a smoothed variational state
    (Gaussian dyads).  ``mask``: an (n, n, T) observation gate; the bound
    is then on the observed-dyad evidence.

    The mask's diagonal is zeroed before the plug-in statistics, so they
    and the variance corrections sum over the same pairs.  (The JAX
    function zeroes it for the corrections only; the two agree on every
    zero-diagonal mask.)

    A sharded ``Y`` and ``state`` (:func:`tame_torch.parallel.
    shard_smoothed_inputs`, a sharded fit's ``field("state")``; ``mask``
    the whole mask) sum the moments and terms of each rank's nodes
    (:func:`tame_torch.parallel.sharded_em.exact_elbo_terms`)."""
    if cavi._sharded(Y, state):
        from tame_torch.parallel.sharded_em import exact_elbo_terms

        params = params.to(Y.mesh.device)
        pri = cavi.precompute_priors(params)
        return elbo_from_moments(params, pri, *exact_elbo_terms(
            Y, params, pri, state, mask))
    pri = cavi.precompute_priors(params)
    if mask is not None:
        mask = cavi.gated_mask(mask, Y)
    sq, cross, count = _residual_moments(Y, state.X_mean, mask)
    var_corr, cross_corr = _residual_moment_corrections(state, mask)
    return elbo_from_moments(params, pri, sq, cross, count, var_corr,
                             cross_corr,
                             *smoothed_prior_entropy(params, pri, state))


def elbo_from_moments(params: AMEParams, pri: cavi.PriorMatrices, sq, cross,
                      count, var_corr, cross_corr, prior0, priort,
                      entropy) -> torch.Tensor:
    """The exact ELBO from the residual statistics, their variance
    corrections, the observed count and the prior and entropy terms."""
    p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
    quad = p_ * (sq + var_corr) + q_ * (cross + cross_corr)
    log_lik = -0.5 * (quad + 0.5 * count * (pri.logdet_R + 2.0 * _LOG2PI))
    return log_lik + prior0 + priort + entropy
