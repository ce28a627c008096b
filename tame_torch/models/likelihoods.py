"""Declarative dyadic-likelihood families (counterpart of
:mod:`tame.models.likelihoods`).

A family declares how dyad observations relate to the bilinear predictor

    mu_ij^t = a_i + b_j + U_i . V_j,

through:

* ``log_prob(params, Y, mu, mask)`` — summed log-likelihood over unordered
  observed dyads; ``Y``/``mu`` are the (n, n, T, 2) reciprocal tensors,
  ``mask`` an (n, n, T) off-diagonal/observation gate.
* ``sample(generator, params, mu)`` — dyad observations given the
  predictor, drawn from a ``torch.Generator`` on its device, in the same
  reciprocal layout (``Y[i,j,t] = [y_ij, y_ji]``).
* optionally ``vi_surrogate(y0, offd, m, var)`` — the quadratic variational
  surrogate that plugs the family into the VI/EM layer
  (:func:`tame_torch.inference.family_smoothed.fit_smoothed_family`,
  ``fit_em(family=...)``): given the per-directed-dyad observations ``y0``,
  the observation gate ``offd`` and the posterior predictor moments
  ``m``/``var`` (all of one shape; the engines pass them time-major,
  (T, n, n)), return ``(loglik, w, s)`` — the summed expected (or
  lower-bounded) log-likelihood, the per-dyad pseudo-precision and the
  linear coefficient such that each dyad contributes ``s m - (w/2) m^2``.
  Every built-in surrogate is elementwise followed by one sum, so any
  layout of the three tensors gives the same values.

``gaussian`` is the CAVI engines' exchangeable-R dyad; ``poisson`` (log
link), ``bernoulli`` (logit link) and the negative binomial (log link,
dispersion k) have conditionally independent directions.

``softplus`` is ``torch.logaddexp(x, 0)``, the JAX package's arithmetic
(``torch.nn.functional.softplus`` turns into the identity past its
threshold).  The negative binomial's log-pmf here is the exact one; the
JAX package's is low by k log k per entry (ROADMAP C.4), so the two agree
up to that constant.
"""

from __future__ import annotations

import math
from typing import Union

import torch

from tame_torch.models.params import AMEParams
from tame_torch.ops import dyad as dyad_ops

_LOG2PI = 1.8378770664093453


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` without a threshold (JAX's ``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class GaussianDyadic:
    """Bivariate Gaussian dyads with exchangeable covariance R — the CAVI
    engines' observation model."""

    name = "gaussian"

    def log_prob(self, params: AMEParams, Y: torch.Tensor, mu: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        resid = Y - mu
        p, q = params.R_inv[0, 0], params.R_inv[0, 1]
        e0, e1 = resid[..., 0], resid[..., 1]
        quad = p * (e0 * e0 + e1 * e1) + 2.0 * q * (e0 * e1)
        n_dyads = 0.5 * torch.sum(mask)
        logdet_R = torch.linalg.slogdet(params.R)[1]
        return -0.5 * (0.5 * torch.sum(quad * mask)
                       + n_dyads * (logdet_R + 2.0 * _LOG2PI))

    def sample(self, generator: torch.Generator, params: AMEParams,
               mu: torch.Tensor) -> torch.Tensor:
        """One correlated draw per ordered slot, mirrored (reciprocity)."""
        LR = torch.linalg.cholesky(params.R.to(mu.device))
        noise = torch.randn(mu.shape, generator=generator,
                            device=mu.device) @ LR.T
        return dyad_ops.symmetrize_dyads(mu + noise)


class _IndependentDirections:
    """Base for families whose two dyad directions are conditionally
    independent given the latent states: the unordered-pair sum is half the
    off-diagonal sum of per-entry component-0 terms (reciprocity: component
    1 of (i, j) is component 0 of (j, i))."""

    def _entry_log_prob(self, y: torch.Tensor,
                        mu: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _entry_sample(self, generator: torch.Generator,
                      mu: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, params: AMEParams, Y: torch.Tensor, mu: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        # Gate the INPUTS (never multiply a possibly non-finite term by the
        # mask): a diagonal predictor can overflow exp() to inf, and
        # inf * 0 = NaN would poison the sum and its gradient.
        zero = torch.zeros((), dtype=Y.dtype, device=Y.device)
        y = torch.where(mask > 0, Y[..., 0], zero)
        m = torch.where(mask > 0, mu[..., 0], zero)
        return torch.sum(self._entry_log_prob(y, m) * mask)

    def sample(self, generator: torch.Generator, params: AMEParams,
               mu: torch.Tensor) -> torch.Tensor:
        """Per-entry draws of component 0, mirrored into component 1; the
        diagonal's predictor is zeroed before the draw (its draw is
        discarded, and an overflowing rate must not reach the sampler)."""
        n = mu.shape[0]
        off = dyad_ops.offdiag_mask(n, mu.dtype, mu.device)[:, :, None]
        m0 = torch.where(off > 0, mu[..., 0], torch.zeros((), dtype=mu.dtype,
                                                          device=mu.device))
        Yf = self._entry_sample(generator, m0).to(mu.dtype) * off
        return torch.stack([Yf, Yf.transpose(0, 1)], dim=-1)


class PoissonDyadic(_IndependentDirections):
    """Count dyads: ``y_ij ~ Poisson(exp(mu_ij))`` (log link)."""

    name = "poisson"

    def _entry_log_prob(self, y, mu):
        return y * mu - torch.exp(mu) - torch.lgamma(y + 1.0)

    def _entry_sample(self, generator, mu):
        return torch.poisson(torch.exp(mu), generator=generator)

    def vi_surrogate(self, y0, offd, m, var):
        """Exact-ELBO CVI surrogate (:mod:`tame_torch.inference.poisson_cavi`):
        ``E_q[exp(m)] = exp(m + v/2)`` is closed form, so the objective is
        the true ELBO and ``w = E_q[exp(m)]`` the exact curvature."""
        w = torch.exp(torch.clamp(m + 0.5 * var, -20.0, 20.0)) * offd
        loglik = torch.sum(offd * (y0 * m - torch.lgamma(y0 + 1.0)) - w)
        s = (y0 - w + w * m) * offd
        return loglik, w, s


class BernoulliDyadic(_IndependentDirections):
    """Binary ties: ``y_ij ~ Bernoulli(sigmoid(mu_ij))`` (logit link)."""

    name = "bernoulli"

    def _entry_log_prob(self, y, mu):
        return y * mu - softplus(mu)

    def _entry_sample(self, generator, mu):
        return torch.bernoulli(torch.sigmoid(mu), generator=generator)

    def vi_surrogate(self, y0, offd, m, var):
        """Jaakkola-Jordan bound surrogate
        (:mod:`tame_torch.inference.binary_cavi`): a per-dyad quadratic
        lower bound, xi-optimal in closed form (``xi^2 = E_q[m^2]``)."""
        Em2 = m * m + var
        xi = torch.sqrt(torch.clamp(Em2, min=1e-12))
        safe = torch.clamp(xi.abs(), min=1e-6)
        lam = torch.tanh(safe / 2.0) / (4.0 * safe) * offd
        resid = (y0 - 0.5) * offd
        loglik = torch.sum(offd * (resid * m - lam * Em2 + xi / 2.0
                                   - softplus(xi) + lam * xi * xi))
        return loglik, 2.0 * lam, resid


class NegativeBinomialDyadic(_IndependentDirections):
    """Overdispersed count dyads: ``y_ij ~ NegBin(mean exp(mu_ij),
    dispersion k)`` (log link; variance ``mean + mean^2 / k``).  Needs the
    dispersion at construction — pass the INSTANCE as ``family=``.

    With ``z = mu - log k`` the log-pmf is a scaled logistic,

        log p = y mu - y log k - (y + k) softplus(z)
                + lgamma(y + k) - lgamma(k) - lgamma(y + 1),

    so the Jaakkola-Jordan bound ``-softplus(z) >= -z/2 - lam(xi) z^2 +
    kappa(xi)`` with per-dyad weight ``(y + k)`` gives the quadratic
    surrogate ``w = 2 (y + k) lam(xi)``, ``s = y - (y + k)/2 + w log k``,
    xi optimal at ``xi^2 = E_q[z^2]``.
    """

    def __init__(self, dispersion: float):
        self.dispersion = float(dispersion)
        if self.dispersion <= 0:
            raise ValueError("dispersion must be > 0")

    @property
    def name(self):
        return f"negbin(k={self.dispersion:g})"

    def _entry_log_prob(self, y, mu):
        k = self.dispersion
        c = math.log(k)
        return (y * mu - y * c - (y + k) * softplus(mu - c)
                + torch.lgamma(y + k) - math.lgamma(k)
                - torch.lgamma(y + 1.0))

    def _entry_sample(self, generator, mu):
        # Poisson-Gamma mixture: rate ~ Gamma(k, scale=exp(mu)/k)
        k = self.dispersion
        shape = torch.full_like(mu, k)
        g = torch._standard_gamma(shape, generator=generator) * torch.exp(mu) / k
        return torch.poisson(g, generator=generator)

    def vi_surrogate(self, y0, offd, m, var):
        k = self.dispersion
        c = math.log(k)
        z = m - c
        Ez2 = z * z + var
        xi = torch.sqrt(torch.clamp(Ez2, min=1e-12))
        safe = torch.clamp(xi.abs(), min=1e-6)
        lam = torch.tanh(safe / 2.0) / (4.0 * safe)
        yk = (y0 + k) * offd
        # the bound at the xi-optimal point (the lam Ez2 and lam xi^2 terms
        # cancel, cf. the Bernoulli engine)
        loglik = torch.sum(
            offd * (y0 * m - y0 * offd * c
                    - yk * (0.5 * z - 0.5 * xi + softplus(xi))
                    + torch.lgamma(y0 + k) - math.lgamma(k)
                    - torch.lgamma(y0 + 1.0)))
        w = 2.0 * yk * lam * offd
        s = (y0 - 0.5 * (y0 + k)) * offd + w * c
        return loglik, w, s

    def warm_transform(self, Y):
        return torch.log(Y + 0.5)

    def __hash__(self):
        return hash(("negbin", self.dispersion))

    def __eq__(self, other):
        return (isinstance(other, NegativeBinomialDyadic)
                and other.dispersion == self.dispersion)


_REGISTRY = {
    "gaussian": GaussianDyadic,
    "poisson": PoissonDyadic,
    "bernoulli": BernoulliDyadic,
}

FamilyLike = Union[str, GaussianDyadic, _IndependentDirections]


def get_family(family: FamilyLike):
    """Resolve a family name or instance.  Custom families are any object
    with the ``log_prob``/``sample`` surface above."""
    if isinstance(family, str):
        try:
            return _REGISTRY[family]()
        except KeyError:
            raise ValueError(
                f"unknown likelihood family {family!r}; built-ins: "
                f"{sorted(_REGISTRY)}") from None
    if hasattr(family, "log_prob"):
        return family
    raise TypeError(f"not a likelihood family: {family!r}")
