"""Reference-compatible VI engine classes on top of the batched CAVI core
(counterpart of :mod:`tame.inference.engine`).

Same constructor keywords, ``fit(max_iter, tolerance, verbose,
check_every, checkpoint_every, ckpt_dir, resume)`` returning a
``{'elbo': [...], 'reconstruction_error': [...]}`` history,
``X_mean``/``X_cov`` attributes, ``get_*`` accessors, checkpoints and the
forecasts.  The engine is an ``nn.Module`` whose buffers are the
variational state, kept on the device of the model's ``Y``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from tame_torch.config import STRUCTURE_TO_FACTORIZATION, InferenceConfig
from tame_torch.inference import cavi
from tame_torch.models.params import AMEParams
from tame_torch.ops import dyad as dyad_ops


def forecast_means(mu: torch.Tensor, Phi: torch.Tensor,
                   n_steps: int) -> torch.Tensor:
    """AR(1) forward forecast ``mu_{T+h} = Phi mu_{T+h-1}`` of the last
    fitted means (n, d): (n, n_steps, d)."""
    preds = []
    for _ in range(n_steps):
        mu = mu @ Phi.T
        preds.append(mu)
    return torch.stack(preds, 1)


def forecast_states(mu: torch.Tensor, cov: torch.Tensor, params: AMEParams,
                    n_steps: int):
    """Propagate the last fitted states ``N(mu (n, d), cov (n, d, d))``
    through the AR(1) dynamics:

        mu_{T+h} = Phi mu_{T+h-1},  Sigma_{T+h} = Phi Sigma_{T+h-1} Phi' + Q

    Returns ``(means (n, n_steps, d), covs (n, n_steps, d, d))``."""
    Phi, Q = params.Phi, params.Q
    covs = []
    for _ in range(n_steps):
        cov = Phi @ cov @ Phi.T + Q
        covs.append(cov)
    return forecast_means(mu, Phi, n_steps), torch.stack(covs, 1)


def forecast_dyads(mus: torch.Tensor, covs: torch.Tensor, R: torch.Tensor):
    """Dyadic forecast ``(mean, std)``, each (n, n, H, 2), from forecast
    states (:func:`forecast_states`): the delta-method variance of
    ``y_ij = a_i + b_j + U_i . V_j + eps`` with nodes independent,

        var(y_ij) = J_i Sigma_i J_i' + J_j Sigma_j J_j' + R[0, 0],
        J_i = [1, 0, V_j, 0],  J_j = [0, 1, 0, U_i]

    at the forecast means.  Every term of ``var(y_ij)`` is an inner
    product of a sender feature of i and a receiver feature of j (the
    quadratic forms through the flattened outer products ``V_j V_j'`` and
    ``U_i U_i'``), so the whole (n, n) variance per step is one batched
    product of (H, n, K) panels: no (n, n, H, r, r) intermediate."""
    n, H, d = mus.shape
    r = (d - 2) // 2
    mean = dyad_ops.dyadic_mean_temporal(mus, r)            # (n, n, H, 2)
    _, _, U, V = dyad_ops.split_state(mus, r)               # (n, H, r)
    one = torch.ones_like(U[..., :1])
    flat = (n, H, r * r)
    # sender i:   A_i, 1, 2 B_i, C_i,  2 U_i, U_i U_i'
    # receiver j: 1, Ar_j, V_j, V_j V_j', Br_j, Cr_j
    F = torch.cat([covs[..., 0, 0, None], one,
                   2.0 * covs[..., 0, 2:2 + r],
                   covs[..., 2:2 + r, 2:2 + r].reshape(flat),
                   2.0 * U, (U[..., :, None] * U[..., None, :]).reshape(flat)],
                  -1)
    G = torch.cat([one, covs[..., 1, 1, None], V,
                   (V[..., :, None] * V[..., None, :]).reshape(flat),
                   covs[..., 1, 2 + r:],
                   covs[..., 2 + r:, 2 + r:].reshape(flat)], -1)
    var0 = torch.bmm(F.transpose(0, 1), G.permute(1, 2, 0)).permute(
        1, 2, 0) + R[0, 0]                                  # (n, n, H)
    # Component 1 of dyad (i, j) is y_ji: var0 with the roles swapped.
    std = torch.sqrt(torch.clamp(
        torch.stack([var0, var0.transpose(0, 1)], -1), min=1e-12))
    return mean, std


class TemporalAMECaviVI(torch.nn.Module):
    """Generic damped-CAVI variational engine.

    ``structure`` is ``"diag"``, ``"full"`` or ``"block"`` (naive /
    good-SMF / bad-SMF); ``update_mode`` ``"block"`` (block Gauss-Seidel,
    default) or ``"jacobi"``; ``init_mode`` ``"random"`` or ``"warm"``
    (:func:`~tame_torch.inference.cavi.warm_init_state`, its subspace probe
    drawn from a generator seeded ``seed``).  ``mask`` ((n, n, T) dyad
    observation mask, see :func:`~tame_torch.inference.cavi.fit_cavi`),
    ``mixed_precision`` and ``diag_mode="stats"`` go to every fit; the
    warm init then averages over observed dyads.  ``update_mode="seq"``
    runs the reference's node-by-node sweep
    (:func:`~tame_torch.inference.cavi.cavi_step_seq`), for small n.
    """

    structure = "full"

    def __init__(self, model, structure: Optional[str] = None,
                 learning_rate: float = 1.0, init_scale: float = 0.1,
                 cov_init_scale: float = 0.5, seed: int = 42,
                 update_mode: str = "block", num_blocks=None,
                 corrected: bool = False, mixed_precision: bool = False,
                 diag_mode: str = "exact", init_mode: str = "random",
                 elbo_every: int = 1, mask=None):
        super().__init__()
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        if structure is not None:
            self.structure = structure
        self.model = model
        self.Y = torch.as_tensor(model.Y)
        self.n, self.T, self.d, self.r = model.n, model.T, model.d, model.r
        self.lr = learning_rate
        self.init_scale = init_scale
        self.cov_init_scale = cov_init_scale
        self.seed = seed
        self.update_mode = update_mode
        self.num_blocks = num_blocks
        self.corrected = corrected
        self.mixed_precision = mixed_precision
        self.diag_mode = diag_mode
        self.elbo_every = elbo_every
        self.mask = (None if mask is None else torch.as_tensor(
            mask, dtype=self.Y.dtype, device=self.Y.device))
        self.params = model.params.to(self.Y.device, self.Y.dtype)
        self.history: Dict[str, List[float]] = {
            "elbo": [], "reconstruction_error": []}
        self._converged = self._diverged = False
        # Convergence carry (last evaluated ELBO + consecutive small-change
        # count) for segmented and resumed fits.
        self._carry_elbo: Optional[float] = None
        self._carry_pat = 0

        if init_mode == "warm":
            state = cavi.warm_init_state(
                self.Y, self.params, structure=self.structure,
                cov_init_scale=cov_init_scale,
                generator=torch.Generator().manual_seed(seed),
                obs_mask=self.mask)
        elif init_mode == "random":
            state = cavi.init_state(
                torch.Generator().manual_seed(seed), self.n, self.T, self.d,
                self.structure, init_scale, cov_init_scale,
                device=self.Y.device)
        else:
            raise ValueError(f"unknown init_mode '{init_mode}'")
        self.register_buffer("X_mean", state.X_mean)
        self.register_buffer("X_cov", state.X_cov)

    @classmethod
    def from_config(cls, model, config: InferenceConfig):
        """Build an engine from a typed :class:`InferenceConfig`."""
        kwargs = dict(
            learning_rate=config.learning_rate,
            init_scale=config.init_scale,
            seed=config.seed,
            update_mode=config.update_mode,
            mixed_precision=config.mixed_precision,
            diag_mode=config.diag_mode,
        )
        if cls is TemporalAMECaviVI:
            kwargs["structure"] = config.structure
            kwargs["cov_init_scale"] = config.cov_init_scale
        elif cls is TemporalAMEStructuredMFVI:
            kwargs["factorization"] = STRUCTURE_TO_FACTORIZATION.get(
                config.structure, "good")
            kwargs["cov_init_scale"] = config.cov_init_scale
        return cls(model, **kwargs)

    def fit(self, max_iter: int = 100, tolerance: float = 1e-4,
            verbose: bool = True, check_every: int = 10,
            checkpoint_every: Optional[int] = None, ckpt_dir=None,
            resume: bool = False) -> Dict[str, List[float]]:
        """Run CAVI to convergence from the current state; the history
        grows by the iterations run.

        ``checkpoint_every=k`` runs the fit in k-iteration segments (on the
        card at a K3 shape, one K3 launch each), each followed by a
        checkpoint to ``ckpt_dir`` (if given, written by
        :class:`~tame_torch.io.AsyncCheckpointer` while the next segment
        runs) and a progress line.  The convergence carry (last ELBO,
        patience count, converged/diverged) threads through the segments,
        so a segmented fit stops at exactly the iteration of one
        uninterrupted call and gives the same bits.  ``resume=True``
        restores ``ckpt_dir`` first (if it exists) and reads ``max_iter``
        as the total budget including the iterations already done: a
        killed run rerun with the same arguments reproduces the
        uninterrupted fit bit for bit.
        """
        if verbose:
            print(f"Starting {self.__class__.__name__} optimization...")
            print("=" * 60)
        if resume:
            if ckpt_dir is None:
                raise ValueError("resume=True requires ckpt_dir")
            if os.path.exists(os.fspath(ckpt_dir)):
                self.load_checkpoint(ckpt_dir)

        done = len(self.history["elbo"])
        budget = max_iter - done if resume else max_iter
        if budget <= 0:
            return self.history
        segment = checkpoint_every or budget
        # A fresh fit starts clean; a resumed one keeps the restored carry
        # and flags, so a checkpoint taken after the stopping rule fired
        # does not re-enter the loop.
        if not (resume and done > 0):
            self._carry_elbo, self._carry_pat = None, 0
            self._converged = self._diverged = False
        ckptr = None
        if checkpoint_every and ckpt_dir is not None:
            from tame_torch.io.async_ckpt import AsyncCheckpointer

            ckptr = AsyncCheckpointer()
        while budget > 0 and not (self._converged or self._diverged):
            result = cavi.fit_cavi(
                self.Y, self.params,
                cavi.CaviState(X_mean=self.X_mean, X_cov=self.X_cov),
                structure=self.structure, update_mode=self.update_mode,
                max_iter=min(segment, budget), learning_rate=self.lr,
                tolerance=tolerance, num_blocks=self.num_blocks,
                corrected=self.corrected,
                mixed_precision=self.mixed_precision,
                diag_mode=self.diag_mode, elbo_every=self.elbo_every,
                mask=self.mask, carry_elbo=self._carry_elbo,
                carry_patience=self._carry_pat)
            self.X_mean = result.X_mean
            self.X_cov = result.X_cov
            n_iter = result.n_iter
            eh = result.elbo_history[:n_iter].tolist()
            mh = result.mse_history[:n_iter].tolist()
            self.history["elbo"].extend(eh)
            self.history["reconstruction_error"].extend(mh)
            self._converged, self._diverged = result.converged, result.diverged
            self._carry_elbo = result.last_elbo
            self._carry_pat = result.pat_count
            budget -= n_iter
            if checkpoint_every:
                if ckptr is not None:
                    ckptr.save(ckpt_dir, self._checkpoint_state())
                if verbose:
                    print(f"Iter {len(self.history['elbo']) - 1:4d} | "
                          f"ELBO: {eh[-1]:10.2f} | MSE: {mh[-1]:.6f}"
                          + (" | checkpointed" if ckpt_dir else ""),
                          flush=True)
        if ckptr is not None:
            ckptr.wait()  # the last checkpoint is on disk before returning

        n_total = len(self.history["elbo"])
        if self._diverged:
            print(f"WARNING: {self.__class__.__name__} halted at iteration "
                  f"{n_total - 1}: ELBO became non-finite (try a smaller "
                  "learning_rate or update_mode='block').")
        if verbose:
            eh = self.history["elbo"]
            mh = self.history["reconstruction_error"]
            if not checkpoint_every:
                for it in range(done, n_total):
                    if (it - done) % check_every == 0 or it == n_total - 1:
                        print(f"Iter {it:4d} | ELBO: {eh[it]:10.2f} | "
                              f"MSE: {mh[it]:.6f}")
            if self._converged:
                print(f"\nConverged at iteration {n_total - 1}")
            else:
                print("\nReached maximum iterations without convergence")
        return self.history

    def get_variational_means(self) -> torch.Tensor:
        return self.X_mean

    def get_variational_covariances(self) -> torch.Tensor:
        return self.X_cov

    def get_elbo_history(self) -> List[float]:
        return self.history["elbo"]

    def get_reconstruction_history(self) -> List[float]:
        return self.history["reconstruction_error"]

    def _checkpoint_state(self) -> dict:
        """The fit state in the JAX engine's checkpoint layout."""
        return {
            "X_mean": self.X_mean,
            "X_cov": self.X_cov,
            "history": {
                "elbo": np.asarray(self.history["elbo"]),
                "reconstruction_error": np.asarray(
                    self.history["reconstruction_error"]),
            },
            "structure": self.structure,
            "learning_rate": self.lr,
            "seed": self.seed,
            "carry_elbo": self._carry_elbo,
            "carry_pat": self._carry_pat,
            "converged": bool(self._converged),
            "diverged": bool(self._diverged),
        }

    def save_checkpoint(self, ckpt_dir) -> None:
        """Checkpoint the whole fit state (variational parameters, history,
        convergence carry) for a restart."""
        from tame_torch.io import save_checkpoint

        save_checkpoint(ckpt_dir, self._checkpoint_state())

    def load_checkpoint(self, ckpt_dir) -> None:
        """Restore a checkpoint written by :meth:`save_checkpoint` or by
        the JAX engine; a later ``fit`` continues from it (the history
        appends).  The state moves to the device of ``Y``."""
        from tame_torch.io import load_checkpoint

        state = load_checkpoint(ckpt_dir)
        if state.get("structure", self.structure) != self.structure:
            raise ValueError(
                f"checkpoint structure '{state.get('structure')}' does not "
                f"match engine structure '{self.structure}'")
        self.X_mean = torch.as_tensor(state["X_mean"], device=self.Y.device)
        self.X_cov = torch.as_tensor(state["X_cov"], device=self.Y.device)
        self.history = {
            "elbo": np.asarray(state["history"]["elbo"]).tolist(),
            "reconstruction_error": np.asarray(
                state["history"]["reconstruction_error"]).tolist(),
        }
        self._carry_elbo = state.get("carry_elbo")
        self._carry_pat = int(state.get("carry_pat", 0))
        self._converged = bool(state.get("converged", False))
        self._diverged = bool(state.get("diverged", False))

    def predict_forward(self, n_steps: int = 1) -> torch.Tensor:
        """AR(1) forward forecast of the means from the last fitted
        states (:func:`forecast_means`): (n, n_steps, d)."""
        return forecast_means(self.X_mean[:, -1], self.params.Phi, n_steps)

    def predict_forward_with_cov(self, n_steps: int = 1):
        """State forecast with uncertainty (:func:`forecast_states`):
        ``(means (n, n_steps, d), covs (n, n_steps, d, d))``."""
        return forecast_states(self.X_mean[:, -1], self.X_cov[:, -1],
                               self.params, n_steps)

    def predict_dyads(self, n_steps: int = 1):
        """Dyadic forecast ``(mean, std)`` of shape (n, n, n_steps, 2) with
        delta-method predictive standard deviations
        (:func:`forecast_dyads`), for
        :func:`tame_torch.utils.calibration_error` and
        :func:`~tame_torch.utils.compute_coverage`."""
        mus, covs = self.predict_forward_with_cov(n_steps)
        return forecast_dyads(mus, covs, self.params.R)


# The reference's base-class names: the generic CAVI engine plays both
# roles (every engine is temporal, and the trainer loop lives here).
BaseVariationalInference = TemporalAMECaviVI
BaseTemporalVariationalInference = TemporalAMECaviVI


class TemporalAMENaiveMFVI(TemporalAMECaviVI):
    """Naive (fully factorized, diagonal-covariance) mean-field VI."""

    structure = "diag"

    def __init__(self, model, learning_rate: float = 1.0,
                 init_scale: float = 0.1, seed: int = 42,
                 update_mode: str = "block", corrected: bool = False,
                 mixed_precision: bool = False, diag_mode: str = "exact",
                 init_mode: str = "random", elbo_every: int = 1,
                 mask=None):
        super().__init__(model, structure="diag",
                         learning_rate=learning_rate, init_scale=init_scale,
                         seed=seed, update_mode=update_mode,
                         corrected=corrected, mixed_precision=mixed_precision,
                         diag_mode=diag_mode, init_mode=init_mode,
                         elbo_every=elbo_every, mask=mask)


class TemporalAMEStructuredMFVI(TemporalAMECaviVI):
    """Structured mean-field VI: ``factorization="good"`` keeps the full
    d x d covariance, ``"bad"`` zeroes the additive x multiplicative cross
    blocks post-inversion (the deliberately wrong control)."""

    def __init__(self, model, factorization: str = "good",
                 learning_rate: float = 1.0, init_scale: float = 0.1,
                 cov_init_scale: float = 0.5, seed: int = 42,
                 update_mode: str = "block", corrected: bool = False,
                 mixed_precision: bool = False, diag_mode: str = "exact",
                 init_mode: str = "random", elbo_every: int = 1,
                 mask=None):
        if factorization not in ("good", "bad"):
            raise ValueError(f"Unknown factorization '{factorization}'")
        structure = "full" if factorization == "good" else "block"
        super().__init__(model, structure=structure,
                         learning_rate=learning_rate, init_scale=init_scale,
                         cov_init_scale=cov_init_scale, seed=seed,
                         update_mode=update_mode, corrected=corrected,
                         mixed_precision=mixed_precision,
                         diag_mode=diag_mode, init_mode=init_mode,
                         elbo_every=elbo_every, mask=mask)
        self.factorization = factorization

    def get_factorization_type(self) -> str:
        return self.factorization
