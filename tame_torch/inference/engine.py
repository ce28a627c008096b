"""Reference-compatible VI engine classes on top of the batched CAVI core
(counterpart of :mod:`tame.inference.engine`).

Same constructor keywords, ``fit(max_iter, tolerance, verbose,
check_every, checkpoint_every, ckpt_dir, resume)`` returning a
``{'elbo': [...], 'reconstruction_error': [...]}`` history,
``X_mean``/``X_cov`` attributes and ``get_*`` accessors.  The engine is an
``nn.Module`` whose buffers are the variational state, kept on the device
of the model's ``Y``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from tame_torch.config import STRUCTURE_TO_FACTORIZATION, InferenceConfig
from tame_torch.inference import cavi


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
    keeps the JAX engine's keyword but is not ported yet and raises.
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
        if update_mode == "seq":
            raise NotImplementedError("update_mode='seq' is not ported yet")
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
        grows by the iterations run.  ``checkpoint_every``, ``ckpt_dir``
        and ``resume`` keep the JAX engine's keywords and defaults, but
        checkpointed fits are not ported yet and raise."""
        if checkpoint_every or ckpt_dir is not None or resume:
            raise NotImplementedError(
                "checkpointed CAVI fits are not ported yet")
        if verbose:
            print(f"Starting {self.__class__.__name__} optimization...")
            print("=" * 60)
        start = len(self.history["elbo"])
        result = cavi.fit_cavi(
            self.Y, self.params,
            cavi.CaviState(X_mean=self.X_mean, X_cov=self.X_cov),
            structure=self.structure, update_mode=self.update_mode,
            max_iter=max_iter, learning_rate=self.lr, tolerance=tolerance,
            num_blocks=self.num_blocks, corrected=self.corrected,
            mixed_precision=self.mixed_precision, diag_mode=self.diag_mode,
            elbo_every=self.elbo_every, mask=self.mask)
        self.X_mean = result.X_mean
        self.X_cov = result.X_cov
        n_iter = result.n_iter
        self.history["elbo"].extend(result.elbo_history[:n_iter].tolist())
        self.history["reconstruction_error"].extend(
            result.mse_history[:n_iter].tolist())
        self._converged, self._diverged = result.converged, result.diverged

        n_total = len(self.history["elbo"])
        if self._diverged:
            print(f"WARNING: {self.__class__.__name__} halted at iteration "
                  f"{n_total - 1}: ELBO became non-finite (try a smaller "
                  "learning_rate or update_mode='block').")
        if verbose:
            eh = self.history["elbo"]
            mh = self.history["reconstruction_error"]
            for it in range(start, n_total):
                if (it - start) % check_every == 0 or it == n_total - 1:
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
