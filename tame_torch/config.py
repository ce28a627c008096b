"""Typed configuration objects for the temporal AME port.

The same plain dataclasses as :mod:`tame.config`, field for field, so a
configuration moves between the JAX package and the port unchanged.
Randomness flows through explicit ``torch.Generator`` objects seeded from
``seed``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration of the temporal AME generative model.

        Y_ij^t = [y_ij^t, y_ji^t]' ~ N(mu_ij^t, R)
        mu_ij^t = [a_i^t + b_j^t + U_i^t . V_j^t,  a_j^t + b_i^t + U_j^t . V_i^t]'
        X_i^t  = [a_i^t, b_i^t, U_i^t, V_i^t]  in R^d,  d = 2 + 2 r
        X_i^0  ~ N(0, blockdiag(Sigma, Psi))
        X_i^t  = Phi X_i^{t-1} + eps,   eps ~ N(0, Q)

    with Phi = ar_coefficient * I_d and
    Q = (1 - ar_coefficient^2) * blockdiag(Sigma, Psi) * process_noise_scale.
    """

    n_nodes: int
    n_time: int = 1
    latent_dim: int = 2
    ar_coefficient: float = 0.8
    rho_additive: float = 0.5
    rho_multiplicative: float = 0.3
    rho_dyadic: float = 0.5
    process_noise_scale: float = 0.1
    dyadic_variance: float = 0.1
    seed: int = 42

    @property
    def d(self) -> int:
        """State dimension d = 2 + 2 r."""
        return 2 + 2 * self.latent_dim

    @property
    def r(self) -> int:
        return self.latent_dim


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Configuration of a CAVI fit.

    ``learning_rate`` damps the coordinate update:
    new = lr * closed_form + (1 - lr) * old.  ``update_mode`` is
    ``"jacobi"`` (all factors at once) or ``"block"`` (block Gauss-Seidel,
    the default); ``"seq"`` and ``diag_mode="stats"`` are accepted here for
    parity with :mod:`tame.config` but the port's fit does not run them yet.
    """

    structure: str = "full"  # "diag" | "full" | "block" (naive / good / bad)
    learning_rate: float = 1.0
    init_scale: float = 0.1
    cov_init_scale: float = 0.5
    max_iter: int = 100
    tolerance: float = 1e-4
    patience: int = 3
    update_mode: str = "block"
    mixed_precision: bool = False
    diag_mode: str = "exact"  # "exact" | "stats"
    seed: int = 42

    def __post_init__(self):
        if self.structure not in ("diag", "full", "block"):
            raise ValueError(
                f"Unknown structure '{self.structure}' "
                "(expected 'diag', 'full' or 'block')"
            )
        if self.update_mode not in ("jacobi", "block", "seq"):
            raise ValueError(f"Unknown update_mode '{self.update_mode}'")
        if self.diag_mode not in ("exact", "stats"):
            raise ValueError(f"Unknown diag_mode '{self.diag_mode}'")


FACTORIZATION_TO_STRUCTURE = {"good": "full", "bad": "block"}
STRUCTURE_TO_FACTORIZATION = {v: k for k, v in FACTORIZATION_TO_STRUCTURE.items()}
