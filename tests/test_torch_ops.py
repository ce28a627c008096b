"""Port parity for the ops layer: the K1/K2 twins against the JAX Pallas
kernels (interpret mode) and XLA paths, the dyadic ops, the parameter
bridge and K3's envelope.  The kernels themselves are tested on the card
by ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.models.params import build_params as jax_build_params
from tame.ops import cholesky as jchol
from tame.ops import dyad as jdyad
from tame_torch.config import ModelConfig
from tame_torch.models import build_params, params_from_numpy
from tame_torch.ops import cholesky as tchol
from tame_torch.ops import dyad as tdyad
from tame_torch.ops import fused_fit as tff

torch.set_num_threads(1)

# f32 twins of the same algorithm on well-conditioned systems: agreement is
# a few ulps times the condition number (<= ~10 here).
RTOL = 1e-5
ATOL = 1e-6


def _spd(rng, B, d):
    """Well-conditioned SPD batch: eigenvalues in ~[1, 3]."""
    A = rng.standard_normal((B, d, d)).astype(np.float32)
    return (A @ A.transpose(0, 2, 1) / d + np.eye(d, dtype=np.float32))


class TestSpdTwins:
    @pytest.mark.parametrize("d", [4, 6, 10])
    def test_solve_inv_twin_matches_pallas_and_xla(self, d):
        rng = np.random.default_rng(d)
        B = 37  # ragged: not a multiple of the TPU kernel's 128 lanes
        P, eta = _spd(rng, B, d), rng.standard_normal((B, d)).astype(np.float32)
        mu_k, cov_k = jchol._pallas_spd_solve_inv(
            jnp.asarray(P), jnp.asarray(eta), interpret=True)
        mu_x, cov_x = jchol._xla_spd_solve_inv(jnp.asarray(P),
                                               jnp.asarray(eta))
        mu_t, cov_t = tchol.spd_solve_inv_twin(torch.from_numpy(P),
                                               torch.from_numpy(eta))
        for ref_mu, ref_cov in [(mu_k, cov_k), (mu_x, cov_x)]:
            np.testing.assert_allclose(mu_t.numpy(), np.asarray(ref_mu),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(cov_t.numpy(), np.asarray(ref_cov),
                                       rtol=RTOL, atol=ATOL)
        mu_only = tchol.spd_solve_inv_twin(torch.from_numpy(P),
                                           torch.from_numpy(eta),
                                           with_inverse=False)
        np.testing.assert_allclose(mu_only.numpy(), mu_t.numpy(), rtol=0,
                                   atol=0)

    @pytest.mark.parametrize("d", [4, 6, 10])
    def test_logdet_twin_matches_pallas_and_xla(self, d):
        rng = np.random.default_rng(100 + d)
        P = _spd(rng, 37, d)
        ref_k = np.asarray(jchol._pallas_logdet(jnp.asarray(P),
                                                interpret=True))
        ref_x = np.asarray(jchol.batched_logdet_spd(jnp.asarray(P)))
        got = tchol.logdet_spd_twin(torch.from_numpy(P)).numpy()
        np.testing.assert_allclose(got, ref_k, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, ref_x, rtol=RTOL, atol=ATOL)

    def test_dispatch_keeps_leading_batch_dims_and_launches_nothing(self):
        rng = np.random.default_rng(5)
        P = torch.from_numpy(_spd(rng, 12, 4).reshape(3, 4, 4, 4))
        eta = torch.from_numpy(rng.standard_normal((3, 4, 4)).astype(
            np.float32))
        before = (tchol.spd_solve_inv_kernel.launches,
                  tchol.logdet_spd_kernel.launches)
        mu, cov = tchol.batched_spd_solve_inv(P, eta)
        mu2 = tchol.batched_spd_solve(P, eta)
        ld = tchol.batched_logdet_spd(P)
        assert mu.shape == (3, 4, 4) and cov.shape == (3, 4, 4, 4)
        assert ld.shape == (3, 4)
        np.testing.assert_allclose(mu.numpy(), mu2.numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(
            (P @ cov).numpy(), np.broadcast_to(np.eye(4), (3, 4, 4, 4)),
            atol=1e-5)  # f32 inverse of eigenvalues in [1, 3]
        assert (tchol.spd_solve_inv_kernel.launches,
                tchol.logdet_spd_kernel.launches) == before

    def test_non_spd_system_gives_nan_not_an_error(self):
        P = torch.eye(4).repeat(2, 1, 1)
        P[1, 0, 0] = -1.0
        mu, cov = tchol.spd_solve_inv_twin(P, torch.ones(2, 4))
        assert torch.isfinite(mu[0]).all() and torch.isnan(mu[1]).all()
        assert torch.isnan(cov[1]).all()
        assert torch.isnan(tchol.logdet_spd_twin(P)[1])

    def test_kernel_wrapper_rejects_uninstantiated_d(self):
        P = torch.eye(5).repeat(3, 1, 1)
        with pytest.raises(ValueError, match="built for d in"):
            tchol.spd_solve_inv_kernel(P, torch.ones(3, 5))
        with pytest.raises(ValueError, match="built for d in"):
            tchol.logdet_spd_kernel(P)


class TestDyadOps:
    def _X(self, n=7, T=4, r=2, seed=0):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((n, T, 2 + 2 * r)).astype(np.float32)

    def test_mean_and_fwd_match_jax(self):
        X = self._X()
        for fn in ("dyadic_mean_temporal", "dyadic_fwd_temporal"):
            ref = np.asarray(getattr(jdyad, fn)(jnp.asarray(X), 2))
            got = getattr(tdyad, fn)(torch.from_numpy(X), 2).numpy()
            # one r-term dot product per entry: f32 rounding only
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    def test_static_mean_matches_jax(self):
        rng = np.random.default_rng(1)
        A = rng.standard_normal((5, 2)).astype(np.float32)
        M = rng.standard_normal((5, 4)).astype(np.float32)
        ref = np.asarray(jdyad.dyadic_mean_static(jnp.asarray(A),
                                                  jnp.asarray(M), 2))
        got = tdyad.dyadic_mean_static(torch.from_numpy(A),
                                       torch.from_numpy(M), 2).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    def test_split_state_and_offdiag_mask(self):
        X = self._X()
        for a, b in zip(jdyad.split_state(jnp.asarray(X), 2),
                        tdyad.split_state(torch.from_numpy(X), 2)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(tdyad.offdiag_mask(5).numpy(),
                                      np.asarray(jdyad.offdiag_mask(5)))

    def test_residual_stats_match_jax(self):
        rng = np.random.default_rng(3)
        n, T = 7, 4
        Y = rng.standard_normal((n, n, T, 2)).astype(np.float32)
        fwd = rng.standard_normal((n, n, T)).astype(np.float32)
        ref = jdyad.residual_stats_from_fwd(jnp.asarray(Y), jnp.asarray(fwd))
        got = tdyad.residual_stats_from_fwd(torch.from_numpy(Y),
                                            torch.from_numpy(fwd))
        for g, r in zip(got, ref):
            # sums of ~200 f32 terms in a different order
            np.testing.assert_allclose(float(g), float(r), rtol=1e-5)

    def test_symmetrize_dyads_matches_jax(self):
        rng = np.random.default_rng(4)
        D = rng.standard_normal((6, 6, 3, 2)).astype(np.float32)
        got = tdyad.symmetrize_dyads(torch.from_numpy(D)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jdyad.symmetrize_dyads(jnp.asarray(D))))
        np.testing.assert_array_equal(got[..., 1],
                                      got[..., 0].transpose(1, 0, 2))


class TestParams:
    def test_build_params_matches_jax(self):
        import tame.config

        kw = dict(n_nodes=5, n_time=3, latent_dim=2, rho_dyadic=0.4)
        ref = jax_build_params(tame.config.ModelConfig(**kw))
        got = build_params(ModelConfig(**kw))
        for name in ref._fields:
            # same closed forms; only the 2x2 inverse of R may round apart
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-6, atol=1e-6)

    def test_params_from_numpy_takes_objects_and_dicts(self):
        import tame.config

        ref = jax_build_params(tame.config.ModelConfig(n_nodes=4))
        a = params_from_numpy(ref)
        b = params_from_numpy({k: np.asarray(v) for k, v in
                               ref._asdict().items()}, dtype=torch.float64)
        assert a.d == 6 and a.r == 2 and b.Phi.dtype == torch.float64
        np.testing.assert_array_equal(a.Q.numpy(), np.asarray(ref.Q))


class TestFusedEnvelope:
    KW = dict(structure="full", update_mode="block", diag_mode="exact",
              elbo_every=1)

    def test_demo_config_and_documented_sizes(self):
        # demo config: 25 KB of state
        assert tff.fused_fit_supported(15, 10, 6, num_blocks=15, **self.KW)
        # n=100, T=10: 168 KB of state + one block's scratch fits 227 KB ...
        assert tff.fused_fit_supported(100, 10, 6, num_blocks=10, **self.KW)
        # ... but not as one Jacobi block, whose scratch doubles it
        kw = dict(self.KW, update_mode="jacobi")
        assert not tff.fused_fit_supported(100, 10, 6, **kw)
        # the north-star size is far outside
        assert not tff.fused_fit_supported(2000, 50, 10, num_blocks=16,
                                           **self.KW)

    def test_unsupported_configurations(self):
        assert not tff.fused_fit_supported(15, 10, 14, num_blocks=15,
                                           **self.KW)  # no d=14 build
        assert not tff.fused_fit_supported(
            15, 10, 6, num_blocks=15, **dict(self.KW, diag_mode="stats"))
        assert not tff.fused_fit_supported(
            15, 10, 6, num_blocks=15, **dict(self.KW, elbo_every=2))
        assert not tff.fused_fit_supported(15, 10, 6, num_blocks=4,
                                           **self.KW)  # 4 does not divide 15
