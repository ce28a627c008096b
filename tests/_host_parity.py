"""What the host-layer parity tests share: patches that make the port draw
exactly the JAX package's data, masks, regenerated observations and
inits from the same seeds, so a CLI run or an experiment of each package
sees the same numbers.

The port's random streams are ``torch.Generator`` objects where ``tame``
splits JAX keys; every patched draw reads the generator's seed
(``initial_seed()``) and makes ``tame``'s draw from ``PRNGKey(seed)``, the
key ``tame`` uses at the same call site.  ``tame`` itself is never
patched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tame.inference.cavi as jcavi
import tame.inference.smoothed as jsmoothed
import tame.models as jmodels
import tame_torch.inference.cavi as tcavi
import tame_torch.inference.smoothed as tsmoothed
import tame_torch.models as tmodels
from tame.models.params import AMEParams as JAXParams
from tame_torch.models.temporal_ame import TemporalAMEModel as PortModel


def to_torch(x, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def jax_params(params) -> JAXParams:
    return JAXParams(*(jnp.asarray(t.detach().cpu().numpy()) for t in params))


def _model_kw(config) -> dict:
    return dict(n_nodes=config.n_nodes, n_time=config.n_time,
                latent_dim=config.latent_dim,
                ar_coefficient=config.ar_coefficient,
                rho_additive=config.rho_additive,
                rho_multiplicative=config.rho_multiplicative,
                rho_dyadic=config.rho_dyadic,
                process_noise_scale=config.process_noise_scale,
                seed=config.seed)


def share_draws(monkeypatch) -> None:
    """Patch the port's data, observation, mask and init draws to
    ``tame``'s from the same seeds."""

    def generate_data(self, return_latents=False, generator=None,
                      device=None):
        Y, X = jmodels.TemporalAMEModel(**_model_kw(self.config)) \
            .generate_data(return_latents=True)
        dev = self.device if device is None else device
        self.Y, self.X = to_torch(Y, dev), to_torch(X, dev)
        return (self.Y, self.X) if return_latents else self.Y

    def sample_observations(params, generator, X, family=None):
        Y = jmodels.sample_observations(
            jax_params(params), jax.random.PRNGKey(generator.initial_seed()),
            jnp.asarray(X.cpu().numpy()), family=family)
        return to_torch(Y, X.device)

    def random_dyad_mask(generator, n, T, missing_frac):
        m = jmodels.random_dyad_mask(
            jax.random.PRNGKey(generator.initial_seed()), n, T,
            missing_frac)
        return to_torch(m, generator.device)

    def init_state(generator, n, T, d, structure, init_scale,
                   cov_init_scale, device=None):
        st = jcavi.init_state(jax.random.PRNGKey(generator.initial_seed()),
                              n, T, d, structure, init_scale, cov_init_scale)
        return tcavi.CaviState(to_torch(st.X_mean, device),
                               to_torch(st.X_cov, device))

    def init_smoothed_state(generator, n, T, d, init_scale=0.1,
                            device=None):
        st = jsmoothed.init_smoothed_state(
            jax.random.PRNGKey(generator.initial_seed()), n, T, d,
            init_scale)
        return tsmoothed.SmoothedState(*(to_torch(v, device) for v in st))

    warm = tcavi.warm_init_state

    def warm_init_state(Y, params, *args, probe=None, generator=None, **kw):
        seed = 0 if generator is None else generator.initial_seed()
        probe = jax.random.normal(jax.random.PRNGKey(seed),
                                  (Y.shape[0], params.r), jnp.float32)
        return warm(Y, params, *args, probe=to_torch(probe, Y.device), **kw)

    monkeypatch.setattr(PortModel, "generate_data", generate_data)
    monkeypatch.setattr(tmodels, "sample_observations", sample_observations)
    monkeypatch.setattr(tmodels, "random_dyad_mask", random_dyad_mask)
    monkeypatch.setattr(tcavi, "init_state", init_state)
    monkeypatch.setattr(tcavi, "warm_init_state", warm_init_state)
    monkeypatch.setattr(tsmoothed, "init_smoothed_state", init_smoothed_state)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)
