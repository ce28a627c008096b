"""Hamiltonian Monte Carlo for the temporal AME posterior (counterpart of
:mod:`tame.inference.hmc`).

Chains are the leading axis of one batched computation: a position is
(chains, ...), the log density maps it to (chains,), and one
``torch.autograd.grad`` of the summed log densities gives every chain's
gradient (:func:`value_and_grad`).  The JAX package ``vmap``s one chain,
so each chain keeps its own dual-averaging state and its own final step
size; here those are (chains,) tensors.  No autograd graph outlives one
gradient evaluation; everything else runs under ``torch.no_grad()``.

Adaptation:

* step size: Nesterov dual averaging toward a target acceptance rate
  (Hoffman & Gelman 2014, Algorithm 5 parameters);
* diagonal mass: identity, or the variational variances of a short CAVI
  fit (:func:`precondition_from_cavi`), which match the posterior scale
  per (node, time, dim) without spending warmup on covariance estimation.

Randomness comes from an explicit ``torch.Generator`` on the positions'
device.  One transition's draws (:class:`HMCDraws`) are made up front and
passed to the function that consumes them, so a test can feed it the JAX
package's own draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class HMCState(NamedTuple):
    position: torch.Tensor      # (chains, ...)
    logdensity: torch.Tensor    # (chains,)
    grad: torch.Tensor          # (chains, ...)


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor       # (chains,)
    log_eps_avg: torch.Tensor
    grad_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


class HMCSamples(NamedTuple):
    positions: torch.Tensor     # (chains, num_samples, ...)
    accept_prob: torch.Tensor   # (chains, num_samples) mean accept prob.
    step_size: torch.Tensor     # (chains,) final adapted step sizes
    logdensities: torch.Tensor  # (chains, num_samples)


class HMCDraws(NamedTuple):
    """One HMC transition's randomness: standard-normal momentum noise
    (chains, ...) and the acceptance uniforms (chains,)."""

    noise: torch.Tensor
    uniform: torch.Tensor


def per_chain(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (chains,) tensor shaped to broadcast against ``like`` (chains,
    ...)."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-chain inner product of two (chains, ...) tensors."""
    return (a * b).flatten(1).sum(1)


def value_and_grad(logdensity_fn: Callable, x: torch.Tensor):
    """``(logdensity_fn(x), its gradient)`` per chain, detached: one
    autograd pass of the summed log densities (a
    :class:`GraphedLogDensity` replays its captured pass instead)."""
    if isinstance(logdensity_fn, GraphedLogDensity):
        return logdensity_fn.value_and_grad(x)
    return _autograd_value_and_grad(logdensity_fn, x)


def _autograd_value_and_grad(logdensity_fn: Callable, x: torch.Tensor):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        logp = logdensity_fn(xg)
        grad, = torch.autograd.grad(logp.sum(), xg)
    return logp.detach(), grad


class GraphedLogDensity:
    """A log density whose :func:`value_and_grad` on the card is one CUDA
    graph per input shape: the autograd pass is captured at its first call
    at that shape (after three eager passes on a side stream) and replayed
    after, so a gradient is one launch where the eager pass issues ~110,
    each paying the host's launch cost.  The replay runs the captured
    kernels on a static copy of the input; its outputs are cloned, since
    the next replay overwrites them.  Called directly, or given a CPU
    tensor, it is the wrapped function, eager.  ``fn`` must not read the
    host or draw random numbers (a captured graph replays neither)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs: dict = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def value_and_grad(self, x: torch.Tensor):
        if not x.is_cuda:
            return _autograd_value_and_grad(self.fn, x)
        key = (tuple(x.shape), x.dtype, x.device)
        if key not in self.graphs:
            self.graphs[key] = self._capture(x)
        graph, x_in, logp, grad = self.graphs[key]
        x_in.copy_(x)
        graph.replay()
        return logp.clone(), grad.clone()

    def _capture(self, x: torch.Tensor):
        x_in = x.detach().clone()
        main = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(3):
                _autograd_value_and_grad(self.fn, x_in)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logp, grad = _autograd_value_and_grad(self.fn, x_in)
        return graph, x_in, logp, grad


def _leapfrog(logdensity_fn: Callable, position: torch.Tensor,
              momentum: torch.Tensor, grad: torch.Tensor,
              step_size: torch.Tensor, inv_mass: torch.Tensor,
              num_steps: int) -> Tuple[torch.Tensor, ...]:
    """Velocity-Verlet integration of Hamiltonian dynamics for every
    chain, each with its own ``step_size`` (chains,); returns (position,
    momentum, logdensity, grad) at the trajectory end."""
    eps = per_chain(step_size, position)
    logp = None
    for _ in range(num_steps):
        momentum = momentum + 0.5 * eps * grad
        position = position + eps * inv_mass * momentum
        logp, grad = value_and_grad(logdensity_fn, position)
        momentum = momentum + 0.5 * eps * grad
    return position, momentum, logp, grad


def _kinetic(momentum: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * _dot(momentum, inv_mass * momentum)


def hmc_draws(generator: torch.Generator, position: torch.Tensor,
              shard=None) -> HMCDraws:
    """The draws of one transition of the chains in ``position``; under a
    ``shard`` (:class:`tame_torch.parallel.mesh.ChainShard`) those of the
    whole batch, sliced to this rank's chains."""
    C = position.shape[0] if shard is None else shard.total
    draws = HMCDraws(
        noise=torch.randn((C,) + position.shape[1:], generator=generator,
                          device=position.device, dtype=position.dtype),
        uniform=torch.rand(C, generator=generator,
                           device=position.device, dtype=position.dtype))
    return draws if shard is None else HMCDraws(
        *(x[shard.lo:shard.hi] for x in draws))


@torch.no_grad()
def hmc_kernel(logdensity_fn: Callable, state: HMCState,
               generator: Optional[torch.Generator],
               step_size: torch.Tensor, inv_mass: torch.Tensor,
               num_leapfrog: int, *, draws: Optional[HMCDraws] = None,
               shard=None) -> Tuple[HMCState, torch.Tensor]:
    """One HMC transition of every chain; returns (new_state,
    accept_probability (chains,)).  ``draws`` (default: drawn from
    ``generator``, as :func:`hmc_draws` under ``shard``) are the
    transition's randomness."""
    if draws is None:
        draws = hmc_draws(generator, state.position, shard)
    # momentum ~ N(0, M) with M = 1 / inv_mass
    momentum = draws.noise / torch.sqrt(inv_mass)
    energy0 = -state.logdensity + _kinetic(momentum, inv_mass)
    pos, mom, logp, grad = _leapfrog(
        logdensity_fn, state.position, momentum, state.grad, step_size,
        inv_mass, num_leapfrog)
    delta = energy0 - (-logp + _kinetic(mom, inv_mass))
    delta = torch.where(torch.isnan(delta), -torch.inf, delta)
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accept = draws.uniform < accept_prob
    a = per_chain(accept, pos)
    return HMCState(position=torch.where(a, pos, state.position),
                    logdensity=torch.where(accept, logp, state.logdensity),
                    grad=torch.where(a, grad, state.grad)), accept_prob


def _da_init(step_size: torch.Tensor) -> DualAveragingState:
    log_eps = torch.log(step_size)
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps.clone(),
                              grad_avg=torch.zeros_like(step_size),
                              mu=torch.log(10.0 * step_size),
                              count=torch.zeros_like(step_size))


def _da_update(da: DualAveragingState, accept_prob: torch.Tensor,
               target: float = 0.8, gamma: float = 0.05, t0: float = 10.0,
               kappa: float = 0.75) -> DualAveragingState:
    count = da.count + 1.0
    w = 1.0 / (count + t0)
    grad_avg = (1.0 - w) * da.grad_avg + w * (target - accept_prob)
    log_eps = da.mu - torch.sqrt(count) / gamma * grad_avg
    eta = count ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * da.log_eps_avg
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps_avg,
                              grad_avg=grad_avg, mu=da.mu, count=count)


def with_args(logdensity_fn: Callable, logdensity_args: tuple) -> Callable:
    """``x -> logdensity_fn(x, *logdensity_args)`` (the samplers'
    ``logdensity_args``: data operands passed beside the positions)."""
    if not logdensity_args:
        return logdensity_fn
    return lambda x: logdensity_fn(x, *logdensity_args)


def initial_step_sizes(init_position: torch.Tensor,
                       initial_step_size: float) -> torch.Tensor:
    return torch.full((init_position.shape[0],), initial_step_size,
                      dtype=init_position.dtype,
                      device=init_position.device)


@torch.no_grad()
def run_hmc(logdensity_fn: Callable, init_position: torch.Tensor,
            generator: torch.Generator, *, num_warmup: int = 200,
            num_samples: int = 200, num_leapfrog: int = 16,
            initial_step_size: float = 0.01,
            inv_mass: Optional[torch.Tensor] = None,
            target_accept: float = 0.8, thin: int = 1,
            logdensity_args: tuple = (), shard=None) -> HMCSamples:
    """Run HMC chains: dual-averaging warmup, then sampling.

    ``init_position`` (chains, ...) holds one start per chain and
    ``logdensity_fn`` maps (chains, ...) to (chains,); every chain adapts
    its own step size.  ``inv_mass`` is a per-coordinate inverse mass
    (posterior variance scale) broadcast against one chain's position;
    identity by default.  ``thin`` transitions are made per kept draw (the
    accept statistic is their mean).  ``logdensity_args``: data operands
    forwarded as ``logdensity_fn(x, *logdensity_args)``.  Draws come from
    ``generator``, on the positions' device.  ``shard``
    (:class:`tame_torch.parallel.mesh.ChainShard`): ``init_position`` holds
    this rank's chains of a larger batch, and each transition draws the
    whole batch's numbers and keeps this rank's."""
    logdensity_fn = with_args(logdensity_fn, logdensity_args)
    if inv_mass is None:
        inv_mass = torch.ones_like(init_position[0])
    logp, grad = value_and_grad(logdensity_fn, init_position)
    state = HMCState(position=init_position, logdensity=logp, grad=grad)

    # -- warmup: adapt the step sizes ------------------------------------
    da = _da_init(initial_step_sizes(init_position, initial_step_size))
    for _ in range(num_warmup):
        state, accept_prob = hmc_kernel(
            logdensity_fn, state, generator, torch.exp(da.log_eps),
            inv_mass, num_leapfrog, shard=shard)
        da = _da_update(da, accept_prob, target=target_accept)
    step_size = torch.exp(da.log_eps_avg)

    # -- sampling ----------------------------------------------------------
    C = init_position.shape[0]
    positions = init_position.new_empty((C, num_samples)
                                        + init_position.shape[1:])
    accept = init_position.new_empty((C, num_samples))
    logps = init_position.new_empty((C, num_samples))
    for s in range(num_samples):
        aps = init_position.new_zeros(C)
        for _ in range(thin):
            state, ap = hmc_kernel(logdensity_fn, state, generator,
                                   step_size, inv_mass, num_leapfrog,
                                   shard=shard)
            aps = aps + ap
        positions[:, s] = state.position
        accept[:, s] = aps / thin
        logps[:, s] = state.logdensity
    return HMCSamples(positions=positions, accept_prob=accept,
                      step_size=step_size, logdensities=logps)


def precondition_from_cavi(Y: torch.Tensor, params, structure: str = "full",
                           warm_iters: int = 50, learning_rate: float = 0.5,
                           seed: int = 0, mask=None):
    """Run a short CAVI fit and return ``(init_position, inv_mass)``: the
    variational means as the chain start and the variational variances
    (clipped at 1e-6) as the diagonal inverse mass.  The fit is
    :func:`tame_torch.inference.cavi.fit_cavi` with
    ``update_mode="jacobi"`` on ``Y``'s device (K3 on the card inside its
    envelope, K1/K2 outside it), from :func:`cavi.init_state` drawn by a
    CPU generator seeded ``seed``.  ``mask`` makes it a masked fit, so
    hidden entries of ``Y`` are never read."""
    from tame_torch.inference import cavi

    n, _, T, _ = Y.shape
    params = params.to(Y.device, Y.dtype)
    init = cavi.init_state(torch.Generator().manual_seed(seed), n, T,
                           params.d, structure, 0.1, 0.5, device=Y.device)
    out = cavi.fit_cavi(Y, params, init, structure=structure,
                        update_mode="jacobi", max_iter=warm_iters,
                        learning_rate=learning_rate, mask=mask)
    variances = torch.diagonal(out.X_cov, dim1=-2, dim2=-1)   # (n, T, d)
    return out.X_mean, torch.clamp(variances, min=1e-6)


def declared_family(family, precondition: bool):
    """(the resolved family, whether to precondition): non-Gaussian
    families skip the CAVI preconditioner, whose warm fit is the Gaussian
    conjugate update (its covariances are no mass matrix for counts or
    binary ties)."""
    if family is not None:
        from tame_torch.models.likelihoods import get_family

        family = get_family(family)
        if family.name != "gaussian":
            precondition = False
    return family, precondition


class _Sampler:
    """What the HMC and NUTS engines share: the model's data and
    parameters on one device, the declared family, the batched target
    and the chain starts."""

    def __init__(self, model, num_chains: int, seed: int,
                 precondition: bool, mask, family):
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        from tame_torch.inference.logprob import make_logdensity_fn

        self.model = model
        self.Y = torch.as_tensor(model.Y)
        self.params = model.params.to(self.Y.device, self.Y.dtype)
        self.num_chains = num_chains
        self.seed = seed
        self.family, self.precondition = declared_family(family,
                                                         precondition)
        self.mask = (None if mask is None else torch.as_tensor(
            mask, dtype=self.Y.dtype, device=self.Y.device))
        self._logdensity = make_logdensity_fn(self.params, self.Y,
                                              obs_mask=self.mask,
                                              family=self.family)
        self._last_sample = None
        self.last_diagnostics = None

    def _starts(self, mesh):
        """(generator, chain starts (chains, n, T, d), inverse mass, chain
        shard): the CAVI center (or zeros) plus 0.01 N(0, 1) per chain,
        drawn from a generator on the data's device seeded ``seed``.  Under
        a ``mesh`` (:func:`tame_torch.parallel.make_mesh` with a ``batch``
        axis) every rank draws all the starts and keeps its chains."""
        shard = None
        if mesh is not None:
            from tame_torch.parallel.mesh import chain_shard

            shard = chain_shard(mesh, self.num_chains)
        if self.precondition:
            center, inv_mass = precondition_from_cavi(
                self.Y, self.params, seed=self.seed, mask=self.mask)
        else:
            center = torch.zeros(self.model.n, self.model.T, self.model.d,
                                 dtype=self.Y.dtype, device=self.Y.device)
            inv_mass = torch.ones_like(center)
        gen = torch.Generator(device=self.Y.device).manual_seed(self.seed)
        inits = center[None] + 0.01 * torch.randn(
            (self.num_chains,) + center.shape, generator=gen,
            device=center.device, dtype=center.dtype)
        if shard is not None:
            inits = inits[shard.lo:shard.hi]
        return gen, inits, inv_mass, shard

    def _keep(self, out: HMCSamples, shard):
        if shard is not None:
            out = shard.wrap(out, HMCSamples._fields)
        # Diagnostics are computed lazily (diagnostics()): the R-hat/ESS
        # pass copies the whole sample stack to the host.
        self._last_sample = out
        self.last_diagnostics = None
        return out

    def diagnostics(self):
        """Convergence report of the most recent :meth:`sample` call: max
        split-R-hat, min/median ESS, log-density R-hat
        (:func:`tame_torch.utils.diagnostics.chain_diagnostics`); computed
        on the first call and cached until the next :meth:`sample`."""
        return _lazy_diagnostics(self)


class TemporalAMEHMC(_Sampler):
    """HMC posterior sampler with the reference-compatible class feel:
    ``num_chains`` chains as one batch on the device of the model's
    ``Y``, CAVI-preconditioned by default.  ``mask`` makes the target the
    missing-data posterior (observed dyads only); ``family`` declares the
    dyadic observation model."""

    def __init__(self, model, num_chains: int = 4, num_leapfrog: int = 16,
                 seed: int = 0, precondition: bool = True, mask=None,
                 family=None):
        super().__init__(model, num_chains, seed, precondition, mask, family)
        self.num_leapfrog = num_leapfrog

    def sample(self, num_warmup: int = 200, num_samples: int = 200,
               thin: int = 1, mesh=None) -> HMCSamples:
        """Run the chains; returns samples with leading axes (chains,
        num_samples).  ``mesh`` (a :func:`tame_torch.parallel.make_mesh`
        mesh with a ``batch`` axis that divides ``num_chains``) runs each
        rank's chains on its device, with the numbers they draw unsharded,
        and returns a :class:`~tame_torch.parallel.mesh.Sharded` holding
        them (``full()`` gathers every chain; :meth:`diagnostics` reads
        this rank's).  Any other ``mesh`` raises ``TypeError``."""
        gen, inits, inv_mass, shard = self._starts(mesh)
        return self._keep(run_hmc(
            self._logdensity, inits, gen, num_warmup=num_warmup,
            num_samples=num_samples, num_leapfrog=self.num_leapfrog,
            inv_mass=inv_mass, thin=thin, shard=shard), shard)


def _lazy_diagnostics(sampler):
    """Shared lazy diagnostics accessor of the HMC and NUTS engines."""
    if getattr(sampler, "last_diagnostics", None) is not None:
        return sampler.last_diagnostics
    out = getattr(sampler, "_last_sample", None)
    if out is None:
        raise RuntimeError("call sample() first")
    C, N = out.positions.shape[:2]
    if C < 2 or N < 4:
        raise RuntimeError(
            f"chain diagnostics need >= 2 chains and >= 4 draws to "
            f"estimate split-R-hat; got {C} chain(s) x {N} draw(s)")
    from tame_torch.utils.diagnostics import chain_diagnostics

    sampler.last_diagnostics = chain_diagnostics(out.positions,
                                                 out.logdensities)
    return sampler.last_diagnostics
