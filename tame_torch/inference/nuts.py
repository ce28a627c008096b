"""No-U-Turn Sampler, iterative and batched over chains, for the temporal
AME posterior (counterpart of :mod:`tame.inference.nuts`).

The recursive doubling of Hoffman & Gelman (2014) is replaced by the
iterative checkpoint-stack scheme (cf. Phan & Pradhan, "Iterative NUTS").
U-turn bookkeeping inside a 2^depth subtree (1-indexed leapfrog steps k):

* odd  k: store (z_k, v_k) at checkpoint slot ``popcount((k-1)/2)``;
* even k: with ``t = trailing_zeros(k)`` and ``pc = popcount(k/2)``, the
  balanced subtrees ending at k have their start states in slots
  ``[pc-1, pc+t-2]``; check the endpoint criterion ``dot(z_k - z_a, v_a)
  < 0 or dot(z_k - z_a, v_k) < 0`` against each.

At most ``max_depth + 1`` checkpoints are live.  Candidates are drawn by
progressive multinomial sampling over leaf weights ``exp(-energy)``; a
trajectory stops on a subtree U-turn, a whole-trajectory U-turn or a
divergence.  Step sizes come from the dual-averaging warmup of
:mod:`tame_torch.inference.hmc`, and the diagonal mass can be
CAVI-preconditioned as there.

Chains are one batch.  The JAX package runs a ``lax.while_loop`` per chain
under ``vmap``: the lanes loop until every lane is done, and a finished
lane's state stays frozen.  Here that is a per-chain mask over one batch.
Every chain still going is at the same depth and the same leaf index k, so
k, the checkpoint slot and the range ``lo..hi`` are host integers, while
direction, step size and the ``turning`` / ``diverging`` flags are
per-chain tensors.  The host reads back whether any chain is still going
at most once per leapfrog step (:attr:`nuts_kernel.syncs` counts them):
after each leaf of a subtree but its last, and once after each subtree
that ran to its end.  A subtree that ends early because every chain
stopped ends the transition, with no further read.

A transition's randomness is drawn up front, one call per kind
(:class:`NUTSDraws`: momentum noise, directions, subtree-swap uniforms
and per-leaf uniforms), and passed to :func:`nuts_transition`; a test can
feed it the JAX package's own draws, or one chain's draws alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tame_torch.inference.hmc import (
    HMCSamples,
    _da_init,
    _da_update,
    _dot,
    _Sampler,
    initial_step_sizes,
    per_chain,
    value_and_grad,
    with_args,
)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each entry of an int32 tensor (its 32-bit pattern)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _trailing_zeros(x: torch.Tensor) -> torch.Tensor:
    """Number of trailing zero bits of each positive int32 entry."""
    return _popcount((x & -x) - 1)


def _bits(k: int) -> int:
    return bin(k).count("1")


class NUTSDraws(NamedTuple):
    """One transition's randomness for C chains at ``max_depth``:
    standard-normal momentum noise (C, ...), directions ±1 (C, max_depth),
    subtree-swap uniforms (C, max_depth) and per-leaf uniforms (C,
    2^max_depth - 1), leaf k (1-based) of the subtree at depth j in column
    ``2^j - 1 + k - 1``."""

    noise: torch.Tensor
    direction: torch.Tensor
    swap: torch.Tensor
    leaf: torch.Tensor


def nuts_draws(generator: torch.Generator, position: torch.Tensor,
               max_depth: int, shard=None) -> NUTSDraws:
    """One transition's draws for the chains in ``position``; under a
    ``shard`` (:class:`tame_torch.parallel.mesh.ChainShard`) those of the
    whole batch, sliced to this rank's chains."""
    C = position.shape[0] if shard is None else shard.total
    dev, dt = position.device, position.dtype
    draws = NUTSDraws(
        noise=torch.randn((C,) + position.shape[1:], generator=generator,
                          device=dev, dtype=dt),
        direction=torch.where(
            torch.rand(C, max_depth, generator=generator, device=dev) < 0.5,
            1.0, -1.0).to(dt),
        swap=torch.rand(C, max_depth, generator=generator, device=dev,
                        dtype=dt),
        leaf=torch.rand(C, 2 ** max_depth - 1, generator=generator,
                        device=dev, dtype=dt))
    return draws if shard is None else NUTSDraws(
        *(x[shard.lo:shard.hi] for x in draws))


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-chain select: ``a`` where ``mask`` (chains,), else ``b``."""
    return torch.where(per_chain(mask, a), a, b)


@torch.no_grad()
def nuts_transition(logdensity_fn: Callable, position: torch.Tensor,
                    draws: NUTSDraws, step_size: torch.Tensor,
                    inv_mass: torch.Tensor, max_depth: int = 8):
    """One NUTS transition of every chain in ``position`` (chains, ...),
    each with its own ``step_size`` (chains,), from ``draws``.  Returns
    (new_position, new_logp, stats) with per-chain stats ``accept_prob``,
    ``depth``, ``n_leapfrog`` and ``diverging``, and ``syncs``, the host
    readbacks made, and ``steps``, the batched leapfrog steps (one
    gradient of every chain each)."""
    C = position.shape[0]
    logp0, grad0 = value_and_grad(logdensity_fn, position)
    momentum = draws.noise / torch.sqrt(inv_mass)
    energy0 = -logp0 + 0.5 * _dot(momentum, inv_mass * momentum)
    z_ck = position.new_zeros((max_depth + 1,) + position.shape)
    v_ck = torch.zeros_like(z_ck)

    zl, rl, gl = position, momentum, grad0
    zr, rr, gr = position, momentum, grad0
    z_cand, logp_cand = position, logp0
    log_sum_w = torch.zeros_like(logp0)          # the initial leaf: w = 1
    depth = torch.zeros(C, dtype=torch.int32, device=position.device)
    n_leaf = torch.zeros_like(depth)
    turning = torch.zeros(C, dtype=torch.bool, device=position.device)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros_like(logp0)
    going = torch.ones_like(turning)     # depth < max_depth, no stop yet
    syncs = steps = 0
    for j in range(max_depth):
        # -- build the subtree of 2^j leaves on the side of `direction` ---
        direction = draws.direction[:, j]
        right = direction > 0
        eps = per_chain(direction * step_size, position)
        half_eps, eps_im = 0.5 * eps, eps * inv_mass
        z, r, g = _sel(right, zr, zl), _sel(right, rr, rl), _sel(right, gr, gl)
        s_zc, s_lpc = z, torch.full_like(logp0, -torch.inf)
        s_logw = torch.full_like(logp0, -torch.inf)
        s_turn = torch.zeros_like(turning)
        s_div = torch.zeros_like(turning)
        s_acc = torch.zeros_like(logp0)
        s_steps = torch.zeros_like(depth)
        active = going
        n_steps = 1 << j
        early = False
        for k in range(1, n_steps + 1):
            rk = r + half_eps * g
            zk = z + eps_im * rk
            logp, gk = value_and_grad(logdensity_fn, zk)
            steps += 1
            rk = rk + half_eps * gk
            imr = inv_mass * rk
            delta = energy0 - (-logp + 0.5 * _dot(rk, imr))
            delta = torch.where(torch.isnan(delta), -torch.inf, delta)
            # progressive multinomial within the subtree
            log_w_new = torch.logaddexp(s_logw, delta)
            take = active & (torch.log(draws.leaf[:, n_steps - 1 + k - 1])
                             < delta - log_w_new)
            s_zc = _sel(take, zk, s_zc)
            s_lpc = torch.where(take, logp, s_lpc)
            s_logw = torch.where(active, log_w_new, s_logw)
            s_acc = s_acc + torch.where(
                active, torch.clamp(torch.exp(delta), max=1.0), 0.0)
            s_div = s_div | (active & (delta < -1000.0))
            s_steps = s_steps + active.to(s_steps.dtype)
            # checkpoints; direction-signed velocities make the endpoint
            # criterion read the same in both integration directions
            v = per_chain(direction, rk) * imr
            if k % 2 == 1:
                slot = _bits((k - 1) // 2)
                z_ck[slot] = _sel(active, zk, z_ck[slot])
                v_ck[slot] = _sel(active, v, v_ck[slot])
            else:
                pc = _bits(k // 2)
                lo, hi = pc - 1, pc + _bits((k & -k) - 1) - 2
                turn = torch.zeros_like(turning)
                for s in range(lo, hi + 1):
                    dz = zk - z_ck[s]
                    turn = turn | (_dot(dz, v_ck[s]) < 0.0) | (_dot(dz, v)
                                                               < 0.0)
                s_turn = s_turn | (active & turn)
            # a chain that has stopped keeps its subtree's end state
            z, r, g = _sel(active, zk, z), _sel(active, rk, r), _sel(active,
                                                                    gk, g)
            active = active & ~(s_turn | s_div)
            if k < n_steps:
                syncs += 1
                if not bool(active.any()):
                    early = True
                    break
        # -- merge the subtree into the trajectory (chains still going) ---
        gr_ = going & right
        gl_ = going & ~right
        zl, rl, gl = _sel(gl_, z, zl), _sel(gl_, r, rl), _sel(gl_, g, gl)
        zr, rr, gr = _sel(gr_, z, zr), _sel(gr_, r, rr), _sel(gr_, g, gr)
        ok = going & ~(s_turn | s_div)
        take = ok & (torch.log(draws.swap[:, j]) < s_logw - log_sum_w)
        z_cand = _sel(take, s_zc, z_cand)
        logp_cand = torch.where(take, s_lpc, logp_cand)
        log_sum_w = torch.where(ok, torch.logaddexp(log_sum_w, s_logw),
                                log_sum_w)
        # whole-trajectory U-turn (velocity frame)
        dz = zr - zl
        traj_turn = ((_dot(dz, inv_mass * rl) < 0.0)
                     | (_dot(dz, inv_mass * rr) < 0.0))
        depth = depth + going.to(depth.dtype)
        turning = turning | (going & (s_turn | traj_turn))
        diverging = diverging | (going & s_div)
        sum_accept = sum_accept + torch.where(going, s_acc, 0.0)
        n_leaf = n_leaf + torch.where(going, s_steps, 0)
        going = going & ~(turning | diverging)
        if early:
            break                  # every chain stopped inside the subtree
        if j + 1 < max_depth:
            syncs += 1
            if not bool(going.any()):
                break
    stats = {"accept_prob": sum_accept / torch.clamp(n_leaf, min=1),
             "depth": depth, "n_leapfrog": n_leaf, "diverging": diverging,
             "syncs": syncs, "steps": steps}
    return z_cand, logp_cand, stats


def nuts_kernel(logdensity_fn: Callable, position: torch.Tensor,
                generator: Optional[torch.Generator],
                step_size: torch.Tensor, inv_mass: torch.Tensor,
                max_depth: int = 8, *, draws: Optional[NUTSDraws] = None,
                shard=None):
    """One NUTS transition of the chains in ``position`` (chains, ...):
    draws the transition's randomness from ``generator`` (unless
    ``draws`` are given; as :func:`nuts_draws` under ``shard``) and runs
    :func:`nuts_transition`.  Returns
    (new_position, new_logp, stats).  ``nuts_kernel.syncs``,
    ``nuts_kernel.steps`` and ``nuts_kernel.transitions`` count the host
    readbacks, the batched leapfrog steps and the transitions made."""
    if draws is None:
        draws = nuts_draws(generator, position, max_depth, shard)
    out = nuts_transition(logdensity_fn, position, draws, step_size,
                          inv_mass, max_depth)
    nuts_kernel.syncs += out[2]["syncs"]
    nuts_kernel.steps += out[2]["steps"]
    nuts_kernel.transitions += 1
    return out


nuts_kernel.syncs = 0
nuts_kernel.steps = 0
nuts_kernel.transitions = 0


@torch.no_grad()
def run_nuts(logdensity_fn: Callable, init_position: torch.Tensor,
             generator: torch.Generator, *, num_warmup: int = 200,
             num_samples: int = 200, max_depth: int = 8,
             initial_step_size: float = 0.01,
             inv_mass: Optional[torch.Tensor] = None,
             target_accept: float = 0.8,
             logdensity_args: tuple = (), shard=None) -> HMCSamples:
    """Run NUTS chains: dual-averaging warmup, then sampling.

    ``init_position`` (chains, ...), ``logdensity_fn`` (chains, ...) ->
    (chains,) and ``inv_mass`` as in
    :func:`tame_torch.inference.hmc.run_hmc`; every chain adapts its own
    step size.  Returns :class:`~tame_torch.inference.hmc.HMCSamples`
    (positions (chains, num_samples, ...), accept statistics, final step
    sizes (chains,), log densities).  ``shard`` as in
    :func:`~tame_torch.inference.hmc.run_hmc`."""
    logdensity_fn = with_args(logdensity_fn, logdensity_args)
    if inv_mass is None:
        inv_mass = torch.ones_like(init_position[0])
    pos = init_position
    da = _da_init(initial_step_sizes(init_position, initial_step_size))
    for _ in range(num_warmup):
        pos, _, stats = nuts_kernel(logdensity_fn, pos, generator,
                                    torch.exp(da.log_eps), inv_mass,
                                    max_depth, shard=shard)
        da = _da_update(da, stats["accept_prob"], target=target_accept)
    step_size = torch.exp(da.log_eps_avg)

    C = init_position.shape[0]
    positions = init_position.new_empty((C, num_samples)
                                        + init_position.shape[1:])
    accept = init_position.new_empty((C, num_samples))
    logps = init_position.new_empty((C, num_samples))
    for s in range(num_samples):
        pos, logp, stats = nuts_kernel(logdensity_fn, pos, generator,
                                       step_size, inv_mass, max_depth,
                                       shard=shard)
        positions[:, s] = pos
        accept[:, s] = stats["accept_prob"]
        logps[:, s] = logp
    return HMCSamples(positions=positions, accept_prob=accept,
                      step_size=step_size, logdensities=logps)


class TemporalAMENUTS(_Sampler):
    """NUTS posterior sampler with CAVI preconditioning (the class surface
    of :class:`tame_torch.inference.hmc.TemporalAMEHMC`)."""

    def __init__(self, model, num_chains: int = 4, max_depth: int = 8,
                 seed: int = 0, precondition: bool = True, mask=None,
                 family=None):
        super().__init__(model, num_chains, seed, precondition, mask, family)
        self.max_depth = max_depth

    def sample(self, num_warmup: int = 200, num_samples: int = 200,
               mesh=None) -> HMCSamples:
        """Run the chains (see :meth:`TemporalAMEHMC.sample`, ``mesh``
        included)."""
        gen, inits, inv_mass, shard = self._starts(mesh)
        return self._keep(run_nuts(
            self._logdensity, inits, gen, num_warmup=num_warmup,
            num_samples=num_samples, max_depth=self.max_depth,
            inv_mass=inv_mass, shard=shard), shard)
