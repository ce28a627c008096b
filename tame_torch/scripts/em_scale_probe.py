"""Hyperparameter learning at scale: ``fit_em`` from a wrong start (port
of ``scripts/em_scale_probe.py``).

    python -m tame_torch.scripts.em_scale_probe [--n-em 10]
    python -m tame_torch.scripts.em_scale_probe --binary

Gaussian leg (default): n=2000, T=50, r=4; truth phi 0.8, rho 0.5, sigma2
0.1; start phi 0.3, rho 0, sigma2 1.0; the E-steps on the production flags
(bf16 weights, stats diagnostics), 60 inner iterations at most, 10 EM
iterations.

Binary leg (``--binary``): n=1000, T=20, r=2, Bernoulli ties from truth phi
0.8 (seed 1), start phi 0.3; 8 EM iterations of at most 60 inner ones of
the smoothed binary E-step at lr 0.7, one K4 launch per inner iteration on
the card.  The flags override either leg's sizes.  Host clock ending in a
synchronize.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from tame_torch.config import ModelConfig
from tame_torch.inference import fit_em
from tame_torch.models import build_params, sample
from tame_torch.ops import fused_smoother
from tame_torch.scripts import _common

# (n, T, r, EM iterations) of each leg
GAUSSIAN_LEG = (2000, 50, 4, 10)
BINARY_LEG = (1000, 20, 2, 8)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.size_flags(parser, n=None, T=None, r=None)  # None: the leg's
    parser.add_argument("--n-em", type=int, default=None)
    parser.add_argument("--inner-max-iter", type=int, default=60)
    parser.add_argument("--binary", action="store_true",
                        help="the binary (Bernoulli) leg")
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    leg = BINARY_LEG if args.binary else GAUSSIAN_LEG
    n, T, r, n_em = (v if v is not None else d for v, d in
                     zip((args.n, args.T, args.r, args.n_em), leg))
    print(_common.describe(device), flush=True)
    if args.binary:
        truth = build_params(ModelConfig(n_nodes=n, n_time=T, latent_dim=r,
                                         seed=1, ar_coefficient=0.8))
        Y, _ = sample(truth.to(device),
                      torch.Generator(device=device).manual_seed(1), n, T,
                      family="bernoulli")
        start = build_params(ModelConfig(
            n_nodes=n, n_time=T, latent_dim=r, seed=1,
            ar_coefficient=0.3)).to(device)
        kw = dict(family="bernoulli", learning_rate=0.7)
    else:
        _, _, Y = _common.north_star(device, n, T, r, ar_coefficient=0.8,
                                     rho_dyadic=0.5)
        start = build_params(ModelConfig(
            n_nodes=n, n_time=T, latent_dim=r, seed=0, ar_coefficient=0.3,
            rho_dyadic=0.0, dyadic_variance=1.0)).to(device)
        kw = dict(mixed_precision=True, diag_mode="stats")
    before = fused_smoother.fused_smoother_kernel.launches
    res, wall = _common.timed(lambda: fit_em(
        Y, start, n_em=n_em, inner_max_iter=args.inner_max_iter,
        verbose=True, **kw), device)
    launches = fused_smoother.fused_smoother_kernel.launches - before
    if device.type == "cuda":
        _common.require(launches > 0, "the EM E-steps did not run K4")
    h = res.history
    done = len(h["elbo"])
    leg_name = "binary" if args.binary else "Gaussian"
    print(f"fit_em {leg_name} n={n} T={T} r={r}: {done} EM iterations in "
          f"{wall} s ({wall / done} s per EM iteration), {launches} K4 "
          f"launches", flush=True)
    print(f"phi={h['phi'][-1]} (true 0.8)  sigma2={h['sigma2'][-1]} "
          f"({'held' if args.binary else 'true 0.1'})  rho={h['rho'][-1]} "
          f"({'held' if args.binary else 'true 0.5'})", flush=True)
    return {"leg": leg_name, "em_iters": done, "wall_s": wall,
            "k4_launches": launches, "phi": h["phi"][-1],
            "sigma2": h["sigma2"][-1], "rho": h["rho"][-1]}


if __name__ == "__main__":
    main()
