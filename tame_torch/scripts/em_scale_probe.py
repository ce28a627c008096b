"""Hyperparameter learning at the north-star scale: ``fit_em`` at n=2000,
T=50, r=4 from a wrong start (port of ``scripts/em_scale_probe.py``,
Gaussian leg).

    python -m tame_torch.scripts.em_scale_probe [--n-em 10]

Truth phi 0.8, rho 0.5, sigma2 0.1; start phi 0.3, rho 0, sigma2 1.0; the
E-steps on the production flags (bf16 weights, stats diagnostics), 60
inner iterations at most.  Host clock ending in a synchronize.

The JAX script's binary (Bernoulli) leg needs the non-Gaussian families,
which the port does not have yet (ROADMAP queue A item 12): ``--binary``
raises ``NotImplementedError`` saying so.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from tame_torch.config import ModelConfig
from tame_torch.inference import fit_em
from tame_torch.models import build_params
from tame_torch.ops import fused_smoother
from tame_torch.scripts import _common

BINARY_WAITS = ("the binary (Bernoulli) EM leg of em_scale_probe needs the "
                "non-Gaussian families, not ported yet (ROADMAP queue A item "
                "12)")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.size_flags(parser)
    parser.add_argument("--n-em", type=int, default=10)
    parser.add_argument("--inner-max-iter", type=int, default=60)
    parser.add_argument("--binary", action="store_true",
                        help="the binary leg (raises: not ported yet)")
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    if args.binary:
        raise NotImplementedError(BINARY_WAITS)
    device = _common.resolve_device(args.device)
    n, T, r = args.n, args.T, args.r
    print(_common.describe(device), flush=True)
    _, _, Y = _common.north_star(device, n, T, r, ar_coefficient=0.8,
                                 rho_dyadic=0.5)
    start = build_params(ModelConfig(
        n_nodes=n, n_time=T, latent_dim=r, seed=0, ar_coefficient=0.3,
        rho_dyadic=0.0, dyadic_variance=1.0)).to(device)
    before = fused_smoother.fused_smoother_kernel.launches
    res, wall = _common.timed(lambda: fit_em(
        Y, start, n_em=args.n_em, inner_max_iter=args.inner_max_iter,
        mixed_precision=True, diag_mode="stats", verbose=True), device)
    if device.type == "cuda":
        _common.require(fused_smoother.fused_smoother_kernel.launches > before,
                        "the EM E-steps did not run K4")
    h = res.history
    done = len(h["elbo"])
    print(f"fit_em n={n}: {done} EM iterations in {wall} s ({wall / done} "
          f"s per EM iteration)", flush=True)
    print(f"phi={h['phi'][-1]} (true 0.8)  sigma2={h['sigma2'][-1]} (true "
          f"0.1)  rho={h['rho'][-1]} (true 0.5)", flush=True)
    print(f"binary leg: not run; {BINARY_WAITS}", flush=True)
    return {"em_iters": done, "wall_s": wall, "phi": h["phi"][-1],
            "sigma2": h["sigma2"][-1], "rho": h["rho"][-1]}


if __name__ == "__main__":
    main()
