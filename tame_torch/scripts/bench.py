"""Benchmark: Good-SMF CAVI throughput on the demo configuration, plus the
north-star wall clock to converged at n=2000 (port of ``bench.py``).

    python -m tame_torch.scripts.bench [--n-fits 512 --repeats 5]

Prints ONE JSON line with ``bench.py``'s keys: ``metric``, ``value``,
``unit``, ``vs_baseline`` and the ``n2000_*``, ``n2000_warm_*`` and
``n2000_smoothed_*`` keys.  A leg that fails raises: no line is printed.

Demo leg: ``--n-fits`` strictly sequential 150-iteration Good-SMF fits at
n=15, T=10, r=2 (phi 0.8, rho 0.5, seed 42), lr 0.7, tolerance 0, Jacobi
updates, exact diagnostics, each from its own init drawn from one
generator on the device.  On the card each fit is one K3 launch
(``fit_cavi``'s ``fused="auto"``), which the script asserts.  The rate is
``n_fits * 150 / wall`` for the best of ``--repeats`` timed runs after one
warm-up run, host clock ending in a synchronize (each fit reads its
stopping statistics back, so the fits do not overlap).  ``vs_baseline``
divides by the reference implementation's 4.81 iterations/s, measured on
a CPU (BASELINE.md).

n=2000 legs (T=50, r=4, 8 blocks, lr 0.8, tolerance 1e-4 x patience 3,
``max_iter`` 512, bf16 weights, stats diagnostics): a cold fit from a
random init, a warm fit from ``warm_init_state`` and a smoothed fit from
``warm_init_smoothed_state``, each to its stop and timed alone (the init
is built before the clock starts); one 2-iteration fit first, untimed, so
the first bf16 products pick their library kernels.  On the card the cold
and warm fits must run K1 and K2, the smoothed fit one K4 launch per
block phase.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from tame_torch.config import ModelConfig
from tame_torch.inference import cavi
from tame_torch.inference.smoothed import (
    fit_cavi_smoothed,
    init_smoothed_state,
    warm_init_smoothed_state,
)
from tame_torch.models import build_params, sample
from tame_torch.ops import cholesky, fused_fit, fused_smoother
from tame_torch.scripts import _common

BASELINE_ITERS_PER_S = 4.81  # reference Good SMF on a CPU, BASELINE.md
N_ITERS = 150


def _counts() -> dict:
    return {"K1": cholesky.spd_solve_inv_kernel.launches,
            "K2": cholesky.logdet_spd_kernel.launches,
            "K3": fused_fit.fused_fit_kernel.launches,
            "K4": fused_smoother.fused_smoother_kernel.launches}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def demo_rate(device: torch.device, n_fits: int, repeats: int) -> float:
    """ELBO iterations per second over ``n_fits`` sequential fits."""
    cfg = ModelConfig(n_nodes=15, n_time=10, latent_dim=2,
                      ar_coefficient=0.8, rho_dyadic=0.5, seed=42)
    params = build_params(cfg).to(device)
    Y, _ = sample(params, torch.Generator(device=device).manual_seed(42),
                  cfg.n_nodes, cfg.n_time)
    gen = torch.Generator(device=device).manual_seed(43)

    def run_fits():
        before = _counts()
        for _ in range(n_fits):
            init = cavi.init_state(gen, cfg.n_nodes, cfg.n_time, cfg.d,
                                   "full", 0.1, 0.5)
            out = cavi.fit_cavi(Y, params, init, structure="full",
                                update_mode="jacobi", max_iter=N_ITERS,
                                learning_rate=0.7, tolerance=0.0,
                                diag_mode="exact")
            _common.require(out.n_iter == N_ITERS,
                            f"a demo fit ran {out.n_iter} iterations, not "
                            f"{N_ITERS}")
        if device.type == "cuda":
            _common.require(_delta(before)["K3"] == n_fits,
                            "the demo fits did not run one K3 launch each")

    run_fits()  # warm-up
    best = min(_common.timed(run_fits, device)[1] for _ in range(repeats))
    return n_fits * N_ITERS / best


def _smoothed_blocks(n: int) -> int:
    """Block phases per smoothed iteration under ``update_mode="auto"``."""
    if n < 256:
        return 1
    return next(k for k in range(min(16, n), 0, -1) if n % k == 0)


def n2000_metrics(device: torch.device, n: int, T: int, r: int,
                  num_blocks: int, max_iter: int) -> dict:
    cfg, params, Y = _common.north_star(device, n, T, r)
    gen = torch.Generator(device=device).manual_seed(900)
    kw = dict(structure="full", update_mode="block", num_blocks=num_blocks,
              max_iter=max_iter, learning_rate=0.8, tolerance=1e-4,
              mixed_precision=True, diag_mode="stats")
    on_card = device.type == "cuda"

    def cold():
        return cavi.init_state(gen, n, T, cfg.d, "full", 0.1, 0.5)

    def fit(init, label):
        before = _counts()
        out, wall = _common.timed(
            lambda: cavi.fit_cavi(Y, params, init, **kw), device)
        got = _delta(before)
        if on_card:
            _common.require(got["K1"] > 0 and got["K2"] > 0 and got["K3"] == 0,
                            f"the {label} n={n} fit did not run through K1 "
                            f"and K2: {got}")
        return out, wall

    cavi.fit_cavi(Y, params, cold(), **{**kw, "max_iter": 2})  # warm-up
    out, wall = fit(cold(), "cold")
    res = {"n2000_wall_to_converged_s": wall,
           "n2000_iters": out.n_iter,
           "n2000_converged": out.converged,
           "n2000_ms_per_iter": wall / out.n_iter * 1e3}
    out_w, wall_w = fit(cavi.warm_init_state(Y, params, structure="full"),
                        "warm")
    res.update(n2000_warm_wall_to_converged_s=wall_w,
               n2000_warm_iters=out_w.n_iter,
               n2000_warm_converged=out_w.converged)

    skw = dict(learning_rate=0.8, tolerance=1e-4, mixed_precision=True,
               diag_mode="stats")
    sinit = warm_init_smoothed_state(Y, params)
    fit_cavi_smoothed(Y, params, init_smoothed_state(gen, n, T, cfg.d),
                      max_iter=2, **skw)  # warm-up
    before = _counts()
    out_s, wall_s = _common.timed(
        lambda: fit_cavi_smoothed(Y, params, sinit, max_iter=max_iter, **skw),
        device)
    if on_card:
        want = _smoothed_blocks(n) * out_s.n_iter
        _common.require(_delta(before)["K4"] == want,
                        f"the smoothed n={n} fit did not launch K4 {want} "
                        f"times")
    res.update(n2000_smoothed_wall_to_converged_s=wall_s,
               n2000_smoothed_iters=out_s.n_iter,
               n2000_smoothed_converged=out_s.converged,
               n2000_smoothed_ms_per_iter=wall_s / out_s.n_iter * 1e3)
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n-fits", type=int, default=512,
                        help="sequential demo fits per timed run")
    parser.add_argument("--repeats", type=int, default=5,
                        help="timed demo runs (best taken)")
    _common.size_flags(parser)
    parser.add_argument("--num-blocks", type=int, default=8)
    parser.add_argument("--max-iter", type=int, default=512)
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    print(_common.describe(device), file=sys.stderr, flush=True)

    iters_per_s = demo_rate(device, args.n_fits, args.repeats)
    extra = n2000_metrics(device, args.n, args.T, args.r, args.num_blocks,
                          args.max_iter)
    line = {"metric": "good_smf_elbo_iterations_per_s",
            "value": iters_per_s,
            "unit": "iter/s",
            "vs_baseline": iters_per_s / BASELINE_ITERS_PER_S,
            **extra}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
