"""The block-count trade-off at the north-star configuration: per-iteration
time (slope) and iterations to converged for 4, 8 and 16 block phases
(port of ``scripts/block_count_probe.py``).

    python -m tame_torch.scripts.block_count_probe [--blocks 4,8,16]

Production flags (bf16 weights, stats diagnostics), lr 0.8; the slope is
(wall(40) - wall(8)) / 32 at tolerance 0, the converged fit runs at
tolerance 1e-4 x patience 3 to ``--max-iter``.  Host clock ending in a
synchronize.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from tame_torch.inference import cavi
from tame_torch.scripts import _common


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.size_flags(parser)
    parser.add_argument("--blocks", default="4,8,16",
                        help="comma-separated block counts")
    parser.add_argument("--short", type=int, default=8)
    parser.add_argument("--long", type=int, default=40)
    parser.add_argument("--max-iter", type=int, default=512)
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    n, T, r = args.n, args.T, args.r
    print(_common.describe(device), flush=True)
    cfg, params, Y = _common.north_star(device, n, T, r)

    results = {}
    for nb in (int(b) for b in args.blocks.split(",")):
        def run(i, iters, tol=0.0):
            init = cavi.init_state(
                torch.Generator(device=device).manual_seed(300 + i), n, T,
                cfg.d, "full", 0.1, 0.5)
            return cavi.fit_cavi(Y, params, init, structure="full",
                                 update_mode="block", num_blocks=nb,
                                 max_iter=iters, learning_rate=0.8,
                                 tolerance=tol, mixed_precision=True,
                                 diag_mode="stats")

        _, ms = _common.slope_ms(run, args.short, args.long, device)
        out, wall = _common.timed(lambda: run(3, args.max_iter, 1e-4),
                                  device)
        mse = out.mse_history[out.n_iter - 1].item()
        results[nb] = {"ms_per_iter": ms, "converged": out.converged,
                       "iters": out.n_iter, "wall_s": wall, "mse": mse}
        print(f"num_blocks={nb}: {ms} ms/iteration | converged="
              f"{out.converged} at iteration {out.n_iter} in {wall} s | "
              f"final MSE {mse}", flush=True)
    return results


if __name__ == "__main__":
    main()
