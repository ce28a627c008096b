"""Is Jacobi stable at n=2000?  The MSE trajectories of Jacobi updates at
three damping rates against 8-block Gauss-Seidel updates (port of
``scripts/jacobi_scale_probe.py``).

    python -m tame_torch.scripts.jacobi_scale_probe [--iters 60]

Jacobi halves the per-iteration weight traffic but loses freshness within
a sweep, so it only pays if it converges at a workable damping without
many more iterations.  Production flags, tolerance 0, one shared init.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from tame_torch.inference import cavi
from tame_torch.scripts import _common

RUNS = (("block", 0.8), ("jacobi", 0.8), ("jacobi", 0.5), ("jacobi", 0.3))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.size_flags(parser)
    parser.add_argument("--iters", type=int, default=60)
    parser.add_argument("--num-blocks", type=int, default=8)
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    n, T, r = args.n, args.T, args.r
    print(_common.describe(device), flush=True)
    cfg, params, Y = _common.north_star(device, n, T, r)
    init = cavi.init_state(torch.Generator(device=device).manual_seed(1), n,
                           T, cfg.d, "full", 0.1, 0.5)
    marks = sorted({min(i, args.iters - 1)
                    for i in (0, 5, 10, 20, 40, args.iters - 1)})

    results = {}
    for mode, lr in RUNS:
        out, wall = _common.timed(lambda: cavi.fit_cavi(
            Y, params, init, structure="full", update_mode=mode,
            num_blocks=args.num_blocks if mode == "block" else None,
            max_iter=args.iters, learning_rate=lr, tolerance=0.0,
            mixed_precision=True, diag_mode="stats"), device)
        mh = out.mse_history[:args.iters].tolist()
        tag = f"{mode} lr={lr}"
        results[tag] = {"mse": {i: mh[i] for i in marks}, "wall_s": wall}
        print(f"{tag}: MSE at {marks} = {[mh[i] for i in marks]} ({wall} "
              f"s)", flush=True)
    return results


if __name__ == "__main__":
    main()
