"""Good-SMF fits to the stop at the north-star configuration (n=2000, T=50,
r=4), dense: the production flags (bf16 weights, stats diagnostics) and
the float32 exact-diagnostics fit (port of ``scripts/scale_bench.py``).

    python -m tame_torch.scripts.scale_bench [--out result.json]

Each variant runs one fit to the stop (reported as the first fit), then
``--repeats`` more from distinct random inits; the fastest is kept.  8-block
updates, lr 0.8, tolerance 1e-4 x patience 3, ``max_iter`` 512.  Host
clock ending in a synchronize.  The JSON record goes to ``--out`` when
given, else to stdout as the last line; nothing else is written.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Optional, Sequence

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.scripts import _common

VARIANTS = (("mixed+stats dense", dict(mixed_precision=True,
                                       diag_mode="stats")),
            ("f32 exact dense", {}))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.size_flags(parser)
    parser.add_argument("--num-blocks", type=int, default=8)
    parser.add_argument("--max-iter", type=int, default=512)
    parser.add_argument("--repeats", type=int, default=2,
                        help="timed fits per variant after the first")
    parser.add_argument("--out", default=None,
                        help="write the JSON record here (default: stdout)")
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    n, T, r = args.n, args.T, args.r
    where = _common.describe(device)
    print(where, flush=True)
    (cfg, params, Y), t_gen = _common.timed(
        lambda: _common.north_star(device, n, T, r), device)
    print(f"gen {t_gen} s", flush=True)

    runs = []
    for v, (label, kw) in enumerate(VARIANTS):
        def fit(i):
            init = cavi.init_state(
                torch.Generator(device=device).manual_seed(300 + 100 * v + i),
                n, T, cfg.d, "full", 0.1, 0.5)
            return _common.timed(lambda: cavi.fit_cavi(
                Y, params, init, structure="full", update_mode="block",
                num_blocks=args.num_blocks, max_iter=args.max_iter,
                learning_rate=0.8, tolerance=1e-4, **kw), device)

        _, t_first = fit(0)
        print(f"{label}: first fit {t_first} s", flush=True)
        best, best_out = math.inf, None
        for i in range(1, args.repeats + 1):
            out, dt = fit(i)
            if dt < best:
                best, best_out = dt, out
        ni = best_out.n_iter
        mh = best_out.mse_history.numpy()
        mse = float(mh[~np.isnan(mh)][-1])
        run = {"variant": label, "iters": ni, "wall_s": best,
               "ms_per_iter": best / ni * 1e3, "mse": mse,
               "converged": best_out.converged, "first_fit_s": t_first}
        print(f"{label}: {run}", flush=True)
        runs.append(run)

    record = {"config": {"n": n, "T": T, "r": r,
                         "num_blocks": args.num_blocks},
              "device": where, "gen_s": t_gen, "runs": runs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
    else:
        print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
