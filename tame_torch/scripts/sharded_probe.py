"""Where a sharded fit's time goes beside the plain one, on one rank.

    python -m tame_torch.scripts.sharded_probe [--device cuda|cpu]
        [--n 2000 --T 50 --r 4] [--iters 20]

The north-star Good-SMF block fit (16 blocks, lr 0.8, tolerance 0) as a
plain fit and on a one-rank mesh (NCCL on the card, gloo on the CPU):
ms/iteration in turns (plain, sharded, sharded, plain), the device work
per iteration of each under ``torch.profiler`` (a 5- minus a 2-iteration
fit) with the idle share, and the host's microseconds per collective of
one block phase (a padded all-gather of the block's means, the ELBO's
6-float all-reduce), with and without waiting for the device after each.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional, Sequence

import torch

from tame_torch.inference import cavi
from tame_torch.parallel import comm, make_mesh, shard_fit_inputs
from tame_torch.scripts import _common

FIT = dict(structure="full", update_mode="block", num_blocks=16,
           learning_rate=0.8, tolerance=0.0)


def _host_us(fn, device, reps: int, wait: bool) -> float:
    fn()
    _common.sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        if wait:
            _common.sync(device)
    _common.sync(device)
    return (time.perf_counter() - t0) * 1e6 / reps


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.size_flags(parser)
    parser.add_argument("--iters", type=int, default=20,
                        help="iterations of each timed fit")
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    where = _common.describe(device)
    print(where, flush=True)
    n, T, r = args.n, args.T, args.r
    cfg, params, Y = _common.north_star(device, n, T, r)
    init = cavi.init_state(torch.Generator().manual_seed(1), n, T, cfg.d,
                           "full", 0.1, 0.5)
    init_dev = cavi.CaviState(*(t.to(device) for t in init))
    mesh = make_mesh(device=device)
    Y_s, init_s = shard_fit_inputs(mesh, Y, init)
    runs = {"plain": lambda k: cavi.fit_cavi(Y, params, init_dev,
                                             max_iter=k, **FIT),
            "one rank": lambda k: cavi.fit_cavi(Y_s, params, init_s,
                                                max_iter=k, **FIT)}
    for run in runs.values():
        run(2)  # warm-up: kernel loads, library plans, the communicator
    turns = {k: [] for k in runs}
    for label in ("plain", "one rank", "one rank", "plain"):
        _, s = _common.timed(lambda: runs[label](args.iters), device)
        turns[label].append(s * 1e3 / args.iters)
    out = {"where": where, "n": n, "T": T, "r": r, "iters": args.iters,
           "ms_per_iter_turns": turns, "profile": {}}
    for label, run in runs.items():
        out["profile"][label] = _common.profile_device(
            run, device, 2, 5, statistics.median(turns[label]))
    bs = n // 16
    piece = torch.zeros(bs, T, cfg.d, device=device)
    parts = torch.zeros(6, device=device)
    out["host_us_per_collective"] = {
        f"{kind}, {'waiting' if wait else 'no wait'}": _host_us(
            fn, device, 200, wait)
        for kind, fn in (("all_gather (bs, T, d)",
                          lambda: mesh.comm.all_gather(piece, "mesh")),
                         ("all_reduce (6,)",
                          lambda: mesh.comm.all_reduce(parts, "mesh")))
        for wait in (False, True)}
    comm.destroy()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
