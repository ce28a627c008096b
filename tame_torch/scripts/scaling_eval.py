"""Strong scaling of the sharded Good-SMF fit over the ranks this machine
has, and the collective bytes each iteration moves (port of
``scripts/scaling_eval.py``, with no bandwidth model and no anchor taken
from another machine: every number is measured or counted here).

    python -m tame_torch.scripts.scaling_eval [--device cuda|cpu]
        [--backend nccl|gloo] [--procs P] [--n 2000 --T 50 --r 4]
        [--iters 10] [--out scaling.json]

Spawns ``--procs`` processes (default: one per card, or 2 on the CPU);
each builds the north-star data (seed 0) on its device, moves it to host
memory and keeps only its rows.  :func:`~tame_torch.parallel.
measure_scaling_efficiency` then times a fixed-budget block fit (16
blocks, lr 0.8, ``--iters`` iterations, tolerance 0) on the first 1, 2,
4, ... ranks, and one iteration's collectives are counted on the mesh of
all of them.  Prints one JSON line; writes it to ``--out`` when given and
nowhere else.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from tame_torch.inference import cavi
from tame_torch.parallel import comm
from tame_torch.parallel.comm_analysis import count_iteration
from tame_torch.parallel.distributed import (
    measure_scaling_efficiency,
    spawn_world,
)
from tame_torch.parallel.mesh import make_mesh
from tame_torch.scripts import _common
from tame_torch.scripts.multihost_probe import add_world_flags, world_backend


def _counts(procs: int) -> list:
    out, c = [], 1
    while c < procs:
        out.append(c)
        c *= 2
    return out + [procs]


def _rank(rank: int, device: str, backend: str, n: int, T: int, r: int,
          iters: int, repeats: int) -> dict:
    mesh_kw = dict(device=device, backend=backend)
    mesh = make_mesh(nodes=comm.world_size(), **mesh_kw)
    cfg, params, Y = _common.north_star(mesh.device, n, T, r)
    Y = Y.cpu()   # every rank keeps only its rows on its device
    init = cavi.init_state(torch.Generator().manual_seed(1), n, T, cfg.d,
                           "full", 0.1, 0.5)

    def fit_fn(Y_s, init_s, mesh):
        cavi.fit_cavi(Y_s, params, init_s, update_mode="block",
                      num_blocks=16, learning_rate=0.8, max_iter=iters,
                      tolerance=0.0)

    scaling = measure_scaling_efficiency(
        fit_fn, Y, init, _counts(comm.world_size()), repeats=repeats,
        **mesh_kw)
    counted = count_iteration(mesh, n, T, r, num_blocks=16)
    return {"scaling": scaling, "collectives_per_iteration": counted,
            "device": str(mesh.device)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_world_flags(parser, procs=0)
    _common.size_flags(parser)
    parser.add_argument("--iters", type=int, default=10,
                        help="iterations of each timed fit")
    parser.add_argument("--repeats", type=int, default=2,
                        help="timed fits per rank count (best kept)")
    parser.add_argument("--out", default=None, help="write the JSON here")
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    backend = world_backend(args)
    procs = args.procs or (torch.cuda.device_count()
                           if device.type == "cuda" else 2)
    ranks = spawn_world(_rank, procs,
                        (args.device, backend, args.n, args.T, args.r,
                         args.iters, args.repeats),
                        backend=backend, timeout_s=1800.0)
    res = ranks[0]
    counted = res["collectives_per_iteration"]
    out = {"where": _common.describe(device), "backend": backend,
           "processes": procs, "devices": [r["device"] for r in ranks],
           "n": args.n, "T": args.T, "r": args.r, "iters": args.iters,
           "scaling": {str(k): dict(v, ms_per_iter=v["wall_s"] * 1e3
                                    / args.iters)
                       for k, v in res["scaling"].items()},
           "collectives_per_iteration": counted,
           "collective_bytes_per_iteration": sum(
               v["bytes"] for v in counted.values()),
           "observation_bytes": args.n * args.n * args.T * 2 * 4}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
