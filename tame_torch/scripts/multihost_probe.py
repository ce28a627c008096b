"""Probe: do several processes of this machine form one
``torch.distributed`` world whose collectives work on the chosen device
(port of ``scripts/multihost_probe.py``)?

    python -m tame_torch.scripts.multihost_probe [--device cuda|cpu]
        [--backend nccl|gloo] [--procs 2]

Spawns ``--procs`` processes on a file store; each holds its rows (``i %
procs``) of the values 0..15 on its device, and one all-reduce over a
mesh of all of them must give their sum, 120.  On the card, NCCL needs a
card per process; ``--backend gloo`` lets the processes share one card
(staged through host memory).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from tame_torch.parallel import comm
from tame_torch.parallel.distributed import spawn_world
from tame_torch.parallel.mesh import make_mesh
from tame_torch.scripts import _common


def _rank(rank: int, device: str, backend: str) -> dict:
    mesh = make_mesh(nodes=comm.world_size(), device=device,
                     backend=backend)
    mine = torch.arange(16.0, device=mesh.device)[mesh.piece("nodes", 16)]
    total = float(mesh.comm.all_reduce(mine.sum(), "mesh"))
    return {"rank": rank, "device": str(mesh.device), "sum": total}


def add_world_flags(parser: argparse.ArgumentParser, procs: int = 2) -> None:
    _common.add_device_flag(parser)
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="collectives (default: nccl on the card, gloo "
                             "on the CPU; gloo lets ranks share a card)")
    parser.add_argument("--procs", type=int, default=procs,
                        help="processes to spawn")


def world_backend(args) -> str:
    return args.backend or ("nccl" if args.device == "cuda" else "gloo")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_world_flags(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    backend = world_backend(args)
    ranks = spawn_world(_rank, args.procs, (args.device, backend),
                        backend=backend, timeout_s=300.0)
    out = {"processes": args.procs, "backend": backend,
           "where": _common.describe(device),
           "sums": [r["sum"] for r in ranks],
           "devices": [r["device"] for r in ranks]}
    out["ok"] = all(s == 120.0 for s in out["sums"])
    print(json.dumps(out), flush=True)
    _common.require(out["ok"], f"all-reduce over 16 values gave "
                               f"{out['sums']}, not 120")
    return out


if __name__ == "__main__":
    main()
