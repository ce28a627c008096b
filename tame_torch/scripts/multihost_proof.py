"""Multi-process proof: a fit sharded over several processes equals the
same fit in one (port of ``scripts/multihost_proof.py``).

    python -m tame_torch.scripts.multihost_proof [--device cuda|cpu]
        [--backend nccl|gloo] [--procs 2] [--nodes P] [--time 1]
        [--out proof.json]

The golden fit runs in this process: the Good-SMF block fit (8 blocks, lr
1.0, 60 iterations, tolerance 0) at ``multihost_proof.py``'s shape, n=64,
T=16, r=1, on data and an init drawn from CPU generators seeded 11.  Then
``--procs`` spawned processes (a file store, no port) run the same fit
sharded over a ``nodes x time`` mesh of them; each checks its gathered
means against the golden ones (max |dX| < 5e-4) and its ELBO history
(relative error < 1e-5), then runs to the stopping rule (tolerance 5e-4,
at most 128 iterations), and every process must stop at the same
iteration.  Prints one JSON line; writes it to ``--out`` when given and
nowhere else.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from tame_torch.config import ModelConfig
from tame_torch.inference import cavi
from tame_torch.models import build_params, sample
from tame_torch.parallel.distributed import spawn_world
from tame_torch.parallel.mesh import make_mesh, shard_fit_inputs
from tame_torch.scripts import _common
from tame_torch.scripts.multihost_probe import add_world_flags, world_backend

N, T, R = 64, 16, 1
MAX_ITER = 60
FIT = dict(structure="full", update_mode="block", num_blocks=8,
           learning_rate=1.0)
MAX_DX, ELBO_REL = 5e-4, 1e-5


def problem():
    """Parameters, data and init, the same in every process."""
    params = build_params(ModelConfig(n_nodes=N, n_time=T, latent_dim=R,
                                      seed=11))
    Y, _ = sample(params, torch.Generator().manual_seed(11), N, T)
    init = cavi.init_state(torch.Generator().manual_seed(11), N, T, params.d,
                           "full", 0.1, 0.5)
    return params, Y, init


def _rank(rank: int, device: str, backend: str, nodes: int, time_axis: int,
          golden: dict) -> dict:
    mesh = make_mesh(nodes=nodes, time=time_axis, device=device,
                     backend=backend)
    params, Y, init = problem()
    params = params.to(mesh.device)
    Y_s, init_s = shard_fit_inputs(mesh, Y, init)
    out = cavi.fit_cavi(Y_s, params, init_s, max_iter=MAX_ITER,
                        tolerance=0.0, **FIT)
    X = out.full().X_mean.cpu().numpy()
    elbo = out.elbo_history[:MAX_ITER].numpy()
    conv = cavi.fit_cavi(Y_s, params, init_s, max_iter=128, tolerance=5e-4,
                         **FIT)
    return {"rank": rank, "device": str(mesh.device),
            "max_abs_dx": float(np.abs(X - golden["X_mean"]).max()),
            "elbo_rel_err": float(np.max(np.abs(elbo - golden["elbo"])
                                         / np.abs(golden["elbo"]))),
            "converged": conv.converged, "converged_iter": conv.n_iter,
            "collectives": mesh.comm.stats()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_world_flags(parser)
    parser.add_argument("--nodes", type=int, default=None,
                        help="ranks on the nodes axis (default: --procs / "
                             "--time)")
    parser.add_argument("--time", type=int, default=1,
                        help="ranks on the time axis")
    parser.add_argument("--out", default=None, help="write the JSON here")
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    backend = world_backend(args)
    nodes = args.nodes or args.procs // args.time
    params, Y, init = problem()
    gold = cavi.fit_cavi(Y.to(device), params.to(device),
                         cavi.CaviState(*(t.to(device) for t in init)),
                         max_iter=MAX_ITER, tolerance=0.0, fused=False,
                         **FIT)
    golden = {"X_mean": gold.X_mean.cpu().numpy(),
              "elbo": gold.elbo_history[:MAX_ITER].numpy()}
    ranks = spawn_world(_rank, args.procs,
                        (args.device, backend, nodes, args.time, golden),
                        backend=backend, timeout_s=600.0)
    out = {"processes": args.procs, "mesh": {"nodes": nodes,
                                             "time": args.time},
           "backend": backend, "where": _common.describe(device),
           "n": N, "T": T, "latent_dim": R, "iters": MAX_ITER,
           "max_abs_dx": max(r["max_abs_dx"] for r in ranks),
           "elbo_rel_err": max(r["elbo_rel_err"] for r in ranks),
           "converged_iter": [r["converged_iter"] for r in ranks],
           "collectives_rank0": ranks[0]["collectives"]}
    out["ok"] = (out["max_abs_dx"] < MAX_DX
                 and out["elbo_rel_err"] < ELBO_REL
                 and all(r["converged"] for r in ranks)
                 and len(set(out["converged_iter"])) == 1)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    _common.require(out["ok"], f"the sharded fit is not the golden one: "
                               f"{line}")
    return out


if __name__ == "__main__":
    main()
