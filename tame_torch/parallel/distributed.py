"""Starting ranks, meshes over all of them, and the scaling harnesses
(counterpart of :mod:`tame.parallel.distributed`).

JAX starts its processes with ``jax.distributed.initialize``; here that is
``torch.distributed``'s default process group, from explicit arguments or
from the variables ``torchrun`` sets.  Every rank runs the same program;
each holds its own pieces of the sharded tensors.  :func:`spawn_world`
starts a world of processes on one machine (the tests, the scripts and
``chip_smoke.py`` use it), rendezvousing on a file, not a port.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import torch

from tame_torch.parallel import comm
from tame_torch.parallel.mesh import make_mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Start the default process group.

    Explicit arguments (``host:port`` or a URL such as ``tcp://host:port``
    or ``file:///path``) are used as given; otherwise ``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK`` (as ``torchrun`` sets them) are read.  A
    plain single process does nothing.  The default group is NCCL when a
    card is present, gloo otherwise.  Returns True when the world has more
    than one rank (a group started earlier counts as it stands)."""
    if not comm.is_initialized():
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        if coordinator_address is not None:
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            comm.init_world(backend, int(process_id), int(num_processes),
                            init_method=url)
        elif all(k in os.environ
                 for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            comm.init_world(backend, int(os.environ["RANK"]),
                            int(os.environ["WORLD_SIZE"]),
                            init_method="env://")
    return comm.world_size() > 1


def global_mesh(nodes: Optional[int] = None, time_axis: int = 1,
                batch: int = 1, **kw):
    """Mesh over every rank of the world: by default all on ``nodes``."""
    total = comm.world_size()
    if nodes is None:
        nodes = total // (time_axis * batch)
    return make_mesh(nodes=nodes, time=time_axis, batch=batch, **kw)


def _timed(fit_fn, Y_s, init_s, mesh, repeats: int) -> float:
    fit_fn(Y_s, init_s, mesh)  # warm-up: kernel loads, allocator
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fit_fn(Y_s, init_s, mesh)
        best = min(best, time.perf_counter() - t0)
    return best


def _scaling(problem_fn, fit_fn, device_counts, repeats, mesh_kw):
    """``{count: wall seconds}``, each count on a mesh of the first
    ``count`` ranks; every rank receives rank 0's times."""
    from tame_torch.parallel.mesh import shard_fit_inputs

    world = global_mesh(**mesh_kw)
    walls = {}
    for count in device_counts:
        mesh = make_mesh(nodes=count, devices=range(count), **mesh_kw)
        wall = torch.zeros(())
        if mesh.member:
            Y, init = problem_fn(count)
            Y_s, init_s = shard_fit_inputs(mesh, Y, init)
            wall.fill_(_timed(fit_fn, Y_s, init_s, mesh, repeats))
        walls[count] = float(world.comm.broadcast(
            wall.to(world.device), "mesh"))
    return walls


def measure_scaling_efficiency(fit_fn, Y, init, device_counts,
                               repeats: int = 2, **mesh_kw) -> Dict[int, Dict]:
    """STRONG scaling: run ``fit_fn(Y_s, init_s, mesh)`` on the same
    problem over meshes of the first ``count`` ranks for each count and
    report wall time, speedup and parallel efficiency relative to the
    smallest mesh.  Every rank of the world calls it (the meshes are made
    together); ranks outside a mesh wait.  ``fit_fn`` must return after
    the fit is done (a sharded fit reads its ELBO back, so it is); with
    the smallest count N0, efficiency at N is ``(t_N0 N0) / (t_N N)``.
    ``mesh_kw`` (``device``, ``backend``) go to every mesh."""
    walls = _scaling(lambda count: (Y, init), fit_fn, device_counts,
                     repeats, mesh_kw)
    results: Dict[int, Dict] = {}
    base = None
    for count, wall in walls.items():
        if base is None:
            base = wall * count
        efficiency = base / (wall * count)
        results[count] = {"wall_s": wall, "speedup": efficiency * count,
                          "efficiency": efficiency}
    return results


def measure_weak_scaling(problem_fn, fit_fn, device_counts,
                         repeats: int = 2, **mesh_kw) -> Dict[int, Dict]:
    """WEAK scaling: ``problem_fn(count) -> (Y, init)`` grows the problem
    with the mesh; perfect weak scaling keeps the wall time flat, so the
    efficiency at N is ``t_N0 / t_N``."""
    walls = _scaling(problem_fn, fit_fn, device_counts, repeats, mesh_kw)
    base = next(iter(walls.values()))
    return {count: {"wall_s": wall, "efficiency": base / wall}
            for count, wall in walls.items()}


# ---------------------------------------------------------------------------
# A world of processes on one machine
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, nprocs: int, store_path: str, backend: str,
               timeout_s: float, args: tuple, results) -> None:
    torch.set_num_threads(1)
    try:
        comm.init_world(backend, rank, nprocs,
                        store=comm.file_store(store_path, nprocs),
                        timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, *args)
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        comm.destroy()


def spawn_world(fn: Callable, nprocs: int, args: Sequence = (), *,
                backend: str = "gloo", timeout_s: float = 600.0,
                store_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes that form
    one ``torch.distributed`` world (a ``FileStore`` under ``store_dir``,
    or a temporary directory) and return their results in rank order.
    ``fn`` and ``args`` must pickle (``fn`` by its import path); each
    process uses one CPU thread.  A rank that raises, or a world that
    outlives ``timeout_s``, raises ``RuntimeError`` here with the
    traceback, after every process has been stopped."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nprocs, store, backend, timeout_s,
                                   tuple(args), results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) + len(errors) < nprocs:
                left = deadline - time.monotonic()
                try:
                    rank, ok, out = results.get(timeout=min(max(left, 0.1),
                                                            1.0))
                except queue_mod.Empty:
                    codes = [p.exitcode for p in procs]
                    if left <= 0 or any(c not in (None, 0) for c in codes):
                        errors.append(f"world of {nprocs}: no result from "
                                      f"{nprocs - len(got)} rank(s); exit "
                                      f"codes {codes} (None: running after "
                                      f"{timeout_s} s)")
                        break
                    continue
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(nprocs)]
