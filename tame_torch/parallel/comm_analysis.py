"""Communication and compute profile of the sharded fit (counterpart of
:mod:`tame.parallel.comm_analysis`).

The JAX package reads its collectives out of the compiled HLO.  The port
has no compiled program: its collectives are explicit calls of the mesh's
:class:`~tame_torch.parallel.comm.Collectives`, which counts them as they
happen.  :func:`analyze_sharded_fit` therefore runs the sharded fit for
real, in a spawned gloo world of ``nodes x time`` processes on the CPU
with zero-valued data (the collectives do not depend on the values), and
takes one iteration's counts as a fit of two iterations' less a fit of
one's.  The operations and bytes of the iteration are counted from the
shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

_F32 = 4


def count_iteration(mesh, n: int, T: int, r: int, *,
                    structure: str = "full", update_mode: str = "block",
                    num_blocks: Optional[int] = None,
                    diag_mode: str = "exact", masked: bool = False,
                    mixed_precision: bool = False
                    ) -> Dict[str, Dict[str, int]]:
    """This rank's collectives (``{kind: {"count", "bytes"}}``) in one
    iteration of the sharded ``fit_cavi`` on ``mesh`` at (n, T, r), with
    every dyad observed under a mask when ``masked`` (the mask's counts
    are all-reduced before the loop, so they are not the iteration's)."""
    from tame_torch.config import ModelConfig
    from tame_torch.inference import cavi
    from tame_torch.models import build_params
    from tame_torch.parallel.mesh import shard_fit_inputs

    params = build_params(ModelConfig(n_nodes=n, n_time=T, latent_dim=r,
                                      seed=0))
    init = cavi.init_state(torch.Generator().manual_seed(0), n, T, params.d,
                           structure, 0.1, 0.5)
    Y = torch.zeros(()).expand(n, n, T, 2)   # sliced per rank, no copy
    mask = torch.ones(()).expand(n, n, T) if masked else None
    Y_s, init_s = shard_fit_inputs(mesh, Y, init)
    return _one_iteration(mesh, lambda iters: cavi.fit_cavi(
        Y_s, params, init_s, structure=structure, update_mode=update_mode,
        num_blocks=num_blocks, diag_mode=diag_mode,
        mixed_precision=mixed_precision, mask=mask, max_iter=iters,
        tolerance=0.0))


def _runs(mesh, fit):
    """The collectives of ``fit(1)`` and of ``fit(2)``."""
    stats = []
    for iters in (1, 2):
        mesh.comm.reset()
        fit(iters)
        stats.append(mesh.comm.stats())
    return stats


def _combine(*terms) -> Dict[str, Dict[str, int]]:
    """``sum_k c_k stats_k`` over ``(c_k, stats_k)`` pairs, by kind; kinds
    that come to no call are dropped."""
    out: Dict[str, Dict[str, int]] = {}
    for c, stats in terms:
        for k, v in stats.items():
            for f in ("count", "bytes"):
                out.setdefault(k, {"count": 0, "bytes": 0})[f] += c * v[f]
    return {k: v for k, v in out.items() if v["count"] > 0}


def _one_iteration(mesh, fit) -> Dict[str, Dict[str, int]]:
    """The collectives of one iteration: ``fit(2)``'s less ``fit(1)``'s."""
    one, two = _runs(mesh, fit)
    return _combine((1, two), (-1, one))


def count_em_iteration(mesh, n: int, T: int, r: int, inner: int, *,
                       masked: bool = False) -> Dict[str, Dict]:
    """This rank's collectives in one iteration of the sharded Gaussian
    ``fit_em`` on a ``nodes`` mesh at (n, T, r) whose E-step runs
    ``inner`` iterations: ``e_step_setup`` (the E-step's gather of its
    initial means; under a mask, its counts), ``e_step_iteration`` (its
    block phases' all-gathers and the ELBO's all-reduce), ``m_step`` (the
    means' all-gather, the corrections' column sums or, under a mask,
    covariance panels, one all-reduce of every sum) and ``em_iteration``:
    the setup, ``inner`` iterations and the M-step.  Counted on
    zero-valued data, as :func:`count_iteration` counts."""
    from tame_torch.config import ModelConfig
    from tame_torch.inference import em, smoothed
    from tame_torch.models import build_params
    from tame_torch.parallel.mesh import shard_smoothed_inputs

    params = build_params(ModelConfig(n_nodes=n, n_time=T, latent_dim=r,
                                      seed=0))
    init = smoothed.init_smoothed_state(torch.Generator().manual_seed(0), n,
                                        T, params.d)
    Y = torch.zeros(()).expand(n, n, T, 2)   # sliced per rank, no copy
    mask = torch.ones(()).expand(n, n, T) if masked else None
    Y_s, init_s = shard_smoothed_inputs(mesh, Y, init)
    one, two = _runs(mesh, lambda iters: smoothed.fit_cavi_smoothed(
        Y_s, params, init_s, mask=mask, max_iter=iters, tolerance=0.0))
    mesh.comm.reset()
    em.em_update_params(params, Y_s, init_s, mask=mask)
    m_step = mesh.comm.stats()
    step = _combine((1, two), (-1, one))
    setup = _combine((1, one), (-1, step))
    return {"e_step_setup": setup, "e_step_iteration": step,
            "m_step": m_step,
            "em_iteration": _combine((1, setup), (inner, step),
                                     (1, m_step))}


def _count_rank(rank: int, n: int, T: int, r: int, nodes: int,
                time_axis: int, kw: dict):
    from tame_torch.parallel.mesh import make_mesh

    mesh = make_mesh(nodes=nodes, time=time_axis, device="cpu")
    return count_iteration(mesh, n, T, r, **kw)


def iteration_cost(n: int, T: int, r: int, num_blocks: int) -> Dict:
    """Operations and bytes of one block (or Jacobi, ``num_blocks=1``)
    iteration over the whole mesh, counted from the shapes:

    * ``flops``: the two weight contractions ``W0 V`` and ``W1 U`` (2 x 2
      n^2 T r), the residual pass's two predictor products (2 x 2 n^2 T r)
      and its ~8 elementwise operations per dyad-time, the partner Grams
      of every block phase (3 x 2 n T r^2 each), and the n T solves with
      inverse and log-determinants (~2.3 d^3 + d^3 / 3 each);
    * ``bytes_accessed``: W0 and W1 read once, ``Y`` read once by the
      residual pass, the means read and written once per block phase and
      the covariances once per iteration (float32)."""
    d = 2 + 2 * r
    flops = (4 * n * n * T * r + 4 * n * n * T * r + 8 * n * n * T
             + num_blocks * 6 * n * T * r * r
             + n * T * (2.3 * d ** 3 + d ** 3 / 3))
    nbytes = _F32 * (2 * n * n * T + 2 * n * n * T
                     + 2 * num_blocks * n * T * d + 2 * n * T * d * d)
    return {"flops": float(flops), "bytes_accessed": float(nbytes)}


def analyze_sharded_fit(n: int, T: int, r: int, *, nodes: int = 1,
                        time_axis: int = 1, structure: str = "full",
                        update_mode: str = "block",
                        num_blocks: Optional[int] = None,
                        diag_mode: str = "exact") -> Dict:
    """One CAVI iteration sharded over a ``nodes x time`` mesh: its
    collectives and its compute, as the keys of the JAX function.

    ``collectives`` (per-kind count and bytes) and ``collective_bytes``
    are one rank's, counted in one iteration of the sharded fit run in a
    spawned gloo world on the CPU (see the module docstring; the JAX
    function counts the per-device program's collectives the same way).
    ``flops`` and ``bytes_accessed`` are one iteration's over the whole
    mesh, counted from the shapes (:func:`iteration_cost`), not measured;
    the JAX function reports XLA's cost analysis of the whole fit."""
    from tame_torch.parallel.distributed import spawn_world

    if num_blocks is None:
        num_blocks = next(k for k in range(min(16, n), 0, -1)
                          if n % k == 0)
    kw = dict(structure=structure, update_mode=update_mode,
              num_blocks=num_blocks, diag_mode=diag_mode)
    stats = spawn_world(_count_rank, nodes * time_axis,
                        (n, T, r, nodes, time_axis, kw))[0]
    phases = num_blocks if update_mode == "block" else 1
    return {
        "n": n, "T": T, "r": r, "nodes": nodes, "time": time_axis,
        "num_blocks": num_blocks, "structure": structure,
        "update_mode": update_mode,
        "collectives": stats,
        "collective_bytes": sum(v["bytes"] for v in stats.values()),
        **iteration_cost(n, T, r, phases),
    }


def layout_bytes(n: int, T: int, r: int, nodes: int, time_axis: int,
                 phases: int) -> int:
    """The bytes one rank's collectives move in one iteration, from the
    layout: per phase an all-gather of ``nodes x time`` padded pieces of
    ``ceil(n / phases / nodes) x ceil(T / time) x d`` means, and one
    all-reduce of the ELBO's 6 sums."""
    d = 2 + 2 * r
    piece = (math.ceil(n // phases / nodes) * math.ceil(T / time_axis) * d)
    return _F32 * (phases * nodes * time_axis * piece + 6)
