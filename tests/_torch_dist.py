"""Rank-side cases of ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_masked.py``: one spawned gloo world on the CPU
per file runs them all, each rank calling every case in order (a mesh is
made by every rank of the world; its members run the fit).

This module imports only torch, numpy and tame_torch, so that the spawned
children never import JAX.  Inputs arrive as numpy arrays; results go back
as numpy arrays and plain numbers.  A case with ``packed=True`` runs with
``TAME_PACKED_MASK=1`` (masked contractions through K5's twin) in the
rank's environment.
"""

import contextlib
import os

import numpy as np

from tame_torch.inference import (
    TemporalAMEHMC,
    TemporalAMENUTS,
    TemporalAMESMC,
    cavi,
    fit_cavi_bernoulli,
    fit_cavi_poisson,
)
from tame_torch.inference import smoothed
from tame_torch.models import TemporalAMEModel, params_from_numpy
from tame_torch.parallel import (
    auto_mesh,
    global_mesh,
    make_mesh,
    measure_scaling_efficiency,
    measure_weak_scaling,
    shard_fit_inputs,
    shard_smoothed_inputs,
)
from tame_torch.parallel.comm_analysis import count_iteration
from tame_torch.parallel.distributed import spawn_world


def run_world(nprocs: int, cases: list, store_dir) -> list:
    """Every rank's ``{case name: result}`` (None where the rank lies
    outside the case's mesh), in rank order."""
    return spawn_world(_worker, nprocs, (cases,), store_dir=str(store_dir),
                       timeout_s=240.0)


def _worker(rank: int, cases: list) -> dict:
    return {name: CASES[kind](**kw) for name, kind, kw in cases}


def _mesh(nodes=1, time=1, batch=1):
    return make_mesh(nodes=nodes, time=time, batch=batch,
                     devices=range(nodes * time * batch), device="cpu")


def _history(out, key="elbo_history"):
    return getattr(out, key)[:out.n_iter].numpy()


@contextlib.contextmanager
def _packed(on: bool):
    """``TAME_PACKED_MASK=1`` inside the block when ``on``."""
    if on:
        os.environ["TAME_PACKED_MASK"] = "1"
    try:
        yield
    finally:
        os.environ.pop("TAME_PACKED_MASK", None)


def fit(nodes, time, Y, init, params, kw, family="gaussian", packed=False):
    """A sharded CAVI, Bernoulli or Poisson fit; the gathered means and
    covariances, the ELBO history and the stop."""
    mesh = _mesh(nodes, time)
    if not mesh.member:
        return None
    fn = {"gaussian": cavi.fit_cavi, "bernoulli": fit_cavi_bernoulli,
          "poisson": fit_cavi_poisson}[family]
    Y_s, init_s = shard_fit_inputs(mesh, Y, cavi.state_from_numpy(init))
    with _packed(packed):
        out = fn(Y_s, params_from_numpy(params), init_s, **kw)
    full = out.full()
    return {"X_mean": full.X_mean.numpy(), "X_cov": full.X_cov.numpy(),
            "elbo": _history(out), "n_iter": out.n_iter,
            "converged": out.converged,
            "local_rows": out.X_mean.shape[0]}


def smoothed_fit(nodes, Y, init, params, kw, packed=False):
    mesh, timed = _mesh(nodes), _mesh(2, 2)
    if not mesh.member:
        return None
    state = smoothed.smoothed_state_from_numpy(init)
    Y_s, init_s = shard_smoothed_inputs(mesh, Y, state)
    with _packed(packed):
        out = smoothed.fit_cavi_smoothed(Y_s, params_from_numpy(params),
                                         init_s, **kw)
    full = out.full()
    try:
        shard_smoothed_inputs(timed, Y, state)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"X_mean": full.state.X_mean.numpy(),
            "logdets": full.state.logdets.numpy(), "elbo": _history(out),
            "n_iter": out.n_iter, "refused": refused}


def poisson_resume(nodes, time, Y, init, params, kw, total, first):
    """A sharded Poisson fit of ``total`` iterations in one shot, and the
    same fit stopped after ``first`` and resumed from the stopped fit's
    state and ``resume_carry()``."""
    mesh = _mesh(nodes, time)
    if not mesh.member:
        return None
    p = params_from_numpy(params)
    Y_s, init_s = shard_fit_inputs(mesh, Y, cavi.state_from_numpy(init))
    one = fit_cavi_poisson(Y_s, p, init_s, max_iter=total, **kw)
    head = fit_cavi_poisson(Y_s, p, init_s, max_iter=first, **kw)
    _, mid = shard_fit_inputs(mesh, Y, head.full())
    tail = fit_cavi_poisson(Y_s, p, mid, max_iter=total - first,
                            carry=head.resume_carry(), **kw)
    return {"one": one.full().X_mean.numpy(), "one_elbo": _history(one),
            "resumed": tail.full().X_mean.numpy(),
            "resumed_elbo": np.concatenate([_history(head), _history(tail)]),
            "n_iter": head.n_iter + tail.n_iter}


def samplers(batch):
    """HMC, NUTS and SMC with their chains over the batch axis, beside the
    same samplers unsharded on this rank (test_parallel.py's settings)."""
    mesh = _mesh(batch=batch)
    if not mesh.member:
        return None
    model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1, seed=7,
                             device="cpu")
    model.generate_data()
    out = {}
    hmc = TemporalAMEHMC(model, num_chains=64, num_leapfrog=5, seed=3,
                         precondition=False)
    sh = hmc.sample(num_warmup=15, num_samples=15, mesh=mesh)
    out["hmc_local"] = sh.positions.shape[0]
    out["hmc"] = sh.full().positions.numpy()
    out["hmc_ref"] = hmc.sample(num_warmup=15, num_samples=15).positions\
        .numpy()
    nuts = TemporalAMENUTS(model, num_chains=8, max_depth=4, seed=3,
                           precondition=False)
    out["nuts"] = nuts.sample(num_warmup=10, num_samples=10,
                              mesh=mesh).full().positions.numpy()
    out["nuts_ref"] = nuts.sample(num_warmup=10,
                                  num_samples=10).positions.numpy()
    smc = TemporalAMESMC(model, num_particles=64, num_stages=5, num_moves=1,
                         seed=3, precondition=False)
    res, ref = smc.sample(mesh=mesh), smc.sample()
    out["smc_local"] = res.particles.shape[0]
    out["smc"] = res.full().particles.numpy()
    out["smc_ref"] = ref.particles.numpy()
    out["evidence"] = float(res.log_evidence)
    out["evidence_ref"] = float(ref.log_evidence)
    return out


def meshes():
    """Mesh shapes and the errors a world of 8 gives."""
    out = {"global": dict(global_mesh(device="cpu").shape),
           "auto": dict(auto_mesh(device="cpu").shape),
           "auto4": dict(auto_mesh(4, device="cpu").shape),
           "auto2": dict(auto_mesh(2, device="cpu").shape),
           "batch": dict(_mesh(2, 2, 2).shape)}
    try:
        make_mesh(nodes=16, device="cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    return out


def scaling(Y, init, params, kw):
    """Both harnesses at 1 and 2 ranks."""
    p = params_from_numpy(params)
    state = cavi.state_from_numpy(init)

    def fit_fn(Y_s, init_s, mesh):
        cavi.fit_cavi(Y_s, p, init_s, **kw)

    strong = measure_scaling_efficiency(fit_fn, Y, state, [1, 2],
                                        repeats=1, device="cpu")
    weak = measure_weak_scaling(lambda count: (Y, state), fit_fn, [1, 2],
                                repeats=1, device="cpu")
    return {"strong": strong, "weak": weak}


def iteration_bytes(nodes, time, n, T, r, num_blocks, **options):
    mesh = _mesh(nodes, time)
    if not mesh.member:
        return None
    return count_iteration(mesh, n, T, r, num_blocks=num_blocks, **options)


CASES = {"fit": fit, "smoothed": smoothed_fit, "samplers": samplers,
         "meshes": meshes, "scaling": scaling, "bytes": iteration_bytes,
         "resume": poisson_resume}
