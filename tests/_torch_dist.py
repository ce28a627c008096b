"""Rank-side cases of ``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_masked.py`` and
``tests/test_torch_parallel_em.py``: one spawned gloo world on the CPU
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
import torch

from tame_torch.inference import (
    TemporalAMEHMC,
    TemporalAMENUTS,
    TemporalAMESMC,
    cavi,
    exact_elbo,
    fit_cavi_bernoulli,
    fit_cavi_poisson,
    fit_em,
    fit_smoothed_family,
    warm_init_smoothed_family,
)
from tame_torch.inference import em, smoothed
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
from tame_torch.parallel.comm_analysis import (
    count_em_iteration,
    count_iteration,
)
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


# -- the warm inits, the ELBOs, EM and the smoothed families ----------------

PHI_STRUCTURES = ("scalar", "blocks", "diag")
R_STRUCTURES = ("exchangeable", "diag")


def _torch(x):
    return None if x is None else torch.as_tensor(x)


def _fields(tree) -> dict:
    return {f: getattr(tree, f).cpu().numpy() for f in tree._fields}


def warm(nodes, time, Y, params, probe, mask=None, smoothed_state=False):
    """``warm_init_state`` (or ``warm_init_smoothed_state``) on a sharded
    ``Y``, gathered; the state's local rows."""
    mesh = _mesh(nodes, time)
    if not mesh.member:
        return None
    p, Y, m = params_from_numpy(params), torch.as_tensor(Y), _torch(mask)
    if smoothed_state:
        Y_s, _ = shard_smoothed_inputs(mesh, Y)
        out = smoothed.warm_init_smoothed_state(Y_s, p, obs_mask=m,
                                                probe=_torch(probe))
    else:
        Y_s, _ = shard_fit_inputs(mesh, Y)
        out = cavi.warm_init_state(Y_s, p, obs_mask=m, probe=_torch(probe))
    return dict(_fields(out.full()), local_rows=out.X_mean.shape[0])


def elbos(nodes, time, Y, params, state, mask=None):
    """``compute_elbo`` of a sharded CAVI state for every structure."""
    mesh = _mesh(nodes, time)
    if not mesh.member:
        return None
    p = params_from_numpy(params)
    Y_s, st = shard_fit_inputs(mesh, Y, cavi.state_from_numpy(state))
    pri = cavi.precompute_priors(p)
    return {s: float(cavi.compute_elbo(Y_s, p, pri, st, s,
                                       obs_mask=_torch(mask)))
            for s in ("diag", "full", "block")}


def em_parts(nodes, Y, params, state, mask=None):
    """One M-step for every phi and R structure, the exact ELBO and the
    smoothed ELBO of a sharded smoothed state."""
    mesh = _mesh(nodes)
    if not mesh.member:
        return None
    p, m = params_from_numpy(params), _torch(mask)
    Y_s, st = shard_smoothed_inputs(mesh, Y,
                                    smoothed.smoothed_state_from_numpy(state))
    out = {f"{ps}-{rs}": _fields(em.em_update_params(
        p, Y_s, st, mask=m, phi_structure=ps, r_structure=rs))
        for ps in PHI_STRUCTURES for rs in R_STRUCTURES}
    out["exact_elbo"] = float(exact_elbo(Y_s, p, st, mask=m))
    out["smoothed_elbo"] = float(smoothed.smoothed_elbo(
        Y_s, p, cavi.precompute_priors(p), st, obs_mask=m))
    return out


@contextlib.contextmanager
def counting_e_steps(tally: list):
    """Record the iterations of every E-step ``fit_em`` runs."""
    names = ("fit_cavi_smoothed", "fit_smoothed_family")
    inner = {name: getattr(em, name) for name in names}

    def counted(fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            tally.append(out.n_iter)
            return out
        return run

    for name in names:
        setattr(em, name, counted(inner[name]))
    try:
        yield
    finally:
        for name in names:
            setattr(em, name, inner[name])


def em_fit(nodes, Y, params, kw, init=None, mask=None):
    """``fit_em`` on a sharded network: its history, learned parameters,
    E-step stops and gathered means."""
    mesh = _mesh(nodes)
    if not mesh.member:
        return None
    Y_s, init_s = shard_smoothed_inputs(
        mesh, Y, None if init is None
        else smoothed.smoothed_state_from_numpy(init))
    tally = []
    mesh.comm.reset()
    with counting_e_steps(tally):
        res = fit_em(Y_s, params_from_numpy(params), init=init_s,
                     mask=_torch(mask), **kw)
    out = {"collectives": mesh.comm.stats(), "history": res.history,
           "params": _fields(res.params), "e_steps": tally,
           "X_mean": res.state.full().X_mean.numpy()}
    if kw.get("family", "gaussian") == "gaussian":
        n, _, T, _ = np.shape(Y)
        r = (res.params.Phi.shape[0] - 2) // 2
        out["counted"] = [count_em_iteration(
            mesh, n, T, r, k, masked=mask is not None)["em_iteration"]
            for k in tally]
    return out


def family_fit(nodes, Y, params, init, family, kw, mask=None):
    """``fit_smoothed_family`` on a sharded network from a whole init (or
    from ``warm_init_smoothed_family`` on the sharded ``Y`` when ``init``
    is None), gathered."""
    mesh = _mesh(nodes)
    if not mesh.member:
        return None
    p, m = params_from_numpy(params), _torch(mask)
    Y_s, init_s = shard_smoothed_inputs(
        mesh, Y, None if init is None
        else smoothed.smoothed_state_from_numpy(init))
    if init_s is None:
        init_s = warm_init_smoothed_family(Y_s, p, family, obs_mask=m)
    out = fit_smoothed_family(Y_s, p, init_s, family=family, mask=m, **kw)
    return dict(_fields(out.field("state").full()), elbo=_history(out),
                n_iter=out.n_iter, converged=out.converged)


def rank_weights(nodes, Y, init, params):
    """This rank's fit inputs for block phases of 4
    (``sharded_cavi.rank_inputs``): its time-major weights, their row sums
    and which of the network's rows they are."""
    from tame_torch.parallel import sharded_cavi

    mesh = _mesh(nodes)
    if not mesh.member:
        return None
    Y_s, _ = shard_fit_inputs(mesh, Y, cavi.state_from_numpy(init))
    n, T = Y.shape[0], Y.shape[2]
    geo = sharded_cavi.Geometry(mesh, n, T)
    fi = sharded_cavi.rank_inputs(
        Y_s, params_from_numpy(params).R_inv, None, geo,
        sharded_cavi.phases(n, "block", 4), mixed_precision=False,
        diag_mode="exact")
    rows = geo.rows
    return {"time_major": isinstance(fi.obs.W0, cavi.TimeMajorWeights),
            "W0": fi.obs.W0.tm.numpy(), "W1": fi.obs.W1.tm.numpy(),
            "eta_a": fi.obs.eta_a.numpy(),
            "rows": (rows.start, rows.stop, rows.step)}


CASES = {"fit": fit, "smoothed": smoothed_fit, "samplers": samplers,
         "meshes": meshes, "scaling": scaling, "bytes": iteration_bytes,
         "resume": poisson_resume, "warm": warm, "elbos": elbos,
         "em_parts": em_parts, "em_fit": em_fit, "family_fit": family_fit,
         "weights": rank_weights}
