"""Port parity for the sharded warm inits, ELBOs, EM and smoothed families:
``tame_torch``'s entry points on a network sharded over ranks of
``torch.distributed`` against the port's unsharded functions and
``tame``'s (JAX, CPU) on the same numpy inputs.

The sharded runs happen in one spawned gloo world of 4 CPU processes,
started once for the file on a FileStore under ``tmp_path``; the
rank-side cases live in ``tests/_torch_dist.py``, which imports no JAX.
Meshes of 2 x 1 and 4 x 1 ranks (and 2 x 2 for ``warm_init_state``, the
one entry point here that splits time), masked and unmasked.  The
comparisons are of identified quantities (TESTING.md): dyadic means, the
ELBOs, the learned scalars and parameters, the stops, never raw latents.
One rank holds each function to the plain one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame
from tame.config import ModelConfig
from tame.inference import cavi as jcavi
from tame.inference import em as jem
from tame.inference import family_smoothed as jfs
from tame.inference import smoothed as jsm
from tame.inference.evidence import exact_elbo as j_exact_elbo
from tame.models import TemporalAMEModel as JModel
from tame.models import build_params as j_build_params
from tame.models import sample as j_sample
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import em as tem
from tame_torch.inference import (
    exact_elbo,
    fit_em,
    fit_smoothed_family,
    warm_init_smoothed_family,
)
from tame_torch.inference import smoothed as tsm
from tame_torch.inference.binary_cavi import family_inputs
from tame_torch.models import params_from_numpy
from tame_torch.parallel import comm, make_mesh, shard_fit_inputs
from tame_torch.parallel import shard_smoothed_inputs

from _torch_dist import (
    PHI_STRUCTURES,
    R_STRUCTURES,
    counting_e_steps,
    run_world,
)

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
MISSING = 0.3
N, T, R = 16, 6, 2
# E-steps that stop by their tolerance, not at the cap (14, 12 and 12
# iterations from tame's warm init, unmasked; 14, 10 and 12 masked).  At
# a finer tolerance the stop is a rounding decision: near -640 a float32
# ELBO moves in steps of 9.5e-8 relative, and at 1e-5 (stops 44, 25, 31)
# the masked third E-step's deciding change was 1.0096e-5, one step above
# the tolerance, so the sharded fits' ELBO, an ulp away, stopped at 30
# (measured).
EM_KW = dict(n_em=3, inner_max_iter=150, learning_rate=0.8,
             inner_tolerance=1e-4)
FAMILY_KW = dict(max_iter=15, learning_rate=0.7, tolerance=0.0)
FAMILY_EM_KW = dict(n_em=2, inner_max_iter=30, learning_rate=0.7,
                    inner_tolerance=0.0)
MESHES = {"2x1": (2, 1), "4x1": (4, 1)}


def _np(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def _mask(n, T, seed):
    """A symmetric zero-diagonal float32 mask, 30 % of the dyads hidden."""
    rng = np.random.default_rng(seed)
    keep = ((rng.random((n, n, T)) > MISSING)
            * np.triu(np.ones((n, n)), k=1)[:, :, None])
    return (keep + keep.transpose(1, 0, 2)).astype(np.float32)


def _solved(Y, p0, mask):
    """``tame``'s warm init and 10 smoothed iterations from it."""
    jm = None if mask is None else jnp.asarray(mask)
    init = jsm.warm_init_smoothed_state(jnp.asarray(Y), p0, obs_mask=jm)
    return _np(init), _np(jsm.fit_cavi_smoothed(
        jnp.asarray(Y), p0, init, max_iter=10, tolerance=0.0,
        mask=jm).state)


@pytest.fixture(scope="module")
def problems():
    """The Gaussian network (truth phi 0.8, rho 0.5, sigma^2 0.1), a wrong
    EM start (phi 0.3, rho 0, sigma^2 1), solved smoothed states from it,
    ``tame``'s warm-init probe; Bernoulli and Poisson networks."""
    model = JModel(n_nodes=N, n_time=T, latent_dim=R, seed=5,
                   ar_coefficient=0.8, rho_dyadic=0.5)
    Y = np.asarray(model.generate_data())
    p0 = j_build_params(ModelConfig(n_nodes=N, n_time=T, latent_dim=R,
                                    ar_coefficient=0.3, rho_dyadic=0.0,
                                    dyadic_variance=1.0))
    mask = _mask(N, T, 5)
    out = {"Y": Y, "truth": _np(model.params), "p0": _np(p0), "mask": mask,
           "probe": np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                 (N, R), jnp.float32)),
           "cavi": _np(jcavi.init_state(jax.random.PRNGKey(1), N, T,
                                        model.d, "full", 0.1, 0.5))}
    for key, m in (("dense", None), ("masked", mask)):
        out[f"init-{key}"], out[f"solved-{key}"] = _solved(Y, p0, m)
    fp = j_build_params(ModelConfig(n_nodes=N, n_time=T, latent_dim=1,
                                    seed=0))
    out["family_params"] = _np(fp)
    for fam in ("bernoulli", "poisson"):
        Yf, _ = j_sample(fp, jax.random.PRNGKey(2), N, T, family=fam)
        out[fam] = np.asarray(Yf)
        for key, m in (("dense", None), ("masked", mask)):
            out[f"{fam}-init-{key}"] = _np(jfs.warm_init_smoothed_family(
                jnp.asarray(Yf), fp, fam,
                obs_mask=None if m is None else jnp.asarray(m)))
    return out


def _masked(key):
    return key == "masked"


WARM = {f"{kind}-{mesh}-{key}": (kind, nt, key)
        for kind, meshes in (("cavi", {**MESHES, "2x2": (2, 2)}),
                             ("smoothed", MESHES))
        for mesh, nt in meshes.items() for key in ("dense", "masked")}
ELBOS = {f"{mesh}-{key}": (nt, key)
         for mesh, nt in {"2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1)}.items()
         for key in ("dense", "masked")}
PARTS = {f"{mesh}-{key}": (nt[0], key) for mesh, nt in MESHES.items()
         for key in ("dense", "masked")}
EM_FITS = {f"{mesh}-{key}": (nt[0], key) for mesh, nt in MESHES.items()
           for key in ("dense", "masked")}
# name -> (family, nodes, mask key, from the sharded warm init)
FAMILY = {"bernoulli-2x1": ("bernoulli", 2, "dense", False),
          "bernoulli-4x1": ("bernoulli", 4, "dense", False),
          "poisson-4x1-masked": ("poisson", 4, "masked", False),
          "bernoulli-2x1-warm": ("bernoulli", 2, "dense", True),
          "poisson-4x1-masked-warm": ("poisson", 4, "masked", True)}
FAMILY_EM = {"bernoulli-2x1": ("bernoulli", 2, "dense"),
             "poisson-4x1-masked": ("poisson", 4, "masked")}


@pytest.fixture(scope="module")
def world(problems, tmp_path_factory):
    """Every case run once in one world of 4 ranks: rank-ordered results."""
    P = problems
    cases = []
    for name, (kind, (a, b), key) in WARM.items():
        cases.append((f"warm-{name}", "warm", dict(
            nodes=a, time=b, Y=P["Y"], params=P["p0"], probe=P["probe"],
            mask=P["mask"] if _masked(key) else None,
            smoothed_state=kind == "smoothed")))
    for name, ((a, b), key) in ELBOS.items():
        cases.append((f"elbos-{name}", "elbos", dict(
            nodes=a, time=b, Y=P["Y"], params=P["p0"], state=P["cavi"],
            mask=P["mask"] if _masked(key) else None)))
    for name, (a, key) in PARTS.items():
        cases.append((f"parts-{name}", "em_parts", dict(
            nodes=a, Y=P["Y"], params=P["p0"], state=P[f"solved-{key}"],
            mask=P["mask"] if _masked(key) else None)))
    for name, (a, key) in EM_FITS.items():
        cases.append((f"em-{name}", "em_fit", dict(
            nodes=a, Y=P["Y"], params=P["p0"], kw=EM_KW,
            init=P[f"init-{key}"],
            mask=P["mask"] if _masked(key) else None)))
    for name, (fam, a, key, warm) in FAMILY.items():
        cases.append((f"family-{name}", "family_fit", dict(
            nodes=a, Y=P[fam], params=P["family_params"],
            init=None if warm else P[f"{fam}-init-{key}"], family=fam,
            kw=FAMILY_KW, mask=P["mask"] if _masked(key) else None)))
    for name, (fam, a, key) in FAMILY_EM.items():
        cases.append((f"family-em-{name}", "em_fit", dict(
            nodes=a, Y=P[fam], params=P["family_params"],
            kw=dict(FAMILY_EM_KW, family=fam), init=P[f"{fam}-init-{key}"],
            mask=P["mask"] if _masked(key) else None)))
    return run_world(4, cases, tmp_path_factory.mktemp("em_world"))


def _members(world, name, size):
    got = [r[name] for r in world if r[name] is not None]
    assert len(got) == size
    return got


def _fwd(X, r):
    """Dyadic forward means ``a_i + b_j + U_i . V_j`` (n, n, T)."""
    X = np.asarray(X)
    return (X[:, None, :, 0] + X[None, :, :, 1]
            + np.einsum("itr,jtr->ijt", X[..., 2:2 + r], X[..., 2 + r:]))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


def _port(P, key):
    Y, mask = torch.from_numpy(P["Y"]), P["mask"] if _masked(key) else None
    return Y, None if mask is None else torch.from_numpy(mask)


def _j_mask(P, key):
    return jnp.asarray(P["mask"]) if _masked(key) else None


# -- the warm inits -----------------------------------------------------------

@pytest.mark.parametrize("name", list(WARM))
def test_sharded_warm_init_matches_port_and_tame(world, problems, name):
    """Every rank gathers the same state; its dyadic means (the U/V frame
    is a QR's) within 1e-4 of the port's and ``tame``'s, its covariances
    equal to theirs."""
    kind, (a, b), key = WARM[name]
    P = problems
    members = _members(world, f"warm-{name}", a * b)
    Y, mask = _port(P, key)
    p0, probe = params_from_numpy(P["p0"]), torch.from_numpy(P["probe"])
    if kind == "cavi":
        port = tcavi.warm_init_state(Y, p0, obs_mask=mask, probe=probe)
        ref = jcavi.warm_init_state(jnp.asarray(P["Y"]), tame.models.params
                                    .AMEParams(**P["p0"]),
                                    obs_mask=_j_mask(P, key))
    else:
        port = tsm.warm_init_smoothed_state(Y, p0, obs_mask=mask,
                                            probe=probe)
        ref = jsm.warm_init_smoothed_state(jnp.asarray(P["Y"]),
                                           tame.models.params.AMEParams(
                                               **P["p0"]),
                                           obs_mask=_j_mask(P, key))
    got = members[0]
    assert all(np.array_equal(m["X_mean"], got["X_mean"]) for m in members)
    assert sorted(m["local_rows"] for m in members) == sorted(
        len(range(k, N, a)) for k in range(a) for _ in range(b))
    for want in (port, ref):
        _close(_fwd(got["X_mean"], R), _fwd(want.X_mean, R))
        for f, v in _np(want).items():
            if f != "X_mean":
                np.testing.assert_array_equal(got[f], v)


# -- the ELBOs and the M-step's moments ----------------------------------------

@pytest.mark.parametrize("name", list(ELBOS))
def test_sharded_compute_elbo_matches_port_and_tame(world, problems, name):
    (a, b), key = ELBOS[name]
    P = problems
    members = _members(world, f"elbos-{name}", a * b)
    Y, mask = _port(P, key)
    p = params_from_numpy(P["p0"])
    jp = tame.models.params.AMEParams(**P["p0"])
    for s in ("diag", "full", "block"):
        port = tcavi.compute_elbo(Y, p, tcavi.precompute_priors(p),
                                  tcavi.state_from_numpy(P["cavi"]), s,
                                  obs_mask=mask)
        ref = jcavi.compute_elbo(jnp.asarray(P["Y"]), jp,
                                 jcavi.precompute_priors(jp),
                                 jcavi.CaviState(**P["cavi"]), s,
                                 obs_mask=_j_mask(P, key))
        assert len({m[s] for m in members}) == 1
        _close(members[0][s], float(port), atol=0.0)
        _close(members[0][s], float(ref), atol=0.0)


@pytest.mark.parametrize("name", list(PARTS))
def test_sharded_m_step_and_elbos_match_port_and_tame(world, problems,
                                                      name):
    """One M-step for every phi and R structure, the exact ELBO and the
    smoothed ELBO of one solved state: every rank the same parameters,
    each within 1e-4 of the port's and ``tame``'s."""
    a, key = PARTS[name]
    P = problems
    members = _members(world, f"parts-{name}", a)
    Y, mask = _port(P, key)
    jY, jm = jnp.asarray(P["Y"]), _j_mask(P, key)
    p, jp = params_from_numpy(P["p0"]), tame.models.params.AMEParams(
        **P["p0"])
    state = tsm.smoothed_state_from_numpy(P[f"solved-{key}"])
    jstate = jsm.SmoothedState(**P[f"solved-{key}"])
    gated = None if mask is None else tcavi.gated_mask(mask, Y)
    got = members[0]
    for ps in PHI_STRUCTURES:
        for rs in R_STRUCTURES:
            kw = dict(phi_structure=ps, r_structure=rs)
            port = tem.em_update_params(p, Y, state, mask=gated, **kw)
            ref = jem.em_update_params(jp, jY, jstate, mask=jm, **kw)
            for m in members:
                for f in port._fields:
                    np.testing.assert_array_equal(m[f"{ps}-{rs}"][f],
                                                  got[f"{ps}-{rs}"][f])
            for want in (_np(port), _np(ref)):
                for f, v in want.items():
                    _close(got[f"{ps}-{rs}"][f], v)
    _close(got["exact_elbo"], float(exact_elbo(Y, p, state, mask=mask)),
           atol=0.0)
    _close(got["exact_elbo"], float(j_exact_elbo(jY, jp, jstate, mask=jm)),
           atol=0.0)
    pri, jpri = tcavi.precompute_priors(p), jcavi.precompute_priors(jp)
    _close(got["smoothed_elbo"], float(tsm.smoothed_elbo(
        Y, p, pri, state, obs_mask=mask)), atol=0.0)
    _close(got["smoothed_elbo"], float(jsm.smoothed_elbo(
        jY, jp, jpri, jstate, obs_mask=jm)), atol=0.0)
    assert len({m["exact_elbo"] for m in members}) == 1


# -- EM and the smoothed families ----------------------------------------------

def _port_em(Y, params, mask, init, kw):
    tally = []
    with counting_e_steps(tally):
        res = fit_em(Y, params, mask=mask, init=init, **kw)
    return res, tally


@pytest.mark.parametrize("name", list(EM_FITS))
def test_sharded_gaussian_em_matches_port_and_tame(world, problems, name):
    """Three EM iterations from ``tame``'s warm init: the same E-step stops
    and EM iterations as the port's, the learned scalars and ELBOs within
    1e-4 of the port's and ``tame``'s, the same on every rank."""
    a, key = EM_FITS[name]
    P = problems
    members = _members(world, f"em-{name}", a)
    Y, mask = _port(P, key)
    port, stops = _port_em(Y, params_from_numpy(P["p0"]), mask,
                           tsm.smoothed_state_from_numpy(P[f"init-{key}"]),
                           EM_KW)
    ref = jem.fit_em(jnp.asarray(P["Y"]), tame.models.params.AMEParams(
        **P["p0"]), init=jsm.SmoothedState(**P[f"init-{key}"]),
        mask=_j_mask(P, key), **EM_KW)
    got = members[0]
    assert all(m["history"] == got["history"] for m in members)
    assert got["e_steps"] == stops
    assert len(got["history"]["elbo"]) == len(ref.history["elbo"]) == 3
    for want in (port.history, ref.history):
        for k, v in want.items():
            _close(got["history"][k], v, atol=0.0)
    _close(_fwd(got["X_mean"], R), _fwd(port.state.X_mean, R))
    assert abs(got["history"]["phi"][-1] - 0.8) < abs(0.3 - 0.8)
    # every collective of the three EM iterations is one that
    # comm_analysis.count_em_iteration counts for its E-step's stop
    for m in members:
        kinds = set(m["collectives"]).union(*m["counted"])
        assert m["collectives"] == {
            k: {f: sum(c.get(k, {}).get(f, 0) for c in m["counted"])
                for f in ("count", "bytes")} for k in kinds}


def _family_refs(P, fam, key, warm):
    Y = torch.from_numpy(P[fam])
    mask = torch.from_numpy(P["mask"]) if _masked(key) else None
    p = params_from_numpy(P["family_params"])
    if warm:
        init = warm_init_smoothed_family(Y, p, fam, obs_mask=mask)
        return fit_smoothed_family(Y, p, init, family=fam, mask=mask,
                                   **FAMILY_KW), None
    init = tsm.smoothed_state_from_numpy(P[f"{fam}-init-{key}"])
    port = fit_smoothed_family(Y, p, init, family=fam, mask=mask,
                               **FAMILY_KW)
    ref = jfs.fit_smoothed_family(
        jnp.asarray(P[fam]), tame.models.params.AMEParams(
            **P["family_params"]),
        jsm.SmoothedState(**P[f"{fam}-init-{key}"]), family=fam,
        mask=_j_mask(P, key), **FAMILY_KW)
    return port, ref


@pytest.mark.parametrize("name", list(FAMILY))
def test_sharded_smoothed_family_matches_port_and_tame(world, problems,
                                                       name):
    """The guarded loop on every rank at once: the same accepted and
    rejected steps as the port's (and ``tame``'s from its warm init), the
    objective within 1e-4 at every iteration, the dyadic means within
    1e-4.  From the sharded warm init, against the port's from its own."""
    fam, a, key, warm = FAMILY[name]
    members = _members(world, f"family-{name}", a)
    port, ref = _family_refs(problems, fam, key, warm)
    got = members[0]
    assert all(np.array_equal(m["elbo"], got["elbo"]) for m in members)
    assert got["n_iter"] == port.n_iter == FAMILY_KW["max_iter"]
    wants = [(port.elbo_history[:port.n_iter].numpy(), port.state)]
    if ref is not None:
        wants.append((np.asarray(ref.elbo_history)[:int(ref.n_iter)],
                      ref.state))
    for elbo, state in wants:
        np.testing.assert_array_equal(np.diff(got["elbo"]) == 0,
                                      np.diff(elbo) == 0)
        _close(got["elbo"], elbo, atol=0.0)
        m_ref = _fwd(state.X_mean, 1)
        assert np.abs(_fwd(got["X_mean"], 1) - m_ref).max() <= ATOL * max(
            1.0, np.abs(m_ref).max())


@pytest.mark.parametrize("name", list(FAMILY_EM))
def test_sharded_family_em_matches_port_and_tame(world, problems, name):
    """``fit_em(family=)`` sharded: the learned phi, tr Q and tr Sigma0
    within 1e-4 of the port's and ``tame``'s, R held."""
    fam, a, key = FAMILY_EM[name]
    P = problems
    members = _members(world, f"family-em-{name}", a)
    Y = torch.from_numpy(P[fam])
    mask = torch.from_numpy(P["mask"]) if _masked(key) else None
    port, stops = _port_em(Y, params_from_numpy(P["family_params"]), mask,
                           tsm.smoothed_state_from_numpy(
                               P[f"{fam}-init-{key}"]),
                           dict(FAMILY_EM_KW, family=fam))
    ref = jem.fit_em(jnp.asarray(P[fam]), tame.models.params.AMEParams(
        **P["family_params"]), init=jsm.SmoothedState(
            **P[f"{fam}-init-{key}"]), mask=_j_mask(P, key), family=fam,
        **FAMILY_EM_KW)
    got = members[0]
    assert all(m["history"] == got["history"] for m in members)
    assert got["e_steps"] == stops
    for want in (port.history, ref.history):
        for k in ("elbo", "phi", "trQ", "trSigma0"):
            _close(got["history"][k], want[k], atol=0.0)
    assert got["history"]["sigma2"] == port.history["sigma2"]


# -- one rank: the plain functions, bit for bit --------------------------------

@pytest.fixture
def one_rank():
    assert not comm.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    comm.destroy()


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("key", ["dense", "masked"])
@pytest.mark.parametrize("kind", ["cavi", "smoothed", "bernoulli",
                                  "poisson"])
def test_one_rank_warm_init_is_the_plain_one(one_rank, problems, kind, key):
    P = problems
    mask = torch.from_numpy(P["mask"]) if _masked(key) else None
    if kind in ("bernoulli", "poisson"):
        Y, p = torch.from_numpy(P[kind]), params_from_numpy(
            P["family_params"])
        Y_s, _ = shard_smoothed_inputs(one_rank, Y)
        got = warm_init_smoothed_family(Y_s, p, kind, obs_mask=mask)
        want = warm_init_smoothed_family(Y, p, kind, obs_mask=mask)
    else:
        Y, p = torch.from_numpy(P["Y"]), params_from_numpy(P["p0"])
        shard = shard_fit_inputs if kind == "cavi" else shard_smoothed_inputs
        fn = (tcavi.warm_init_state if kind == "cavi"
              else tsm.warm_init_smoothed_state)
        Y_s, _ = shard(one_rank, Y)
        got, want = fn(Y_s, p, obs_mask=mask), fn(Y, p, obs_mask=mask)
    assert _same(got.full(), want)


@pytest.mark.parametrize("key", ["dense", "masked"])
def test_one_rank_moments_and_elbos_are_the_plain_ones(one_rank, problems,
                                                       key):
    """``em_update_params`` for every phi and R structure, ``exact_elbo``,
    ``smoothed_elbo`` and ``compute_elbo``."""
    P = problems
    Y, mask = _port(P, key)
    p = params_from_numpy(P["p0"])
    state = tsm.smoothed_state_from_numpy(P[f"solved-{key}"])
    Y_s, st = shard_smoothed_inputs(one_rank, Y, state)
    gated = None if mask is None else tcavi.gated_mask(mask, Y)
    for ps in PHI_STRUCTURES:
        for rs in R_STRUCTURES:
            kw = dict(phi_structure=ps, r_structure=rs)
            assert _same(tem.em_update_params(p, Y_s, st, mask=mask, **kw),
                         tem.em_update_params(p, Y, state, mask=gated, **kw))
    assert torch.equal(exact_elbo(Y_s, p, st, mask=mask),
                       exact_elbo(Y, p, state, mask=mask))
    pri = tcavi.precompute_priors(p)
    assert torch.equal(tsm.smoothed_elbo(Y_s, p, pri, st, obs_mask=mask),
                       tsm.smoothed_elbo(Y, p, pri, state, obs_mask=mask))
    cstate = tcavi.state_from_numpy(P["cavi"])
    Yc_s, cst = shard_fit_inputs(one_rank, Y, cstate)
    for s in ("diag", "full", "block"):
        assert torch.equal(
            tcavi.compute_elbo(Yc_s, p, pri, cst, s, obs_mask=mask),
            tcavi.compute_elbo(Y, p, pri, cstate, s, obs_mask=mask))


@pytest.mark.parametrize("init_mode", ["warm", "random"])
@pytest.mark.parametrize("key", ["dense", "masked"])
def test_one_rank_fit_em_is_the_plain_fit(one_rank, problems, key,
                                          init_mode):
    """Gaussian EM from its own warm (or random) init: the history, the
    parameters, the E-step stops and the state."""
    P = problems
    Y, mask = _port(P, key)
    p = params_from_numpy(P["p0"])
    kw = dict(EM_KW, init_mode=init_mode)
    want, stops = _port_em(Y, p, mask, None, kw)
    Y_s, _ = shard_smoothed_inputs(one_rank, Y)
    got, got_stops = _port_em(Y_s, p, mask, None, kw)
    assert got.history == want.history and got_stops == stops
    assert _same(got.params, want.params)
    assert _same(got.state.full(), want.state)


@pytest.mark.parametrize("fam,key", [("bernoulli", "dense"),
                                     ("poisson", "masked")])
def test_one_rank_family_fit_and_em_are_the_plain_ones(one_rank, problems,
                                                       fam, key):
    P = problems
    Y, p = torch.from_numpy(P[fam]), params_from_numpy(P["family_params"])
    mask = torch.from_numpy(P["mask"]) if _masked(key) else None
    init = tsm.smoothed_state_from_numpy(P[f"{fam}-init-{key}"])
    Y_s, init_s = shard_smoothed_inputs(one_rank, Y, init)
    want = fit_smoothed_family(Y, p, init, family=fam, mask=mask,
                               **FAMILY_KW)
    got = fit_smoothed_family(Y_s, p, init_s, family=fam, mask=mask,
                              **FAMILY_KW)
    n = want.n_iter
    assert (got.n_iter, got.converged) == (n, want.converged)
    assert torch.equal(got.elbo_history[:n], want.elbo_history[:n])
    assert _same(got.field("state").full(), want.state)
    kw = dict(FAMILY_EM_KW, family=fam)
    em_want, stops = _port_em(Y, p, mask, None, kw)
    em_got, got_stops = _port_em(Y_s, p, mask, None, kw)
    assert em_got.history == em_want.history and got_stops == stops
    assert _same(em_got.params, em_want.params)
    assert _same(em_got.state.full(), em_want.state)


def test_family_inputs_names_the_sharded_engines(one_rank, problems):
    Y_s, _ = shard_smoothed_inputs(one_rank, problems["bernoulli"])
    with pytest.raises(TypeError, match="sharded_family"):
        family_inputs(Y_s)
