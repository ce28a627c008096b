"""The masked Good-SMF fit at the production flags (bf16 dyad weights,
sufficient-statistics diagnostics) on both of the port's routes for its
masked contractions, held to the benchmark's float64 replay with the
flags' roundings (``tbench/reference/kinds/smf_prod_fits.py``), and the
rule that picks the route (``cavi.use_packed_mask``).

The replay applies the roundings the flags state, and only those: the
dyad weights ``W0 = p y_ij + q y_ji`` and ``W1 = q y_ij + p y_ji`` formed
in float32 and stored in bf16 (their row sums, the natural parameter's
additive entries, taken before the rounding); every panel a step
contracts against the weights or the mask rounded to bf16 first (the
partners' ``V`` and ``U`` in ``W0 V`` and ``W1 U``, the partner panel
whose masked sums give the observation precision); the diagnostics'
``[V | U]`` against ``W0`` and their moment panel against the mask in two
bf16 halves (``cavi._diag_contract``); everything else in float64.  Its
ELBO is the masked ELBO with the likelihood's quadratic sum expanded in
sufficient statistics as the diagnostics expand it.

Why one iteration at a time.  Rounding the panels to bf16 makes a step a
step function of the state: where a panel entry lies within float32's
reach of a bf16 rounding boundary, the float32 program and the float64
replay round it apart, by one bf16 step (2^-8 relative).  At n=12 one
such flip moves a partner sum of ~8 terms by ~5e-4, and from a random
start the transient amplifies it: the two whole fits then part by 1e-3 -
1e-2 within tens of iterations, as far as a float32 or a TF32 replay
does.  So the replay takes each of the program's states and makes the
next iteration from it; every iteration of the program's fit is compared,
and nothing carries a flip forward.

Tolerances (each iteration, at n=12, T=5, r=2, 30 % hidden, 12 blocks):

* ``MU_TOL`` 5e-4 on the dyadic means' widest gap over the largest mean:
  a panel entry formed from a node already updated in the same iteration
  can still round apart (float32 against float64 updates of the earlier
  blocks), one bf16 step in one partner sum; measured up to 9.2e-5 with
  the roundings (median 3e-7), 4.0e-3 - 6.6e-3 without them (seeds 1-6,
  both routes alike);
* ``ELBO_TOL`` 3e-5 relative on the ELBO: the stats expansion's float32
  cancellation (y^2 and mu^2 sums against a residual sum ~50 times
  smaller) and what the two bf16 halves leave of the panels (~2^-17);
  measured up to 1.45e-5 with the roundings (seed 3; 1.7e-6 - 7.7e-6 on
  the others), 1.1e-3 - 1.7e-3 without them (the exact ELBO);
* the stop: the stopping rule on the replay's ELBOs of the program's
  states stops where the program's fit stopped (tolerance 1e-3, so that
  the fits stop: at this size the bf16 steps keep moving the state, and
  at 1e-4 each of seeds 1-6 runs 300 iterations).
"""

import copy

import numpy as np
import pytest
import torch

from tame_torch.inference import cavi
from tame_torch.utils import profiling
from tbench import spec
from tbench.reference import fits
from tbench.reference.judge import dyadic_gap, stop_index
from tbench.reference.kinds.smf_prod_fits import smf_elbo, smf_step, weights
from tbench.reference.model import PRECISIONS, build_params, random_init
from tbench.stream import FitStream
from tbench.tests.test_tbench_harness import shrink

torch.set_num_threads(1)

N, T, R = 12, 5, 2
ITERS = 30
MU_TOL = 5e-4
ELBO_TOL = 3e-5
STOP_TOL, STOP_BUDGET = 1e-3, 80
SEEDS = (1, 2, 3)
ROUTES = {"einsum": None, "k5": "1"}


# ---------------------------------------------------------------------------
# The program against the replay
# ---------------------------------------------------------------------------

def _problem(seed):
    """The north-star cell's model at n=12 on the CPU with the production
    flags and 30 % of dyad-times hidden: the benchmark's seeded network
    and mask, the port's model, the replay's float64 inputs and the
    engines' random start."""
    cell = shrink(spec.load_cell("n2000_smf_cold"), N, T, R)
    config = copy.deepcopy(cell.config)
    config["fit"].update(mixed_precision=True, diag_mode="stats")
    cell = cell._replace(config=config,
                         traffic=dict(cell.traffic, mask_frac=0.3))
    stream = FitStream(cell, seed, torch.device("cpu"))
    prec = PRECISIONS["f64"]
    params = build_params(cell.config["model"], torch.float64, "cpu")
    data = fits.prepare(stream.Y[0], stream.mask(0), params, prec)
    mean, cov = random_init(seed, N, T, 2 + 2 * R, 0.1, 0.5)
    return dict(fit=cell.config["fit"], stream=stream, prec=prec,
                params=params, data=data, pri=fits.prior(params, T, prec),
                init=cavi.CaviState(mean, cov))


def _fit(p, init, max_iter, tolerance=0.0):
    f = p["fit"]
    return cavi.fit_cavi(
        p["stream"].Y[0], p["stream"].model.params, init, structure="full",
        update_mode="block", num_blocks=f["num_blocks"],
        learning_rate=f["learning_rate"], tolerance=tolerance,
        max_iter=max_iter, mixed_precision=True, diag_mode="stats",
        mask=p["stream"].mask(0), fused=False)


def _program_states(p, iters):
    """The program's states and ELBOs, one iteration a call."""
    states, elbos = [p["init"]], []
    for _ in range(iters):
        res = _fit(p, states[-1], 1)
        states.append(cavi.CaviState(res.X_mean, res.X_cov))
        elbos.append(float(res.elbo_history[0]))
    return states, elbos


def _reference_readings(p, states, elbos, rounded=True):
    """Per iteration: the dyadic-mean gap between the program's state and
    the replay's iteration from the program's previous state, and the
    ELBO gap between the program's ELBO and the replay's ELBO of the
    program's state; with the replay's ELBOs."""
    data, prec, f = p["data"], p["prec"], p["fit"]
    w = weights(data, p["params"]) if rounded else None
    mu, gaps, ref_elbos = [], [], []
    for k in range(len(elbos)):
        X = states[k].X_mean.double().clone()
        C = states[k].X_cov.double().clone()
        smf_step(X, C, data, w, p["params"], p["pri"], prec,
                 f["learning_rate"], f["num_blocks"])
        gap, top = dyadic_gap(states[k + 1].X_mean, X)
        mu.append(gap / top)
        e = float(smf_elbo(states[k + 1].X_mean.double(),
                           states[k + 1].X_cov.double(), data, w,
                           p["params"], p["pri"], prec))
        ref_elbos.append(e)
        gaps.append(abs(elbos[k] - e) / abs(e))
    return np.array(mu), np.array(gaps), ref_elbos


def _set_packed(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("TAME_PACKED_MASK", raising=False)
    else:
        monkeypatch.setenv("TAME_PACKED_MASK", value)


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    _set_packed(monkeypatch, ROUTES[request.param])
    return request.param


@pytest.mark.parametrize("seed", SEEDS)
def test_route_matches_the_reference_each_iteration(seed, route):
    p = _problem(seed)
    before = profiling.counters().get(profiling.K5_CONTRACTS, 0)
    states, elbos = _program_states(p, ITERS)
    k5 = profiling.counters().get(profiling.K5_CONTRACTS, 0) - before
    assert k5 == (2 * p["fit"]["num_blocks"] * ITERS if route == "k5" else 0)
    whole = _fit(p, p["init"], ITERS)
    assert torch.equal(whole.X_mean, states[-1].X_mean)
    assert whole.elbo_history[:ITERS].tolist() == elbos
    mu, gaps, _ = _reference_readings(p, states, elbos)
    assert mu.max() <= MU_TOL, mu
    assert gaps.max() <= ELBO_TOL, gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_route_stops_where_the_reference_puts_the_stop(seed, route):
    p = _problem(seed)
    whole = _fit(p, p["init"], STOP_BUDGET, tolerance=STOP_TOL)
    states, elbos = _program_states(p, whole.n_iter)
    assert whole.elbo_history[:whole.n_iter].tolist() == elbos
    _, _, ref_elbos = _reference_readings(p, states, elbos)
    assert whole.n_iter == stop_index(ref_elbos, STOP_TOL,
                                      p["fit"]["patience"], STOP_BUDGET)


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_without_its_roundings_fails_the_tolerances(seed):
    p = _problem(seed)
    states, elbos = _program_states(p, ITERS)
    mu, gaps, _ = _reference_readings(p, states, elbos, rounded=False)
    assert mu.max() > MU_TOL and gaps.max() > ELBO_TOL


# ---------------------------------------------------------------------------
# The route of masked contractions
# ---------------------------------------------------------------------------

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("packed, device, mixed, k5", [
    (None, CUDA, True, True),      # the card, bf16 weights: K5
    (None, CUDA, False, False),    # the card, float32: the einsum
    ("0", CUDA, True, True),
    ("1", CUDA, False, True),      # TAME_PACKED_MASK=1 anywhere
    ("1", CUDA, True, True),
    (None, CPU, True, False),      # the CPU: the variable alone
    (None, CPU, False, False),
    ("0", CPU, True, False),
    ("1", CPU, True, True),
    ("1", CPU, False, True),
    ("1", None, True, False),      # no mask
    (None, None, True, False),
])
def test_use_packed_mask(monkeypatch, packed, device, mixed, k5):
    _set_packed(monkeypatch, packed)
    assert cavi.use_packed_mask(device, mixed) is k5


def test_float32_masked_quick_start_cell_keeps_the_einsum(monkeypatch):
    """``demo_masked30`` (float32, a mask) keeps the einsum on the card."""
    _set_packed(monkeypatch, None)
    fit = spec.load_cell("demo_masked30").config["fit"]
    assert cavi.use_packed_mask(CUDA, fit["mixed_precision"]) is False
