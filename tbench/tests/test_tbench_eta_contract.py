"""CPU tests of K7's reading in the benchmark: its frozen count
(``tbench/roofline/eta_contract.py``), the launches of an iteration each
cell's ``fit`` settings give, the reader of its roofline share on
hand-made traces and the reader of its contraction count on hand-made
records.

    python -m pytest tbench/tests -q
"""

from __future__ import annotations

import pytest

from tbench import harness, spec, trace
from tbench.roofline import eta_contract, peaks
from tbench.stream import FitRecord

CELLS = ("n2000_smf_cold", "n2000_smoothed_warm", "n2000_prod_masked30",
         "demo_masked30")
NAME = ("void (anonymous namespace)::eta_contract_kernel<__nv_bfloat16, 4, "
        "true>((anonymous namespace)::Args)")


def test_k7_count_of_a_stripe_and_of_the_whole_matrix():
    """A 125-row bf16 stripe at n=2000, T=50, R=4: 25 MB of weights, the
    1.6 MB panel and 0.1 MB of sums, 8.0 us by bytes; in float32 15.4 us;
    the whole bf16 matrix against the diagnostics' 16 columns 123 us."""
    assert eta_contract.bound_s(125, 2000, 50, 4, 2) * 1e6 == \
        pytest.approx(7.970, rel=1e-3)
    assert eta_contract.bound_s(125, 2000, 50, 4, 4) * 1e6 == \
        pytest.approx(15.433, rel=1e-3)
    assert eta_contract.bound_s(2000, 2000, 50, 16, 2) * 1e6 == \
        pytest.approx(123.22, rel=1e-3)
    for m, R, w in ((125, 4, 2), (125, 4, 4), (2000, 16, 2), (1, 2, 4)):
        n_bytes, flops = eta_contract.k7(m, 2000, 50, R, w)
        assert n_bytes / peaks.HBM_BYTES_PER_S > flops / peaks.F32_FLOPS
    # against the widest panel, 4r at r = 6, the float32 FMAs bound it
    n_bytes, flops = eta_contract.k7(2000, 2000, 50, 24, 2)
    assert eta_contract.bound_s(2000, 2000, 50, 24, 2) == \
        flops / peaks.F32_FLOPS > n_bytes / peaks.HBM_BYTES_PER_S


@pytest.mark.parametrize("cell, launches", [
    ("n2000_smf_cold", [(125, 4)] * 32),
    ("n2000_smoothed_warm", [(125, 4)] * 32),
    ("n2000_prod_masked30", [(125, 4)] * 32 + [(2000, 16)]),
    ("demo_masked30", [(1, 2)] * 30)])
def test_an_iteration_s_launches_follow_the_cell(cell, launches):
    c = spec.load_cell(cell)
    m = c.config["model"]
    got = eta_contract.iteration_launches(m["n_nodes"], m["n_time"],
                                          m["latent_dim"], c.config["fit"])
    assert got == launches


def _fit(k, n_iter):
    return FitRecord(index=k, network=k, engine_seed=k, seconds=0.5,
                     n_iter=n_iter, elbo=[0.0] * n_iter, X=None,
                     failed=False, error=None, launches={})


def _run(cell, ops, traced=True, iters=1):
    data = trace.TraceData(ops=ops, spans=[trace.Op("tbench.window", 0,
                                                    1000)],
                           window=(0.0, 1000.0))
    return harness.Run(spec.load_cell(cell), 1.0, 2.0,
                       [_fit(0, iters), _fit(1, iters)],
                       data if traced else None)


@pytest.mark.parametrize("cell", CELLS)
def test_k7_roofline_reads_each_launch_against_its_bound(cell):
    """Launches of 20 us each: the mean bound of an iteration's launches,
    times their number, over their time; at the iteration's bound it
    reads 100 %."""
    c = spec.load_cell(cell)
    m, fit = c.config["model"], c.config["fit"]
    n, T, r = m["n_nodes"], m["n_time"], m["latent_dim"]
    k = len(eta_contract.iteration_launches(n, T, r, fit))
    ops = [trace.Op(NAME, 10 + 30 * j, 30 + 30 * j) for j in range(k)]
    got = spec.metric_reader("k7_roofline")(_run(cell, ops))
    bound = eta_contract.iteration_bound_s(n, T, r, fit)
    assert got == pytest.approx(100 * bound / (20e-6 * k))
    at_bound = [trace.Op(NAME, 0, bound * 1e6)]
    one = spec.metric_reader("k7_roofline")(_run(cell, at_bound))
    assert one == pytest.approx(100 / k)
    assert spec.metric_reader("k7_roofline")(_run(cell, [])) is None
    assert spec.metric_reader("k7_roofline")(_run(cell, ops, False)) is None


@pytest.fixture
def records(monkeypatch):
    """Program records of two fits of one iteration each: 32 K7
    contractions an iteration."""
    from tame_torch.utils import profiling
    from tame_torch.utils.profiling import SpanRecord

    recs = [SpanRecord(profiling.K7_CONTRACTS, 200_000 + k, 200_000 + k,
                       -1, 0) for k in range(64)]
    monkeypatch.setattr(profiling, "spans", lambda: recs)


def test_k7_contracts_reader(records):
    assert spec.metric_reader("k7_contracts_per_iter")(
        _run("n2000_smf_cold", [])) == 32
    assert spec.metric_reader("k7_contracts_per_iter")(
        _run("n2000_smf_cold", [], traced=False)) is None


def test_k7_contracts_reader_without_the_counter(records, monkeypatch):
    """A program that has no ``K7_CONTRACTS`` (the parent's) reads
    None and does not raise."""
    from tame_torch.utils import profiling

    monkeypatch.delattr(profiling, "K7_CONTRACTS")
    assert spec.metric_reader("k7_contracts_per_iter")(
        _run("n2000_smf_cold", [])) is None
