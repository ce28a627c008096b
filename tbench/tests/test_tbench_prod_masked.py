"""CPU tests of what the production-flag cell (``n2000_prod_masked30``)
adds to the benchmark: K5's frozen count, the readers of K5's roofline
share, its contraction count and the fit's input span, on hand-made
traces and records, and the settings the cell's reference replays.

    python -m pytest tbench/tests -q
"""

from __future__ import annotations

import pytest

from tbench import harness, spec, trace
from tbench.reference import judge
from tbench.roofline import masked_contract, peaks
from tbench.stream import FitRecord

CELL = "n2000_prod_masked30"


def test_k5_count_reproduces_the_bring_up_bound():
    """One 125-row stripe at n=2000, T=50 against the 57-column partner
    panel: 0.01096 ms by its bytes (the kernel table's bound)."""
    assert masked_contract.bound_s(125, 2000, 50, 57) * 1e3 == \
        pytest.approx(0.01096, rel=5e-3)
    n_bytes, flops = masked_contract.k5(125, 2000, 50, 57)
    assert n_bytes / peaks.HBM_BYTES_PER_S > \
        flops / masked_contract.BF16_TENSOR_FLOPS
    assert masked_contract.panel_widths(4) == (57, 112)


def _fit(k, n_iter):
    return FitRecord(index=k, network=k, engine_seed=k, seconds=0.5,
                     n_iter=n_iter, elbo=[0.0] * n_iter, X=None,
                     failed=False, error=None, launches={})


def _run(ops, traced=True):
    data = trace.TraceData(ops=ops, spans=[trace.Op("tbench.window", 0,
                                                    1000)],
                           window=(0.0, 1000.0))
    return harness.Run(spec.load_cell(CELL), 1.0, 2.0,
                       [_fit(0, 1), _fit(1, 1)], data if traced else None)


def test_k5_roofline_reads_each_launch_against_its_bound():
    """Four launches of 20 us, two a panel: the mean of the two panels'
    bounds, times four, over 80 us."""
    name = ("masked_contract_kernel(signed char const*, float const*, "
            "float*, int, int, int, int, int)")
    ops = [trace.Op(name, 10 + 30 * k, 30 + 30 * k) for k in range(4)]
    got = spec.metric_reader("k5_roofline")(_run(ops))
    bounds = [masked_contract.bound_s(125, 2000, 50, K)
              for K in masked_contract.panel_widths(4)]
    assert got == pytest.approx(100 * 4 * sum(bounds) / 2 / 80e-6)
    assert spec.metric_reader("k5_roofline")(_run([])) is None
    assert spec.metric_reader("k5_roofline")(_run(ops, False)) is None


@pytest.fixture
def records(monkeypatch):
    """Program records of two fits of one iteration each: 32 K5
    contractions an iteration and one ``fit.inputs`` span of 40 and 60
    us a fit."""
    from tame_torch.utils import profiling
    from tame_torch.utils.profiling import SpanRecord

    us = [("fit.inputs", 100, 140), ("fit.inputs", 500, 560)]
    recs = [SpanRecord(n, int(s * 1e3), int(e * 1e3), -1, 0)
            for n, s, e in us]
    recs += [SpanRecord(profiling.K5_CONTRACTS, 200_000 + k, 200_000 + k, -1,
                        0) for k in range(64)]
    monkeypatch.setattr(profiling, "spans", lambda: recs)


def test_k5_contracts_and_inputs_readers(records):
    run = _run([])
    assert spec.metric_reader("k5_contracts_per_iter")(run) == 32
    assert spec.metric_reader("inputs_ms_per_fit")(run) == \
        pytest.approx((40 + 60) * 1e-3 / 2)
    untraced = _run([], traced=False)
    for name in ("k5_contracts_per_iter", "inputs_ms_per_fit"):
        assert spec.metric_reader(name)(untraced) is None


@pytest.mark.parametrize("group, key, value", [
    ("fit", "mixed_precision", False),
    ("fit", "diag_mode", "exact"),
    ("fit", "update_mode", "jacobi"),
    ("fit", "tf32", True),
    ("fit", "num_blocks", 8),
    ("traffic", "init", "warm"),
    ("traffic", "corrected", True),
    ("traffic", "mask_frac", 0.0),
])
def test_prod_reference_refuses_what_it_does_not_replay(group, key, value):
    cell = spec.load_cell(CELL)
    if group == "fit":
        cell = cell._replace(config=dict(
            cell.config, fit=dict(cell.config["fit"], **{key: value})))
    else:
        cell = cell._replace(traffic=dict(cell.traffic, **{key: value}))
    with pytest.raises(ValueError, match=key):
        judge.check_cell(cell)
