"""CPU tests of the readers of the program's own spans and sync count
(``tbench/metrics/_program.py`` and the six metrics on it): their
arithmetic on hand-made records and a hand-made trace, what they leave
out, and a tiny traced run through the port's CPU twins.

    python -m pytest tbench/tests -q
"""

from __future__ import annotations

import time

import pytest
import torch

from tbench import harness, spec, trace
from tbench.stream import FitRecord
from tbench.tests.test_tbench_harness import CELLS, tiny_cell

PROGRAM_METRICS = ("engine_span_ms_per_fit", "start_ms_per_fit",
                   "step_host_ms_per_iter", "step_idle_pct",
                   "readback_ms_per_iter", "syncs_per_iter")


def _fit(k, n_iter):
    return FitRecord(index=k, network=k, engine_seed=k, seconds=0.5,
                     n_iter=n_iter, elbo=[0.0] * n_iter, X=None,
                     failed=False, error=None, launches={})


def _records():
    """The program's records of two fits of one iteration each over a
    1,000 us window (nanoseconds, as the program keeps them), one record
    before the window and one still open."""
    from tame_torch.utils.profiling import SpanRecord

    us = [("engine.build", 0, 100), ("engine.start", 10, 60),
          ("syncs", 50, 50), ("engine.fit", 100, 900), ("fit.run", 150, 850),
          ("loop.step", 200, 300), ("loop.readback", 310, 320),
          ("syncs", 315, 315), ("loop.step", 400, 500),
          ("loop.readback", 510, 520), ("syncs", 515, 515)]
    recs = [SpanRecord(n, int(s * 1e3), int(e * 1e3), -1, 0)
            for n, s, e in us]
    outside = [SpanRecord("loop.step", -5_000_000, -4_000_000, -1, 1),
               SpanRecord("syncs", -4_500_000, -4_500_000, -1, 1),
               SpanRecord("loop.step", 950_000, -1, -1, 2)]
    return recs + outside


def _run(cell_name="n2000_smf_cold", traced=True):
    """Device operations at [150, 250] and [350, 450] us: the idle gap
    [250, 350] straddles the end of the first step span and the gap
    [450, 1000] the end of the second."""
    Op = trace.Op
    data = trace.TraceData(
        ops=[Op("void spd_solve_inv_kernel<10, true>(float const*)", 150,
                250), Op("reduce_kernel", 350, 450)],
        spans=[Op("tbench.window", 0, 1000)], window=(0.0, 1000.0))
    return harness.Run(spec.load_cell(cell_name), 1.0, 2.0,
                       [_fit(0, 1), _fit(1, 1)], data if traced else None)


@pytest.fixture
def records(monkeypatch):
    from tame_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _records)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_program_readers_on_hand_made_records(records):
    run = _run()
    assert _read("engine_span_ms_per_fit", run) == pytest.approx(
        (100 + 800 - 700) * 1e-3 / 2)
    assert _read("start_ms_per_fit", run) == pytest.approx(50e-3 / 2)
    assert _read("step_host_ms_per_iter", run) == pytest.approx(200e-3 / 2)
    assert _read("readback_ms_per_iter", run) == pytest.approx(20e-3 / 2)
    assert _read("syncs_per_iter", run) == pytest.approx(3 / 2)
    # idle inside the steps: [250, 300] and [450, 500]
    assert _read("step_idle_pct", run) == pytest.approx(100 * 100 / 1000)
    assert _read("step_idle_pct", run) <= _read("device_idle_pct", run)


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_untraced_run_reads_none(records, name):
    assert _read(name, _run(traced=False)) is None


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_program_without_spans_reads_none(monkeypatch, name):
    """A program with no span API (the parent of the spans), or none of
    its records in the window."""
    from tame_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _read(name, _run()) is None
    monkeypatch.setattr(profiling, "spans", lambda: _records()[-3:],
                        raising=False)
    assert _read(name, _run()) is None


def test_k3_fits_read_no_step_spans(monkeypatch):
    """A K3 fit has no loop: its readback and syncs read, its steps not."""
    from tame_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [
        r for r in _records() if r.name != "loop.step"])
    run = _run("demo_fits")
    assert _read("step_host_ms_per_iter", run) is None
    assert _read("step_idle_pct", run) is None
    assert _read("syncs_per_iter", run) == pytest.approx(3 / 2)


@pytest.mark.parametrize("cell", ["n2000_smf_cold", "n2000_smoothed_warm"])
def test_new_metrics_are_listed_for_the_cells_they_read(cell):
    """Each on a layer the first ten metrics name; ``step_idle_pct``, which
    reads the loop's steps, listed for the loop cells and, like
    ``step_host_ms_per_iter``, for no cell the benchmark lacks."""
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = {m["layer"] for m in bench["per_layer"][:10]}
    for name in PROGRAM_METRICS:
        m = entries[name]
        assert m["layer"] in layers
        assert m["source"] == ("program_counter" if name == "syncs_per_iter"
                               else "program_span")
    idle = entries["step_idle_pct"]["workloads"]
    assert cell in idle
    assert set(idle) == set(entries["step_host_ms_per_iter"]["workloads"])
    assert set(idle) <= {w["name"] for w in bench["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run_reads_the_programs_spans(name):
    """On the CPU each iteration's one sync is its readback (no card: no
    copies, no library call waits), and the engine's span-based host time
    sits inside the benchmark's wrapped one."""
    torch.set_num_threads(1)
    cell = tiny_cell(name, 8, 4, 1)
    res = harness.run(cell, 2**40 + 7, 0.2, True, torch.device("cpu"),
                      time.perf_counter(), log=lambda line: None)
    got = res["metrics"]
    listed = {m["name"] for m in cell.per_layer} & set(PROGRAM_METRICS)
    assert listed <= set(got)
    assert got["syncs_per_iter"]["value"] == 1.0
    assert 0 < got["start_ms_per_fit"]["value"] <= \
        got["engine_span_ms_per_fit"]["value"]
    assert got["engine_span_ms_per_fit"]["value"] <= \
        got["engine_host_ms_per_fit"]["value"] * 1.5
