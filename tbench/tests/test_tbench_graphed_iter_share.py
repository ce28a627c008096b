"""CPU tests of ``tbench/metrics/graphed_iter_share.py``: the share of the
traced window's fit-loop iterations that the program counted as graph
replays, on hand-made records, and what it leaves out.

    python -m pytest tbench/tests -q
"""

from __future__ import annotations

import pytest

from tbench import spec
from tbench.tests.test_tbench_program_spans import _fit, _read, _records, _run


def test_graphed_iter_share_on_hand_made_records(monkeypatch):
    """Graphed iterations in the window over the window's iterations; the
    record before the window is left out."""
    from tame_torch.utils import profiling
    from tame_torch.utils.profiling import SpanRecord

    graphed = [SpanRecord("graphed_iters", t, t, -1, 0)
               for t in (-4_200_000, 420_000, 430_000, 520_000)]
    monkeypatch.setattr(profiling, "spans", lambda: _records() + graphed)
    run = _run()._replace(fits=[_fit(0, 2), _fit(1, 2)])
    assert _read("graphed_iter_share", run) == pytest.approx(100 * 3 / 4)
    monkeypatch.setattr(profiling, "spans", _records)
    assert _read("graphed_iter_share", run) == 0.0


def test_graphed_iter_share_reads_none_without_trace_or_counter(monkeypatch):
    """None for an untraced run, and for a program that has no
    ``graphed_iters`` counter (the parent of the graphs)."""
    from tame_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _records)
    assert _read("graphed_iter_share", _run(traced=False)) is None
    monkeypatch.delattr(profiling, "GRAPHED_ITERS")
    assert _read("graphed_iter_share", _run()) is None


@pytest.mark.parametrize("name", ["n2000_smf_cold", "n2000_smoothed_warm"])
def test_graphed_iter_share_is_listed_for_the_loop_cells(name):
    """Listed for the cells whose fits run the graphed loop, and for no
    cell the benchmark lacks."""
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    m = entries["graphed_iter_share"]
    assert (m["source"], m["moves"], m["unit"]) == ("program_counter",
                                                    "iter_ms", "%")
    assert m["layer"] == entries["syncs_per_iter"]["layer"]
    assert name in m["workloads"]
    assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
