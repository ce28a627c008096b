"""CPU tests of ``tbench/settle.py``, the readings that set a cell's
``settle``: the gap arithmetic on hand-made histories, and a small run of
the program's fits and the control against the reference.

    python -m pytest tbench/tests -q
"""

from __future__ import annotations

import math

import pytest
import torch

from tbench import settle, spec
from tbench.reference import judge
from tbench.tests.test_tbench_controls import SIZED, cpu_control_cell


def test_gaps_and_tail_as_the_judge_takes_them():
    gaps = judge.elbo_gaps([-101.0, -50.5, -40.0], [-100.0, -50.0, -40.0,
                                                    -39.0])
    assert gaps.tolist() == pytest.approx([0.01, 0.01, 0.0])
    assert judge.tail_gap(gaps, 0) == pytest.approx(0.01)
    assert judge.tail_gap(gaps, 2) == 0.0
    assert judge.tail_gap(gaps, 9) == 0.0        # never all iterations
    assert judge.tail_gap([], 3) == math.inf


def test_table_counts_fits_over_the_limit_per_settle():
    limits = {"mu_gap": 1.0, "elbo_median_gap": 1.0, "elbo_tail_gap": 1e-3,
              "stop_gap": 0}
    lines = [{"control": False, "gaps": [1e-2, 2e-3, 1e-4, 1e-4]},
             {"control": False, "gaps": [1e-2, 1e-4, 1e-4, 1e-4]},
             {"control": True, "mu_gap": 0.5, "elbo_median_gap": 0.1,
              "stop_gap": 0.0, "gaps": [1e-2, 1e-2, 1e-2, 1e-4]}]
    rows = settle.table(lines, limits, 4)
    assert [r["over"] for r in rows] == [2, 1, 0, 0]
    assert [r["control_fails"] for r in rows] == [True, True, True, False]
    assert rows[3]["control"]["elbo_tail_gap"] == pytest.approx(1e-4)
    assert rows[1]["widest"] == pytest.approx(2e-3)


def test_small_run_reads_the_program_and_the_control():
    """At a cell's CPU control size: the program's fits read under the
    limit from the cell's ``settle`` on, and the control fails."""
    torch.set_num_threads(1)
    cell = cpu_control_cell(spec.load_cell(SIZED[0]))
    device = torch.device("cpu")
    iters = cell.checks["settle"] + 4
    lines = list(settle.program_lines(cell, 2**32 + 21, device, 2, iters))
    lines.append(settle.control_line(cell, 2**32 + 21, device))
    assert [len(x["gaps"]) for x in lines[:2]] == [iters, iters]
    assert not any(x["failed"] for x in lines)
    rows = settle.table(lines, cell.checks["limits"], iters)
    assert all(a["over"] >= b["over"] for a, b in zip(rows, rows[1:]))
    assert rows[cell.checks["settle"]]["over"] == 0
    assert rows[cell.checks["settle"]]["control_fails"]
