"""The comparison that decides ``correct`` has to fail what is not the
program's float32 arithmetic: the control (the reference computed in
TF32, put in the program's place) and the faults a fit can have (a step
that returns its state unchanged, half of the nodes left out of each
update, an answer altered where it is produced, a stop moved by one
iteration), each against the cell's own limits.

On the CPU, at the sizes each cell's checks file states under ``cpu``:
the faults at its ``size``, through the port's twins, planted where the
cell's traffic kind names (``FAULT_TARGETS`` in
``tbench/traffic/<kind>.py``), and the control at its ``control_size``
(null: the cell's own size).  On the card (``cuda`` marker): the control
at every cell's own size.  The checks below take a cell, so a cell added
with data files alone is held to them as it stands.

    python -m pytest tbench/tests -q
    python -m pytest -o addopts="" --noconftest tbench/tests -m cuda -q  # card
"""

from __future__ import annotations

import importlib
import time

import pytest
import torch

from tbench import harness, spec
from tbench.reference.judge import reference_fit
from tbench.stream import FitStream
from tbench.tests.test_tbench_harness import CELLS, shrink

# The cells whose checks file states their CPU sizes; a cell without them
# fails test_checks_state_the_cpu_sizes alone.
SIZED = [name for name in CELLS if "cpu" in spec.load_cell(name).checks]


@pytest.mark.parametrize("name", CELLS)
def test_checks_state_the_cpu_sizes(name):
    checks = spec.load_cell(name).checks
    assert "cpu" in checks, (
        f"tbench/checks/{name}.json has no key 'cpu': "
        '{"size": [n, T, r], "control_size": [n, T, r] or null}')
    cpu = checks["cpu"]
    assert set(cpu) == {"size", "control_size"}, cpu
    for size in (cpu["size"], cpu["control_size"] or [1, 1, 1]):
        assert len(size) == 3 and all(
            isinstance(k, int) and k > 0 for k in size), cpu


def _control_numbers(cell, seed, device):
    stream = FitStream(cell, seed, device)
    rec = stream.run_fit(0, keep=False)
    ctrl = harness.control_outcome(cell, stream, rec)
    return harness.judge(cell, stream, [(rec, ctrl)])


def cpu_control_cell(cell):
    """``cell`` at its control size on the CPU, the reference there too."""
    size = cell.checks["cpu"]["control_size"]
    if size:
        cell = shrink(cell, *size, max_iter=500)
    return cell._replace(checks=dict(cell.checks, reference_device="cpu"))


def check_control_fails_on_the_cpu(cell):
    torch.set_num_threads(1)
    cell = cpu_control_cell(cell)
    numbers = _control_numbers(cell, 2**32 + 13, torch.device("cpu"))
    assert not harness.passed(harness.checks_of(numbers,
                                                cell.checks["limits"]))


def check_float32_reference_passes(cell):
    torch.set_num_threads(1)
    cell = cpu_control_cell(cell)
    stream = FitStream(cell, 2**32 + 13, torch.device("cpu"))
    rec = stream.run_fit(0, keep=False)
    got = reference_fit(cell, stream.Y[rec.network], stream.mask(rec.index),
                        rec.engine_seed, "f32")
    numbers = harness.judge(cell, stream, [(rec, got)])
    assert harness.passed(harness.checks_of(numbers, cell.checks["limits"]))


@pytest.mark.parametrize("name", SIZED)
def test_control_fails_on_the_cpu(name):
    check_control_fails_on_the_cpu(spec.load_cell(name))


@pytest.mark.parametrize("name", SIZED)
def test_float32_reference_passes(name):
    """The limits fail what lies below float32, not float32 itself: the
    plain reference in float32, in the program's place, is correct."""
    check_float32_reference_passes(spec.load_cell(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    cell = spec.load_cell(name)
    for seed in (2**32 + 101, 2**32 + 102, 2**32 + 103):
        numbers = _control_numbers(cell, seed, torch.device("cuda"))
        assert not harness.passed(harness.checks_of(numbers,
                                                    cell.checks["limits"]))


def _unchanged(orig):
    def step(state, *args, **kwargs):
        return state
    return step


def _half_left_out(orig):
    """The update applied to the first half of the nodes only."""
    def step(state, *args, **kwargs):
        new = orig(state, *args, **kwargs)
        half = state.X_mean.shape[0] // 2
        parts = []
        for got, old in zip(new, state):
            got = got.clone()
            got[half:] = old[half:]
            parts.append(got)
        return type(new)(*parts)
    return step


def _answer_altered(orig):
    """The fit's result with one node's means moved by 0.05."""
    def fit(*args, **kwargs):
        out = orig(*args, **kwargs)
        state = getattr(out, "state", out)
        state.X_mean[0] += 0.05
        return out
    return fit


def _stop_moved(orig):
    """The stopping rule with one less iteration of patience."""
    class Rule(orig):
        def __init__(self, carry_elbo, carry_patience, tolerance, patience):
            super().__init__(carry_elbo, carry_patience, tolerance,
                             patience - 1)
    return Rule


FAULTS = {"unchanged": ("step", _unchanged),
          "half_left_out": ("step", _half_left_out),
          "answer_altered": ("fit", _answer_altered),
          "stop_moved": ("rule", _stop_moved)}


def check_fault_comes_out_not_correct(cell, fault, monkeypatch):
    """``fault`` planted where the cell's traffic kind names, in a run of
    the cell at its CPU size: ``correct`` comes out false."""
    torch.set_num_threads(1)
    cell = shrink(cell, *cell.checks["cpu"]["size"], max_iter=500)
    where, make = FAULTS[fault]
    targets = spec.traffic_kind(cell.traffic["kind"]).FAULT_TARGETS
    module, fn = targets[where]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, fn, make(getattr(mod, fn)))
    res = harness.run(cell, 2**34 + 3, 0.0, False, torch.device("cpu"),
                      time.perf_counter(), log=lambda line: None)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", SIZED)
def test_fault_comes_out_not_correct(name, fault, monkeypatch):
    check_fault_comes_out_not_correct(spec.load_cell(name), fault,
                                      monkeypatch)
