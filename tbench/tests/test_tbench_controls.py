"""The comparison that decides ``correct`` has to fail what is not the
program's float32 arithmetic: the control (the reference computed in
TF32, put in the program's place) and the faults a fit can have (a step
that returns its state unchanged, half of the nodes left out of each
update, an answer altered where it is produced, a stop moved by one
iteration), each against the cell's own limits.

On the CPU: the faults on every cell at a small size, through the port's
twins, and the control at the quick-start cell's own size and at n=24 for
the north-star cells.  On the card (``cuda`` marker): the control at every
cell's own size.

    python -m pytest tbench/tests -q
    python -m pytest -o addopts="" --noconftest tbench/tests -m cuda -q  # card
"""

from __future__ import annotations

import time

import pytest
import torch

from tbench import harness, spec
from tbench.reference.judge import reference_fit
from tbench.stream import FitStream
from tbench.tests.test_tbench_harness import CELLS, tiny_cell

SMALL = {"n2000_smf_cold": (12, 5, 2), "n2000_smoothed_warm": (12, 5, 2),
         "demo_fits": (8, 4, 1)}
# the control's size on the CPU: the quick-start cell's own, n=24 else
CONTROL = {"n2000_smf_cold": (24, 5, 2), "n2000_smoothed_warm": (24, 5, 2),
           "demo_fits": None}


def _control_numbers(cell, seed, device):
    stream = FitStream(cell, seed, device)
    rec = stream.run_fit(0, keep=False)
    ctrl = harness.control_outcome(cell, stream, rec)
    return harness.judge(cell, stream, [(rec, ctrl)])


def _cpu_cell(name):
    cell = spec.load_cell(name)
    if CONTROL[name]:
        cell = tiny_cell(name, *CONTROL[name], max_iter=500)
    return cell._replace(checks=dict(cell.checks, reference_device="cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_cpu(name):
    torch.set_num_threads(1)
    cell = _cpu_cell(name)
    numbers = _control_numbers(cell, 2**32 + 13, torch.device("cpu"))
    assert not harness.passed(harness.checks_of(numbers,
                                                cell.checks["limits"]))


@pytest.mark.parametrize("name", CELLS)
def test_float32_reference_passes(name):
    """The limits fail what lies below float32, not float32 itself: the
    plain reference in float32, in the program's place, is correct."""
    torch.set_num_threads(1)
    cell = _cpu_cell(name)
    stream = FitStream(cell, 2**32 + 13, torch.device("cpu"))
    rec = stream.run_fit(0, keep=False)
    got = reference_fit(cell, stream.Y[rec.network], stream.mask(rec.index),
                        rec.engine_seed, "f32")
    numbers = harness.judge(cell, stream, [(rec, got)])
    assert harness.passed(harness.checks_of(numbers, cell.checks["limits"]))


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
# where each fault is planted: the block steps, the fit functions (the
# answer as it leaves them) and the stopping rule
TARGETS = {("smf_fits", "step"): ("tame_torch.inference.cavi",
                                  "cavi_step_block"),
           ("smoothed_fits", "step"): ("tame_torch.inference.smoothed",
                                       "smoothed_step_block"),
           ("smf_fits", "fit"): ("tame_torch.inference.cavi", "fit_cavi"),
           ("smoothed_fits", "fit"): ("tame_torch.inference.smoothed",
                                      "fit_cavi_smoothed"),
           ("smf_fits", "rule"): ("tame_torch.inference.cavi", "_StopRule"),
           ("smoothed_fits", "rule"): ("tame_torch.inference.cavi",
                                       "_StopRule")}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_comes_out_not_correct(name, fault, monkeypatch):
    import importlib

    torch.set_num_threads(1)
    cell = tiny_cell(name, *SMALL[name], max_iter=500)
    where, make = FAULTS[fault]
    module, fn = TARGETS[(cell.traffic["kind"], where)]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, fn, make(getattr(mod, fn)))
    res = harness.run(cell, 2**34 + 3, 0.0, False, torch.device("cpu"),
                      time.perf_counter(), log=lambda line: None)
    assert not res["correct"], res["checks"]
