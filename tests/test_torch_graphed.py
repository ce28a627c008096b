"""The fit loops' CUDA graphs (``tame_torch.inference.graphed``): the rule
that engages them, and, on the card, graphed fits against the same loops
run eagerly, bit for bit, in every mode that is graphed.

The file imports no JAX; its card tests run on a GPU host with

    python -m pytest -o addopts="" --noconftest tests/test_torch_graphed.py -m cuda
"""

import warnings

import numpy as np
import pytest
import torch

from tame_torch import TemporalAMEModel, TemporalAMEStructuredMFVI
from tame_torch.inference import cavi, graphed, smoothed
from tame_torch.models import random_dyad_mask
from tame_torch.utils import profiling


def _graphed_iters():
    return profiling.counters().get(profiling.GRAPHED_ITERS, 0)


# ---------------------------------------------------------------------------
# The engage rule (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device, max_iter, capturable, want", [
    ("cuda", 2, True, True), ("cuda:1", 500, True, True),
    ("cpu", 500, True, False), ("cuda", 1, True, False),
    ("cuda", 500, False, False)])
def test_engage_rule(device, max_iter, capturable, want):
    """A card, more than one iteration, a step a capture can hold."""
    assert graphed.engages(torch.device(device), max_iter,
                           capturable) is want


def _quick_start(seed=1):
    model = TemporalAMEModel(12, 5, 1, device="cpu", seed=seed)
    model.generate_data()
    return model


CPU_FITS = {
    "block": lambda m, init: cavi.fit_cavi(
        m.Y, m.params, init, update_mode="block", num_blocks=3, max_iter=6,
        learning_rate=0.7, fused=False),
    "jacobi": lambda m, init: cavi.fit_cavi(
        m.Y, m.params, init, update_mode="jacobi", max_iter=6,
        learning_rate=0.7, elbo_every=2, fused=False),
    "seq": lambda m, init: cavi.fit_cavi(
        m.Y, m.params, init, update_mode="seq", max_iter=4,
        learning_rate=0.7, fused=False),
    "smoothed": lambda m, init: smoothed.fit_cavi_smoothed(
        m.Y, m.params, smoothed.init_smoothed_state(
            torch.Generator().manual_seed(2), 12, 5, 4),
        update_mode="block", num_blocks=3, max_iter=6, tolerance=0.0),
}


@pytest.mark.parametrize("name", sorted(CPU_FITS))
def test_cpu_fits_stay_eager(name, monkeypatch):
    """On the CPU no graph is made and no iteration counts as graphed;
    the loop's results are those of its step functions called in turn."""
    monkeypatch.setattr(graphed, "_card", _no_card)
    model = _quick_start()
    init = cavi.init_state(torch.Generator().manual_seed(3), 12, 5, 4,
                           "full", 0.1, 0.5)
    before = _graphed_iters()
    out = CPU_FITS[name](model, init)
    assert out.n_iter > 1 and _graphed_iters() == before


def _no_card(device):
    raise AssertionError("the eager loop asked for a card's stream")


def test_eager_runner_calls_the_functions_in_turn():
    calls = []
    state = (torch.zeros(2),)

    def step(s):
        calls.append("step")
        return (s[0] + 1,)

    def diag(s):
        calls.append("diag")
        return torch.stack([s[0].sum(), s[0].max()])

    with graphed.LoopRunner(step, diag, state, graphed=False) as loop:
        loop.step()
        loop.step()
        out = loop.diagnostics()
    assert calls == ["step", "step", "diag"]
    assert out.tolist() == [4.0, 2.0] and torch.equal(loop.state[0],
                                                      torch.full((2,), 2.0))


def test_sharded_fit_counts_no_graphed_iters():
    """A sharded fit runs tame_torch.parallel's own eager loop."""
    from tame_torch.parallel import comm, make_mesh, shard_fit_inputs

    assert not comm.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        model = _quick_start(4)
        init = cavi.init_state(torch.Generator().manual_seed(5), 12, 5, 4,
                               "full", 0.1, 0.5)
        Y_s, init_s = shard_fit_inputs(mesh, model.Y, init)
        before = _graphed_iters()
        out = cavi.fit_cavi(Y_s, model.params, init_s, update_mode="block",
                            num_blocks=3, max_iter=5, learning_rate=0.7)
        assert out.n_iter == 5 and _graphed_iters() == before
    finally:
        comm.destroy()


# ---------------------------------------------------------------------------
# On the card: graphed fits against the eager loop
# ---------------------------------------------------------------------------

N, T, R = 48, 6, 2
D = 2 + 2 * R


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the graphs are CUDA graphs)")
    from tame_torch.ops import _ext

    _ext.load()
    dev = torch.device("cuda")
    model = TemporalAMEModel(N, T, R, device=dev, seed=7)
    model.generate_data()
    mask = random_dyad_mask(torch.Generator(device=dev).manual_seed(8), N,
                            T, 0.3)
    return dev, model, model.params.to(dev), mask


def _cavi_init(dev, seed=3):
    return cavi.init_state(torch.Generator().manual_seed(seed), N, T, D,
                           "full", 0.1, 0.5, device=dev)


def _smoothed_init(dev, seed=4):
    return smoothed.init_smoothed_state(torch.Generator().manual_seed(seed),
                                        N, T, D, device=dev)


def _fit(Y, params, init, **kw):
    base = dict(structure="full", update_mode="block", num_blocks=4,
                max_iter=25, learning_rate=0.8, fused=False)
    return cavi.fit_cavi(Y, params, init, **{**base, **kw})


def _smooth(Y, params, init, **kw):
    base = dict(update_mode="block", num_blocks=4, max_iter=12)
    return smoothed.fit_cavi_smoothed(Y, params, init, **{**base, **kw})


# name -> (fit function, init function, whether all iterations but the
# first are graphed (else none), environment)
CASES = {
    "block": (lambda m, p, k, i: _fit(m.Y, p, i), _cavi_init, True, {}),
    "jacobi": (lambda m, p, k, i: _fit(m.Y, p, i, update_mode="jacobi",
                                       learning_rate=0.5),
               _cavi_init, True, {}),
    "masked_einsum": (lambda m, p, k, i: _fit(m.Y, p, i, mask=k),
                      _cavi_init, True, {}),
    "masked_k5": (lambda m, p, k, i: _fit(m.Y, p, i, mask=k), _cavi_init,
                  True, {"TAME_PACKED_MASK": "1"}),
    "mixed_precision": (lambda m, p, k, i: _fit(m.Y, p, i, mask=k,
                                                mixed_precision=True),
                        _cavi_init, True, {}),
    "stats": (lambda m, p, k, i: _fit(m.Y, p, i, diag_mode="stats",
                                      corrected=True),
              _cavi_init, True, {}),
    "stats_masked": (lambda m, p, k, i: _fit(m.Y, p, i, mask=k,
                                             diag_mode="stats"),
                     _cavi_init, True, {}),
    "elbo_every_2": (lambda m, p, k, i: _fit(m.Y, p, i, elbo_every=2,
                                             max_iter=21),
                     _cavi_init, True, {}),
    "seq": (lambda m, p, k, i: _fit(m.Y, p, i, update_mode="seq",
                                    learning_rate=0.7, max_iter=8,
                                    tolerance=0.0),
            _cavi_init, True, {}),
    "smoothed_block_k4": (lambda m, p, k, i: _smooth(m.Y, p, i),
                          _smoothed_init, True, {}),
    # the associative-scan smoother stays eager
    "smoothed_parallel_block": (lambda m, p, k, i: _smooth(
        m.Y, p, i, smoother="parallel"), _smoothed_init, False, {}),
    "smoothed_jacobi_masked": (lambda m, p, k, i: _smooth(
        m.Y, p, i, update_mode="jacobi", mask=k), _smoothed_init, True, {}),
    "stop_at_iteration_1": (lambda m, p, k, i: _fit(
        m.Y, p, i, carry_elbo=-1e30, tolerance=1e30, patience=1),
        _cavi_init, False, {}),
    "max_iter_1": (lambda m, p, k, i: _fit(m.Y, p, i, max_iter=1),
                   _cavi_init, False, {}),
}


def _eager(monkeypatch):
    monkeypatch.setattr(graphed, "engages", lambda *a, **k: False)


def _same(a, b):
    """Bit for bit: tensors (NaN where NaN), then the scalars."""
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _same(x, y)
        elif torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x.cpu().numpy(), y.cpu().numpy(),
                                  equal_nan=True)
        else:
            assert x == y or (x != x and y != y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_graphed_fit_is_the_eager_fit(card, name, monkeypatch):
    dev, model, params, mask = card
    fit, init_fn, graphs, env = CASES[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    counts = []
    outs = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                _eager(m)
            before = (_graphed_iters(), dict(profiling.counters()))
            outs.append(fit(model, params, mask, init_fn(dev)))
            torch.cuda.synchronize()
            after = profiling.counters()
            counts.append((after.get(profiling.GRAPHED_ITERS, 0) - before[0],
                           {k: after[k] - before[1].get(k, 0) for k in after
                            if k.startswith("launches.")}))
    graphed_out, eager_out = outs
    _same(graphed_out, eager_out)
    n_iter = graphed_out.n_iter
    assert counts[1][0] == 0
    assert counts[0][0] == (n_iter - 1 if graphs else 0)
    if graphs:
        assert n_iter > 2
    # each replay counts the launches of its capture: the same as eager
    assert counts[0][1] == counts[1][1]


@pytest.mark.cuda
def test_checkpointed_fit_resumes_at_the_same_stop(card, tmp_path,
                                                   monkeypatch):
    """A masked engine fit (no K3) in segments of 4 iterations, one capture
    each, killed after 8 and resumed: the one-shot eager fit's bits and
    stop."""
    dev, model, params, mask = card

    def engine():
        return TemporalAMEStructuredMFVI(model, learning_rate=0.8, seed=11,
                                         update_mode="block", mask=mask)

    with monkeypatch.context() as m:
        _eager(m)
        one_shot = engine()
        ref = one_shot.fit(max_iter=60, verbose=False)
    before = _graphed_iters()
    first = engine()
    first.fit(max_iter=8, checkpoint_every=4, ckpt_dir=tmp_path / "a",
              verbose=False)
    assert _graphed_iters() - before == 2 * 3
    resumed = engine()
    hist = resumed.fit(max_iter=60, checkpoint_every=4,
                       ckpt_dir=tmp_path / "a", resume=True, verbose=False)
    assert len(ref["elbo"]) < 60 and hist == ref
    assert torch.equal(resumed.X_mean, one_shot.X_mean)
    assert torch.equal(resumed.X_cov, one_shot.X_cov)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["block", "smoothed_block_k4"])
def test_graphed_fit_under_the_profiler(card, name):
    """Captured and replayed while torch.profiler traces the card: the
    same bits, and every replayed solve on the device's timeline."""
    from torch import profiler as tp

    dev, model, params, mask = card
    fit, init_fn, _, _ = CASES[name]
    plain = fit(model, params, mask, init_fn(dev))
    acts = [tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]
    with tp.profile(activities=acts) as prof:
        traced = fit(model, params, mask, init_fn(dev))
        torch.cuda.synchronize()
    _same(traced, plain)
    solver = ("spd_solve_inv_kernel" if name == "block"
              else "fused_smoother_kernel")
    solves = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and solver in e.name()]
    assert len(solves) == 4 * traced.n_iter  # 4 blocks an iteration


@pytest.mark.cuda
def test_sync_counter_over_a_graphed_fit(card):
    """The counter rises by the syncs CUDA's sync debug mode reports over
    a graphed fit, capture included."""
    dev, model, params, mask = card
    init = _cavi_init(dev)
    _fit(model.Y, params, init, max_iter=3)  # handles, the kernels' load
    torch.cuda.synchronize()
    before = profiling.counters().get(profiling.SYNCS, 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = _fit(model.Y, params, init, max_iter=10, tolerance=0.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    warned = sum("called a synchronizing CUDA operation" in str(w.message)
                 for w in caught)
    counted = profiling.counters().get(profiling.SYNCS, 0) - before
    assert out.n_iter == 10 and counted == warned >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["block", "jacobi", "masked_k5",
                                  "mixed_precision", "stats_masked", "seq",
                                  "smoothed_block_k4",
                                  "smoothed_jacobi_masked"])
def test_graphed_steps_make_no_sync(card, name, monkeypatch):
    """Every graphed mode's step and diagnostics run under CUDA's sync
    debug mode set to raise."""
    dev, model, params, mask = card
    fit, init_fn, _, env = CASES[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    fit(model, params, mask, init_fn(dev))  # first calls: handles, loads
    real = graphed.LoopRunner

    class Checked(real):
        def step(self):
            with _sync_errors():
                super().step()

        def diagnostics(self):
            with _sync_errors():
                return super().diagnostics()

    monkeypatch.setattr(graphed, "LoopRunner", Checked)
    out = fit(model, params, mask, init_fn(dev))
    assert out.n_iter > 2


class _sync_errors:
    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        return False
