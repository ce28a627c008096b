"""The port's spans and sync counter (``tame_torch.utils.profiling``): what
the fit path records with and without a profiler, the spans' tree and
clock, the Chrome trace they join, the buffer's bound, and, on the card,
the counter against the syncs CUDA's sync debug mode reports.

The file imports no JAX; its card test runs on a GPU host with

    python -m pytest -o addopts="" --noconftest tests/test_torch_tracing.py -m cuda
"""

import json
import warnings

import pytest
import torch
from torch import profiler as tp

from tame_torch import (TemporalAMEModel, TemporalAMESmoothedVI,
                        TemporalAMEStructuredMFVI)
from tame_torch.inference import cavi, smoothed
from tame_torch.utils import profiling

SPAN_NAMES = ("engine.build", "engine.start", "engine.fit", "fit.run",
              "loop.step", "loop.readback")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _syncs():
    return profiling.counters().get(profiling.SYNCS, 0)


def _quick_start(seed=1):
    model = TemporalAMEModel(15, 10, 2, device="cpu", seed=seed)
    model.generate_data()
    return model


def _cpu_profile():
    return tp.profile(activities=[tp.ProfilerActivity.CPU])


ENGINES = {
    "smf_block": lambda m: TemporalAMEStructuredMFVI(
        m, learning_rate=0.7, update_mode="block"),
    "smoothed_warm": lambda m: TemporalAMESmoothedVI(m, init_mode="warm"),
}


def test_no_profiler_records_no_span_but_counts_syncs():
    model = _quick_start()
    before = _syncs()
    hist = ENGINES["smf_block"](model).fit(max_iter=12, verbose=False)
    assert profiling.spans() == []
    assert _syncs() - before == len(hist["elbo"]) == 12
    assert profiling.span("engine.fit") is profiling.span("loop.step")


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_records_its_tree_under_the_profiler(engine):
    """``engine.build`` holds ``engine.start``; ``engine.fit`` holds
    ``fit.run``, which holds one ``loop.step`` and one ``loop.readback``
    an iteration, each readback one ``syncs`` record; each outermost span
    gives its records one fit id."""
    model = _quick_start()
    with _cpu_profile():
        vi = ENGINES[engine](model)
        n_iter = len(vi.fit(max_iter=6, verbose=False)["elbo"])
    recs = profiling.spans()
    idx = {name: [i for i, r in enumerate(recs) if r.name == name]
           for name in SPAN_NAMES + (profiling.SYNCS,)}
    (build,), (start,) = idx["engine.build"], idx["engine.start"]
    (fit,), (run,) = idx["engine.fit"], idx["fit.run"]
    assert recs[build].parent == -1 and recs[start].parent == build
    assert recs[fit].parent == -1 and recs[run].parent == fit
    assert len(idx["loop.step"]) == len(idx["loop.readback"]) == n_iter
    assert all(recs[i].parent == run
               for i in idx["loop.step"] + idx["loop.readback"])
    assert [recs[i].parent for i in idx[profiling.SYNCS]] == \
        idx["loop.readback"]
    assert {recs[i].fit for i in (build, start)} == {recs[build].fit}
    fit_ids = {r.fit for i, r in enumerate(recs) if i not in (build, start)}
    assert fit_ids == {recs[fit].fit} != {recs[build].fit}
    for i, r in enumerate(recs):
        assert r.end_ns >= r.start_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


@pytest.mark.parametrize("update_mode", ["jacobi", "block", "seq"])
def test_unfused_loop_counts_one_sync_an_iteration(update_mode):
    model = _quick_start(2)
    init = cavi.init_state(torch.Generator().manual_seed(3), 15, 10, 6,
                           "full", 0.1, 0.5)
    before = _syncs()
    out = cavi.fit_cavi(model.Y, model.params, init, structure="full",
                        update_mode=update_mode, max_iter=9,
                        learning_rate=0.7, fused=False)
    assert out.n_iter == 9 and _syncs() - before == out.n_iter


def test_smoothed_loop_counts_one_sync_an_iteration():
    model = _quick_start(4)
    init = smoothed.init_smoothed_state(torch.Generator().manual_seed(5),
                                        15, 10, 6)
    before = _syncs()
    out = smoothed.fit_cavi_smoothed(model.Y, model.params, init,
                                     max_iter=7, tolerance=0.0)
    assert out.n_iter == 7 and _syncs() - before == out.n_iter


def _masked_problem(seed=6):
    """A masked quick-start network at the production flags' data: the
    model, a mask hiding 30 % of the dyad-times and a Good-SMF start."""
    from tame_torch.models import random_dyad_mask

    model = _quick_start(seed)
    mask = random_dyad_mask(torch.Generator().manual_seed(seed), 15, 10, 0.3)
    init = cavi.init_state(torch.Generator().manual_seed(seed + 1), 15, 10,
                           6, "full", 0.1, 0.5)
    return model, mask, init


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_fit_inputs_span_once_a_fit(engine):
    """``fit.inputs`` (the weights, the stats constants, the mask's
    layout) is recorded once a fit, inside ``fit.run``."""
    model = _quick_start()
    with _cpu_profile():
        for _ in range(2):
            ENGINES[engine](model).fit(max_iter=4, verbose=False)
    recs = profiling.spans()
    inputs = [r for r in recs if r.name == "fit.inputs"]
    runs = [i for i, r in enumerate(recs) if r.name == "fit.run"]
    assert len(inputs) == len(runs) == 2
    assert [r.parent for r in inputs] == runs


@pytest.mark.parametrize("packed, blocks", [("1", 5), (None, 5), ("1", 3)])
def test_k5_counter_counts_two_stripes_a_block_an_iteration(
        monkeypatch, packed, blocks):
    """A masked block fit with bf16 weights and stats diagnostics counts
    ``k5_contracts`` 2 x ``num_blocks`` an iteration on the K5 route (the
    block phases' partner panels and the diagnostics' moment panel, one
    stripe a block each) and none on the einsum route; under a profiler
    each count is a record."""
    if packed is None:
        monkeypatch.delenv("TAME_PACKED_MASK", raising=False)
    else:
        monkeypatch.setenv("TAME_PACKED_MASK", packed)
    model, mask, init = _masked_problem()
    before = profiling.counters().get(profiling.K5_CONTRACTS, 0)
    with _cpu_profile():
        out = cavi.fit_cavi(model.Y, model.params, init, structure="full",
                            update_mode="block", num_blocks=blocks,
                            max_iter=7, learning_rate=0.8, tolerance=0.0,
                            mixed_precision=True, diag_mode="stats",
                            mask=mask)
    want = 2 * blocks * out.n_iter if packed else 0
    assert out.n_iter == 7
    assert profiling.counters()[profiling.K5_CONTRACTS] - before == want
    assert sum(r.name == profiling.K5_CONTRACTS
               for r in profiling.spans()) == want


def test_spans_share_the_profilers_clock():
    with _cpu_profile() as prof:
        with profiling.span("clock.outer"):
            with tp.record_function("probe"):
                torch.ones(16).sum()
    (rec,) = profiling.spans()
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "probe"]
    assert starts and all(rec.start_ns <= s <= rec.end_ns for s in starts)


def test_no_program_span_reaches_the_profilers_events():
    model = _quick_start()
    with _cpu_profile() as prof:
        ENGINES["smf_block"](model).fit(max_iter=3, verbose=False)
    assert {r.name for r in profiling.spans()} >= set(SPAN_NAMES)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & set(SPAN_NAMES + (profiling.SYNCS,))


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path):
    with _cpu_profile():
        with profiling.span("before.the.trace"):
            pass
    model = _quick_start()
    with profiling.trace(tmp_path / "tr"):
        ENGINES["smf_block"](model).fit(max_iter=3, verbose=False)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "tame_torch"]
    assert [e["name"] for e in ours] == [r.name for r in profiling.spans()]
    assert {e["name"] for e in ours} >= set(SPAN_NAMES)
    theirs = [e for e in events if e.get("ph") == "X"
              and e.get("cat") != "tame_torch"]
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e.get("dur", 0) for e in theirs)
    for e in ours:
        assert lo <= e["ts"] <= e["ts"] + e["dur"] <= hi


def test_buffer_keeps_its_bound_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling._BUFFER, "limit", 5)
    with _cpu_profile():
        with profiling.span("outer"):
            for _ in range(4):
                with profiling.span("inner"):
                    pass
            profiling.count("probe.count", 3)
    recs = profiling.spans()
    assert len(recs) == 5 and profiling.counters()["spans_dropped"] == 3
    assert recs[0].end_ns >= recs[0].start_ns
    profiling.clear_spans()
    assert profiling.counters()["spans_dropped"] == 0


def test_counters_hold_the_kernels_launches():
    out = profiling.counters()
    from tame_torch.ops import cholesky, fused_fit

    assert out["launches.fused_fit_kernel"] == \
        fused_fit.fused_fit_kernel.launches
    assert out["launches.spd_solve_inv_kernel"] == \
        cholesky.spd_solve_inv_kernel.launches


# ---------------------------------------------------------------------------
# On the card: the counter against CUDA's sync debug mode
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA's sync debug mode reports "
                    "the card's syncs)")
    from tame_torch.ops import _ext

    _ext.load()
    return torch.device("cuda")


def _warned_syncs(fn):
    """``(syncs counted, syncs CUDA's debug mode reported)`` over
    ``fn()``."""
    torch.cuda.synchronize()
    before = _syncs()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    warned = sum("called a synchronizing CUDA operation" in str(w.message)
                 for w in caught)
    return _syncs() - before, warned


@pytest.mark.cuda
def test_graph_replays_count_the_k5_contractions(cuda_device):
    """On the card a masked fit under ``mixed_precision`` takes K5 by
    default, and its replayed iterations count their contractions: 2 x 16
    an iteration at n=2000, as many as K5's launches."""
    from tame_torch.models import random_dyad_mask
    from tame_torch.ops import masked_contract

    big = TemporalAMEModel(2000, 50, 4, device=cuda_device, seed=3)
    big.generate_data()
    mask = random_dyad_mask(torch.Generator(device="cuda").manual_seed(1),
                            2000, 50, 0.3)
    before = profiling.counters().get(profiling.K5_CONTRACTS, 0)
    launches = masked_contract.packed_rows_contract_kernel.launches
    graphed = profiling.counters().get(profiling.GRAPHED_ITERS, 0)
    hist = TemporalAMEStructuredMFVI(
        big, learning_rate=0.8, mixed_precision=True, diag_mode="stats",
        mask=mask, seed=2).fit(max_iter=6, tolerance=0.0, verbose=False)
    n_iter = len(hist["elbo"])
    assert n_iter == 6
    assert profiling.counters()[profiling.GRAPHED_ITERS] - graphed == 5
    assert (profiling.counters()[profiling.K5_CONTRACTS] - before
            == masked_contract.packed_rows_contract_kernel.launches
            - launches == 32 * n_iter)


@pytest.mark.cuda
def test_counter_matches_the_cards_syncs(cuda_device):
    big = TemporalAMEModel(2000, 50, 4, device=cuda_device, seed=3)
    big.generate_data()
    init = cavi.init_state(torch.Generator().manual_seed(1), 2000, 50, 10,
                           "full", 0.1, 0.5, device=cuda_device)
    params = big.params.to(cuda_device)
    small = TemporalAMEModel(15, 10, 2, device=cuda_device, seed=4)
    small.generate_data()
    paths = {
        "fit_loop, one n=2000 block iteration": lambda: cavi.fit_cavi(
            big.Y, params, init, structure="full", update_mode="block",
            num_blocks=16, max_iter=1, learning_rate=0.8),
        "warm smoothed engine, one iteration": lambda: TemporalAMESmoothedVI(
            big, init_mode="warm", update_mode="block",
            num_blocks=16).fit(max_iter=1, verbose=False),
        "K3 quick-start engine fit": lambda: TemporalAMEStructuredMFVI(
            small, learning_rate=0.7, seed=9).fit(max_iter=150,
                                                  verbose=False),
    }
    for name, fn in paths.items():
        fn()  # first calls: handles, the kernels' load
        counted, warned = _warned_syncs(fn)
        assert counted == warned > 0, name
