"""CPU tests of the benchmark harness: discovery by name, the metrics'
arithmetic on a synthetic trace, the frozen generator, the window rule, the
frozen roofline counts, the no-JAX check, and tiny runs of every traffic
mix through the port's CPU twins.

    python -m pytest tbench/tests -q
"""

from __future__ import annotations

import copy
import json
import math
import re
import sys
import time
import types

import pytest
import torch

from tbench import datagen, harness, spec, trace
from tbench.reference import judge
from tbench.reference.model import build_params, round_tf32
from tbench.roofline import counts, peaks
from tbench.stream import FitRecord

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ---------------------------------------------------------------------------
# Discovery and the file's shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.load_cell(name)
    # the harness runs one process on one card and starts no ranks
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.checks["limits"]) == set(judge.KEYS)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    reduced = next(c["reduced"] for c in BENCH["configs"]
                   if c["name"] == entry["config"])
    assert sorted(cell.config["reduced"]) == sorted(reduced)
    for key in reduced:
        assert key in cell.config["model"] or key in cell.config["fit"], key
    for key in ("kind", "init", "corrected", "pool", "mask_frac"):
        assert key in cell.traffic
    assert callable(spec.traffic_kind(cell.traffic["kind"]).engine)
    judge.check_cell(cell)


def test_kinds_found_by_name():
    """Every ``tbench/traffic/<kind>.py``: its engine, the program
    functions it wraps and where the fault tests plant their faults, all
    found in the program, and the reference's replay of the kind."""
    import importlib

    kinds = sorted(p.stem for p in (spec.PACKAGE / "traffic").glob("*.py"))
    assert kinds
    for name in kinds:
        kind = spec.traffic_kind(name)
        assert callable(kind.engine)
        assert set(kind.FAULT_TARGETS) == {"step", "fit", "rule"}, name
        for module, fn, *_ in (*kind.WRAPPED, *kind.FAULT_TARGETS.values()):
            assert callable(getattr(importlib.import_module(module), fn))
        ref = spec.reference_kind(name)
        assert callable(ref.check) and callable(ref.start)
        assert ref.iteration_flops(2000, 50, 10, 16) > 0
    with pytest.raises(KeyError):
        spec.traffic_kind("no_such_kind")


@pytest.mark.parametrize("cell_name, group, key, value", [
    ("n2000_smf_cold", "fit", "update_mode", "seq"),
    ("n2000_smf_cold", "fit", "update_mode", "jacobi"),
    ("n2000_smf_cold", "fit", "diag_mode", "stats"),
    ("n2000_smf_cold", "fit", "mixed_precision", True),
    ("n2000_smf_cold", "fit", "tf32", True),
    ("n2000_smf_cold", "fit", "dtype", "bfloat16"),
    ("n2000_smf_cold", "fit", "num_blocks", 8),
    ("n2000_smf_cold", "traffic", "init", "warm"),
    ("n2000_smoothed_warm", "fit", "update_mode", "jacobi"),
    ("n2000_smoothed_warm", "traffic", "init", "random"),
    ("n2000_smoothed_warm", "traffic", "mask_frac", 0.3),
])
def test_reference_refuses_what_it_does_not_replay(cell_name, group, key,
                                                   value):
    """A setting the reference of the cell's kind does not implement stops
    the run before set-up; it is never judged against another fit."""
    cell = spec.load_cell(cell_name)
    if group == "fit":
        cell = cell._replace(config=dict(
            cell.config, fit=dict(cell.config["fit"], **{key: value})))
    else:
        cell = cell._replace(traffic=dict(cell.traffic, **{key: value}))
    with pytest.raises(ValueError, match=key):
        judge.check_cell(cell)
    with pytest.raises(ValueError, match=key):
        harness.run(cell, 1, 0.0, False, torch.device("cpu"),
                    time.perf_counter(), log=lambda line: None)


def test_stream_refuses_a_model_the_program_cannot_hold(monkeypatch):
    """The program's model takes no dyadic variance (it keeps 0.1), and its
    matrix products run without TF32: a configuration that states
    otherwise is refused, not run as another model."""
    from tbench.stream import FitStream

    cell = tiny_cell("demo_fits", 8, 4, 1)
    other = dict(cell.config, model=dict(cell.config["model"],
                                         dyadic_variance=0.2))
    with pytest.raises(ValueError, match="dyadic_variance"):
        FitStream(cell._replace(config=other), 3, torch.device("cpu"))
    FitStream(cell, 3, torch.device("cpu"))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="TF32"):
        FitStream(cell, 3, torch.device("cpu"))


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric))


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("tbench/")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m in BENCH["per_layer"]:
            assert m["moves"] in e2e and "\n" not in m["layer"]
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
        else:
            assert 0.01 <= m["bound"] <= 0.25
            assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


# ---------------------------------------------------------------------------
# The metrics' arithmetic on a synthetic trace
# ---------------------------------------------------------------------------

def _fit(k, n_iter, seconds):
    return FitRecord(index=k, network=k, engine_seed=k, seconds=seconds,
                     n_iter=n_iter, elbo=[0.0] * n_iter, X=None, failed=False,
                     error=None, launches={})


def _synthetic_run(cell_name="n2000_smf_cold"):
    """Two fits of 2 and 3 iterations over a 1,000 us window: K1 launches
    of 5 us, K2 of 10 us, a gemm of 20 us, a permute copy of 20 us and a
    host copy; spans of the engine (900 us in all) and the fit function
    (700 us)."""
    cell = spec.load_cell(cell_name)
    Op = trace.Op
    ops = [Op("void spd_solve_inv_kernel<10, true>(float const*)", 100, 105),
           Op("void spd_solve_inv_kernel<10, true>(float const*)", 110, 115),
           Op("void logdet_thread_kernel<10>(float const*, float*)", 200,
              210),
           Op("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n", 300, 320),
           Op("void at::native::elementwise_kernel<128, 2, direct_copy>"
              "(int)", 310, 330),
           Op("Memcpy DtoH (Device -> Pageable)", 400, 402)]
    spans = [Op("tbench.window", 0, 1000), Op("tbench.engine_init", 0, 100),
             Op("tbench.engine_fit", 100, 900), Op("tbench.fit_fn", 150, 850)]
    data = trace.TraceData(ops=ops, spans=spans, window=(0.0, 1000.0))
    return harness.Run(cell, 12.5, 2.0, [_fit(0, 2, 0.5), _fit(1, 3, 1.5)],
                       data)


def test_end_to_end_readers():
    run = _synthetic_run()
    assert spec.metric_reader("setup_s")(run) == 12.5
    assert spec.metric_reader("fit_s")(run) == 1.0
    assert spec.metric_reader("iter_ms")(run) == pytest.approx(400.0)
    assert spec.metric_reader("fits_per_s")(run) == 1.0


def test_trace_readers():
    run = _synthetic_run()
    read = lambda name: spec.metric_reader(name)(run)  # noqa: E731
    assert read("launches_per_iter") == pytest.approx(5 / 5)
    assert read("iters_per_fit") == pytest.approx(2.5)
    assert read("engine_host_ms_per_fit") == pytest.approx(
        (100 + 800 - 700) * 1e-3 / 2)
    assert read("contract_ms_per_iter") == pytest.approx(40e-3 / 5)
    # busy: [100,105] [110,115] [200,210] [300,330] [400,402] = 52 us
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 52 / 1000))
    b1 = peaks.bound_s(*counts.k1(2000 // 16 * 50, 10))
    assert read("k1_roofline") == pytest.approx(100 * 2 * b1 / 10e-6)
    b2 = peaks.bound_s(*counts.k2(2000 * 50, 10))
    assert read("k2_roofline") == pytest.approx(100 * b2 / 10e-6)
    assert read("k3_roofline") is None and read("k4_roofline") is None
    per_iter, once, flops = counts.iteration(
        2000, 50, 10, counts.fit_flops(2000, 50, 10, 16, 1), False)
    least = sum(peaks.bound_s(once + k * per_iter, k * flops) for k in (2, 3))
    assert read("iter_mfu") == pytest.approx(100 * least / 2.0)


def test_breakdown_names_idle_gaps_by_innermost_span():
    run = _synthetic_run()
    b = trace.breakdown(run.trace)
    ops = dict(b["device_ops"])
    assert ops["elementwise_kernel"] == pytest.approx(20e-6)
    assert ops["spd_solve_inv_kernel"] == pytest.approx(10e-6)
    assert len(ops) == 5
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx((1000 - 52) * 1e-6)
    assert idle["tbench.engine_init"] == pytest.approx(100e-6)
    assert idle["tbench.engine_fit"] == pytest.approx(5e-6)
    assert set(idle) == {"tbench.engine_init", "tbench.engine_fit",
                         "tbench.fit_fn"}


def test_readers_leave_out_what_they_cannot_read():
    run = _synthetic_run()._replace(trace=None)
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"])(run) is None


def test_short_kernel_names():
    assert trace.short_name(
        "void fused_smoother_kernel<10>(float const*, float*)") == \
        "fused_smoother_kernel"
    assert trace.short_name("Memset (Device)") == "Memset"
    assert trace.short_name("void (anonymous namespace)::fused_fit_kernel<6>"
                            "(FusedFitArgs)") == "fused_fit_kernel"


# ---------------------------------------------------------------------------
# The frozen yardstick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("work, bound_ms", [
    (counts.k1(6250, 10), 0.00164),
    (counts.k2(100_000, 10), 0.01206),
    (counts.k4(125, 50, 10), 0.00237),
    (counts.k3(15, 10, 6, 15, 25, 150), 0.000108),
])
def test_roofline_counts_reproduce_the_bring_up_bounds(work, bound_ms):
    assert peaks.bound_s(*work) * 1e3 == pytest.approx(bound_ms, rel=5e-3)


def test_iteration_work_streams_a_network_that_outgrows_the_cache():
    big = counts.iteration(2000, 50, 10, counts.fit_flops(2000, 50, 10, 16, 1),
                           False)
    small = counts.iteration(15, 10, 6, counts.fit_flops(15, 10, 6, 15, 1),
                             False)
    assert big[0] == pytest.approx(4 * (2 * 2000**2 * 50
                                        + 2 * 2000 * 50 * 110))
    assert big[1] == 0 and small[0] == 0 and small[1] > 0
    assert counts.iteration(15, 10, 6, small[2], True)[2] > small[2]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11 + 2**-13,
                      1.0 + 2**-12, -3.0e-5])
    y = round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10 and y[3] == 1.0
    assert y[2] == 1.0 + 2**-9 and torch.equal(round_tf32(y), y)
    assert abs(float(y[4]) + 3.0e-5) < 3.0e-5 * 2**-10


# ---------------------------------------------------------------------------
# The frozen generator
# ---------------------------------------------------------------------------

def _model():
    return spec.load_cell("demo_fits").config["model"]


def test_networks_keep_reciprocity_and_the_seed():
    p = build_params(_model())
    Y, X = datagen.sample_networks(p, torch.Generator().manual_seed(5), 3, 7,
                                   4)
    assert Y.shape == (3, 7, 7, 4, 2) and Y.dtype == torch.float32
    assert X.shape == (3, 7, 4, 6)
    assert torch.equal(Y[..., 1], Y[..., 0].transpose(1, 2))
    idx = torch.arange(7)
    assert torch.all(Y[:, idx, idx] == 0)
    again = datagen.sample_networks(p, torch.Generator().manual_seed(5), 3,
                                    7, 4)
    assert torch.equal(Y, again[0]) and torch.equal(X, again[1])


def test_networks_follow_the_model():
    """On a large draw: the dyads scatter around a_i + b_j + U_i . V_j with
    the configured R (variance 0.1, correlation 0.5 between y_ij and
    y_ji); the first states have covariance Sigma0 and the innovations
    x_t - Phi x_{t-1} covariance Q."""
    p = build_params(_model())
    Y, X = datagen.sample_networks(p, torch.Generator().manual_seed(6), 1,
                                   300, 12)
    Y, X = Y[0].double(), X[0].double()
    a, b, U, V = X[..., 0], X[..., 1], X[..., 2:4], X[..., 4:]
    mu = a[:, None] + b[None, :] + torch.einsum("itr,jtr->ijt", U, V)
    upper = torch.triu(torch.ones(300, 300, dtype=torch.bool), 1)
    e0, e1 = (Y[..., 0] - mu)[upper], (Y[..., 1] - mu.transpose(0, 1))[upper]
    R = torch.cov(torch.stack([e0.ravel(), e1.ravel()]))
    assert torch.allclose(R, p.R, atol=0.004)
    x0 = X[:, 0]
    assert torch.allclose(torch.cov(x0.T), p.Sigma0, atol=0.2)
    innov = (X[:, 1:] - X[:, :-1] @ p.Phi.T).reshape(-1, 6)
    assert torch.allclose(torch.cov(innov.T), p.Q, atol=0.004)


def test_masks_hide_the_asked_share_symmetrically():
    M = datagen.sample_masks(torch.Generator().manual_seed(7), 2, 30, 20,
                             0.3)
    assert torch.equal(M, M.transpose(1, 2))
    idx = torch.arange(30)
    assert torch.all(M[:, idx, idx] == 0)
    off = 2 * 30 * 29 * 20
    assert abs(float(M.sum()) / off - 0.7) < 0.02
    assert set(M.unique().tolist()) == {0.0, 1.0}


# ---------------------------------------------------------------------------
# The window rule, the sample, the stopping rule, the no-JAX check
# ---------------------------------------------------------------------------

class _SlowStream:
    """Fits of fixed durations, in turn."""

    def __init__(self, durations):
        self.durations = durations

    def run_fit(self, k):
        time.sleep(self.durations[k % len(self.durations)])
        return _fit(k, 1, self.durations[k % len(self.durations)])


def test_window_closes_after_the_first_fit_that_ends_late():
    fits, window = harness.run_window(_SlowStream([0.05, 0.2]), 0.1)
    # 0.05, 0.25 -> the second fit ends after 0.1 s and closes the window
    assert len(fits) == 2 and window >= 0.25
    assert window == pytest.approx(sum(f.seconds for f in fits), abs=0.05)
    fits, _ = harness.run_window(_SlowStream([0.01]), 0.0, max_fits=3)
    assert len(fits) == 3


def test_sample_holds_the_longest_fit_and_repeats_with_the_seed():
    fits = [_fit(k, n, 0.1) for k, n in enumerate([5, 9, 3, 9, 7, 2])]
    s = harness.sample_fits(fits, 3, 99)
    assert s[0].index == 1 and len({f.index for f in s}) == 3
    assert [f.index for f in s] == [
        f.index for f in harness.sample_fits(fits, 3, 99)]


def test_elbo_gaps_see_a_few_wrong_iterations_past_the_settling():
    """The median gap passes an ELBO wrong on its last three iterations;
    the widest gap past the settling iterations does not, and leaves the
    settling ones out."""
    ref = [-100.0 - 0.5 * k for k in range(20)]
    X = torch.zeros(3, 2, 4)
    late = [e * (1 + (1e-4 if k >= 17 else 0.0)) for k, e in enumerate(ref)]
    early = [e * (1 + (1e-4 if k < 3 else 0.0)) for k, e in enumerate(ref)]
    fit = {"tolerance": 1e-9, "patience": 3, "max_iter": 20}
    got = judge.fit_numbers(judge.Outcome(X, late), judge.Outcome(X, ref),
                            fit, settle=5)
    assert got["elbo_median_gap"] == 0.0
    assert got["elbo_tail_gap"] == pytest.approx(1e-4)
    got = judge.fit_numbers(judge.Outcome(X, early), judge.Outcome(X, ref),
                            fit, settle=5)
    assert got["elbo_tail_gap"] == 0.0
    short = judge.fit_numbers(judge.Outcome(X, early[:3]),
                              judge.Outcome(X, ref[:3]), fit, settle=5)
    assert short["elbo_tail_gap"] == pytest.approx(1e-4)


def test_stop_rule():
    flat = [-100.0, -50.0, -49.999, -49.998, -49.997, -49.996]
    assert judge.stop_index(flat, 1e-4, 3, 50) == 5
    assert judge.stop_index([-1.0, math.nan], 1e-4, 3, 50) == 2
    assert judge.stop_index([-1.0, -2.0], 1e-4, 3, 2) == 2
    assert judge.stop_index([-1.0, -2.0], 1e-4, 3, 50) == 50


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "tame_torch_fake", types.ModuleType("x"))
    assert "tame_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "tame.models", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax", "tame"]


# ---------------------------------------------------------------------------
# Tiny runs of every traffic mix on the CPU twins
# ---------------------------------------------------------------------------

def tiny_cell(name, n, T, r, pool=3, max_iter=60):
    """A cell of the benchmark at a small size (see :func:`shrink`)."""
    return shrink(spec.load_cell(name), n, T, r, pool, max_iter)


def shrink(cell, n, T, r, pool=3, max_iter=60):
    """``cell`` at a small size: the engines' default block count,
    ``pool`` networks, two traced fits, at most ``max_iter``
    iterations."""
    config = copy.deepcopy(cell.config)
    config["model"].update(n_nodes=n, n_time=T, latent_dim=r)
    config["fit"]["max_iter"] = max_iter
    config["fit"]["num_blocks"] = next(
        k for k in range(min(16, n), 0, -1) if n % k == 0)
    traffic = dict(cell.traffic, pool=pool, draw_batch=pool, trace_fits=2,
                   warmup_fits=1)
    return cell._replace(config=config, traffic=traffic,
                         checks=dict(cell.checks, sample=2))


@pytest.mark.parametrize("name", CELLS + ["demo_fits+mask"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_of_each_cell_is_correct(name, traced):
    """Every cell, and the quick-start cell with 30 % of dyads hidden (the
    generator's masks and the reference's masked terms)."""
    torch.set_num_threads(1)
    cell = tiny_cell(name.split("+")[0], 8, 4, 1)
    if name.endswith("+mask"):
        cell = cell._replace(traffic=dict(cell.traffic, mask_frac=0.3))
    lines = []
    res = harness.run(cell, 2**33 + 5, 0.2, traced, torch.device("cpu"),
                      time.perf_counter(), log=lines.append)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= (2 if traced else 1) and res["failed"] == 0
    assert list(res)[-1] == "checks"
    json.dumps(res)
    want = {m["name"] for m in (cell.per_layer if traced
                                else cell.end_to_end)}
    cpu_only = {"iters_per_fit", "engine_host_ms_per_fit", "iter_mfu",
                "setup_s", "fit_s", "iter_ms"}
    assert want & cpu_only <= set(res["metrics"]) <= want
    assert "path_launches_per_fit" in lines[0]
