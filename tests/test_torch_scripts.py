"""The port's measurement scripts (``tame_torch.scripts``) and profiling
utilities, run through their ``main`` on the CPU at tiny sizes: each runs
end to end, the benchmark prints one JSON line with ``bench.py``'s keys, a
failing leg raises instead of printing, and nothing is written but what
the caller asks for.  Their numbers here are CPU host-clock times and mean
nothing; the card runs them at full size.
"""

import json
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from tame_torch.scripts import (
    bench,
    binary_scale_probe,
    block_count_probe,
    contract_probe,
    em_scale_probe,
    fused_block_probe,
    jacobi_scale_probe,
    layout_probe3,
    masked_scale_probe,
    mcmc_bench,
    poisson_scale_probe,
    ptridiag_bench,
    scale_bench,
    seq_probe,
    smc_bench,
    smoother_bench,
    spd_probe,
)
from tame_torch.utils import profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
FIT = CPU + ["--n", "12", "--T", "3", "--r", "1"]
BENCH = FIT + ["--n-fits", "1", "--repeats", "1", "--num-blocks", "4",
               "--max-iter", "12"]


def _bench_py_keys():
    """The JSON keys ``bench.py`` prints, read from its source."""
    src = (REPO / "bench.py").read_text()
    keys = set(re.findall(r'"(n2000_\w+)"', src))
    keys |= {k for k in ("metric", "value", "unit", "vs_baseline")
             if f'"{k}"' in src}
    return keys


class TestBench:
    def test_one_json_line_with_bench_py_keys(self, capsys):
        line = bench.main(BENCH)
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1 and json.loads(out[0]) == line
        assert set(line) == _bench_py_keys()
        assert len(_bench_py_keys()) == 15
        assert line["metric"] == "good_smf_elbo_iterations_per_s"
        assert line["unit"] == "iter/s"
        assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(
            line["value"] / 4.81)
        assert line["n2000_iters"] == 12 and line["n2000_smoothed_iters"] > 0

    def test_a_failing_leg_raises_and_prints_no_line(self, capsys,
                                                     monkeypatch):
        def broken(*args, **kw):
            raise RuntimeError("smoothed leg broke")

        monkeypatch.setattr(bench, "fit_cavi_smoothed", broken)
        with pytest.raises(RuntimeError, match="smoothed leg broke"):
            bench.main(BENCH)
        assert "{" not in capsys.readouterr().out

    def test_demo_fits_must_run_every_iteration(self, monkeypatch):
        real = bench.cavi.fit_cavi

        def short(*args, **kw):
            return real(*args, **{**kw, "max_iter": 3})

        monkeypatch.setattr(bench.cavi, "fit_cavi", short)
        with pytest.raises(RuntimeError, match="not 150"):
            bench.main(BENCH)


def test_scale_bench_writes_only_its_out_path(tmp_path, monkeypatch,
                                              capsys):
    tracked = REPO / "scale_bench_result.json"
    before = tracked.read_bytes()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "result.json"
    rec = scale_bench.main(FIT + ["--num-blocks", "4", "--max-iter", "6",
                                  "--repeats", "1", "--out", str(out)])
    assert [p.name for p in tmp_path.iterdir()] == ["result.json"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert [r["variant"] for r in rec["runs"]] == ["mixed+stats dense",
                                                   "f32 exact dense"]
    assert tracked.read_bytes() == before
    assert '"config"' not in capsys.readouterr().out  # it went to --out
    scale_bench.main(FIT + ["--num-blocks", "4", "--max-iter", "6",
                            "--repeats", "1"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["config"]["n"] == 12
    assert [p.name for p in tmp_path.iterdir()] == ["result.json"]


def test_layout_probe_runs_four_variants(capsys):
    res = layout_probe3.main(CPU + ["--N", "24", "--T", "2", "--R", "3",
                                    "--K", "2", "--repeats", "1"])
    assert len(res["variants"]) == 4
    assert all(v["ms_per_pass"] > 0 for v in res["variants"].values())
    assert res["k7_launches"] == 0 and res["k7_rel_err"] == 0.0
    assert "K7 twin on the CPU" in capsys.readouterr().out


def test_smoother_bench(capsys):
    res = smoother_bench.main(CPU + ["--n", "3", "--T", "4", "--d", "14",
                                     "--repeats", "1"])
    assert set(res["rel_err"]) == {"mean", "cov", "cross_cov", "logdet"}
    assert "rel err" in capsys.readouterr().out


def test_ptridiag_bench(capsys):
    rows = ptridiag_bench.main(CPU + ["--sizes", "3x5,2x17"])
    assert [(r["n"], r["T"]) for r in rows] == [(3, 5), (2, 17)]
    assert all(r["max_abs_dmean"] <= ptridiag_bench.MEAN_ATOL
               and r["sequential_ms"] > 0 and r["parallel_ms"] > 0
               for r in rows)
    assert "max|dmean|" in capsys.readouterr().out


def test_sampler_benches_write_only_their_out_path(tmp_path, monkeypatch,
                                                   capsys):
    """``mcmc_bench`` and ``smc_bench`` at tiny sizes: their JSON keys, and
    no file but ``--out`` (never the root ``MCMC_BENCH.json`` /
    ``SMC_BENCH.json``)."""
    tracked = {name: (REPO / name).read_bytes()
               for name in ("MCMC_BENCH.json", "SMC_BENCH.json")}
    monkeypatch.chdir(tmp_path)
    tiny = CPU + ["--n", "6", "--T", "3", "--r", "1"]
    res = mcmc_bench.main(tiny + ["--chains", "2", "--warmup", "4",
                                  "--samples", "6", "--max-depth", "3",
                                  "--k-scalars", "5"])
    assert res["transitions"] == 10 and res["syncs_per_transition"] > 0
    assert res["total_draws"] == 12 and res["config"]["k_scalars"] == 5
    for key in ("ess_per_s_median", "logdensity_rhat",
                "smf_effect_size_median", "smoothed_effect_size_median"):
        assert np.isfinite(res[key]), key
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "smc.json"
    res = smc_bench.main(tiny + ["--particles", "16", "--buffer", "40",
                                 "--moves", "1", "--leapfrog", "2",
                                 "--replicates", "2", "--stages-per-call",
                                 "3", "--out", str(out)])
    assert [p.name for p in tmp_path.iterdir()] == ["smc.json"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert len(res["wall_s_per_replicate"]) == 2
    assert np.isfinite(res["log_evidence_mean"] - res["exact_elbo"])
    assert all(tracked[name] == (REPO / name).read_bytes()
               for name in tracked)
    assert "EVIDENCE" in capsys.readouterr().out


def test_masked_scale_probe_with_packed_mask(monkeypatch):
    monkeypatch.delenv("TAME_PACKED_MASK", raising=False)
    res = masked_scale_probe.main(FIT + ["--num-blocks", "4", "--short", "2",
                                         "--long", "3", "--packed"])
    assert {"dense", "masked_old", "masked_new", "masked_packed",
            "dense_every4", "masked_new_every4", "mse_observed",
            "mse_held_out"} == set(res)
    assert "TAME_PACKED_MASK" not in os.environ  # restored


def test_em_scale_probe_gaussian_leg_and_binary_leg_waits(capsys):
    """Both legs run: the Gaussian one and the binary one (``--binary``,
    the smoothed Bernoulli E-step) at tiny size."""
    res = em_scale_probe.main(FIT + ["--n-em", "2", "--inner-max-iter", "4"])
    assert res["em_iters"] == 2 and res["leg"] == "Gaussian"
    res = em_scale_probe.main(FIT + ["--n-em", "2", "--inner-max-iter", "4",
                                     "--binary"])
    assert res["em_iters"] == 2 and res["leg"] == "binary"
    assert res["sigma2"] == pytest.approx(0.1)  # R is not learned
    out = capsys.readouterr().out
    assert "fit_em binary n=12 T=3 r=1" in out and "queue A" not in out


@pytest.mark.parametrize("probe,keys", [
    (binary_scale_probe, {"accuracy"}),
    (poisson_scale_probe, {"deviance", "diverged", "step_scale",
                           "rejected"})])
def test_family_scale_probes(probe, keys):
    res = probe.main(FIT + ["--short", "2", "--long", "3",
                            "--profile-iters", "1"])
    assert {"ms_per_iter", "predictor_corr", "n_iter", "profile"} | keys \
        <= set(res)
    assert res["n_iter"] == 3 and -1.0 <= res["predictor_corr"] <= 1.0
    # the CPU has no device time to split
    assert res["profile"]["device_ms_per_iter"] is None


def test_block_count_and_jacobi_probes():
    res = block_count_probe.main(FIT + ["--blocks", "2,4", "--short", "2",
                                        "--long", "3", "--max-iter", "8"])
    assert set(res) == {2, 4} and all(r["iters"] > 0 for r in res.values())
    res = jacobi_scale_probe.main(FIT + ["--iters", "6", "--num-blocks",
                                         "4"])
    assert list(res) == ["block lr=0.8", "jacobi lr=0.8", "jacobi lr=0.5",
                         "jacobi lr=0.3"]


def test_fused_block_probe_matches_the_unfused_loop():
    res = fused_block_probe.main(CPU + ["--sizes", "6", "--T", "3",
                                        "--max-iter", "4"])
    assert res[6]["elbo_rel_err"] < 1e-4 and res[6]["k3_launches"] == 0


def test_spd_probe_times_the_twins_and_the_r6_paths(tmp_path, capsys):
    out = tmp_path / "spd.json"
    res = spd_probe.main(CPU + ["--dims", "4", "48", "--batches", "3", "17",
                                "--k2-dims", "14", "--k2-batch", "9",
                                "--repeats", "1", "--fits", "--fit-n", "8",
                                "--fit-T", "3", "--fit-iters", "2", "--tag",
                                "cpu", "--out", str(out)])
    assert [(r["d"], r["B"]) for r in res["k1"]] == [(4, 3), (4, 17),
                                                     (48, 3), (48, 17)]
    assert [(r["d"], r["B"]) for r in res["k2"]] == [(14, 9)]
    assert all(r["twin_host_ms"] > 0 and "ms" not in r
               for r in res["k1"] + res["k2"])
    # no kernel on the CPU: the Good-SMF fit runs K1's twin
    assert set(res["fits"]) == {"r6_good_smf", "r6_smoothed"}
    assert all(f["k1_launches"] == 0 and f["ms_per_iter"] > 0
               for f in res["fits"].values())
    assert json.loads(out.read_text()) == res
    assert "cpu K1" in capsys.readouterr().out
    # the bound: K1 with the inverse at d = 10, B = 6,250 moves 2.75 MB
    b = spd_probe.bound_ms(10, 6250, "inv")
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(6250 * 2 * 110 * 4 / 3.35e12 * 1e3)


def test_spd_probe_compares_outputs_bit_for_bit():
    a = {"d=4 B=3": {"mu": torch.tensor([1.0, 2.0]),
                     "logdet": torch.tensor([0.5])}}
    b = {"d=4 B=3": {"mu": torch.tensor([1.0, 2.25]),
                     "logdet": torch.tensor([0.5])}}
    assert spd_probe.compare_bits(a, a) == {"d=4 B=3": {"mu": True,
                                                        "logdet": True}}
    assert spd_probe.compare_bits(a, b) == {"d=4 B=3": {"mu": 0.25,
                                                        "logdet": True}}


def test_contract_probe_times_the_twins(tmp_path, capsys):
    out, bits = tmp_path / "contract.json", tmp_path / "bits.pt"
    res = contract_probe.main(CPU + ["--n", "32", "--T", "2", "--k6", "2,20,4",
                                     "2,37,40", "--repeats", "1", "--tag",
                                     "cpu", "--out", str(out), "--bits-out",
                                     str(bits), "--bits-against", str(bits)])
    assert [(r["T"], r["n"], r["m"]) for r in res["k6"]] == [(2, 20, 4),
                                                             (2, 37, 40)]
    assert [r["case"] for r in res["k5"]] == [
        "n=32 bs=2 K=57", "n=32 bs=2 K=56", "n=20 T=3 K=5 nb=4",
        "n=32 one stripe K=57"]
    assert [r["stripes"] for r in res["k5"]] == [16, 16, 4, 1]
    assert all(r["twin_host_ms"] > 0 and "ms" not in r
               for r in res["k6"] + res["k5"])
    # the same tree against itself: every output equal bit for bit
    assert all(v is True for case in res["bits"].values()
               for v in case.values())
    assert len(res["bits"]) == 6
    assert json.loads(out.read_text()) == res
    assert "cpu K5" in capsys.readouterr().out


def test_contract_probe_compares_outputs_bit_for_bit():
    a = {"K5 x": {"stripe 0": torch.tensor([1.0, 2.0])},
         "K6 y": {"row": torch.tensor([0.5]), "col": torch.tensor([3.0])}}
    b = {"K5 x": {"stripe 0": torch.tensor([1.0, 2.5])}}
    assert contract_probe.compare_bits(a, a) == {
        "K5 x": {"stripe 0": True}, "K6 y": {"row": True, "col": True}}
    # a case the other tree did not save (an m its K6 refused) is left out
    assert contract_probe.compare_bits(a, b) == {"K5 x": {"stripe 0": 0.5}}


def test_seq_probe_times_the_sweep_and_a_save(tmp_path, capsys):
    out = tmp_path / "ck"
    res = seq_probe.main(CPU + ["--n", "5", "--T", "3", "--r", "1",
                                "--iters", "2", "--ckpt-n", "12",
                                "--ckpt-T", "3", "--repeats", "1",
                                "--out-dir", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert set(res["seq"]) == {"diag", "full", "block"}
    assert all(v["ms_per_iter"] > 0 for v in res["seq"].values())
    # no card: the profiler sees no device time, and says so
    assert res["seq"]["full"]["device_ms_per_iter"] is None
    ck = res["checkpoint"]
    assert ck["save_ms"] > 0 and ck["size_mb"] > 0
    assert not out.exists()  # the probe removes what it wrote


def test_scripts_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        layout_probe3.main(["--N", "8"])


class TestProfiling:
    def test_benchmark_on_the_host_clock(self):
        calls = []
        t = profiling.benchmark(calls.append, 1, warmup=2, repeats=3,
                                on_card=False)
        assert len(calls) == 5 and t["repeats"] == 3
        assert t["clock"] == "host" and t["best_s"] <= t["median_s"]

    def test_metrics_logger_round_trip(self, tmp_path):
        path = tmp_path / "m" / "log.jsonl"
        with profiling.MetricsLogger(path) as log:
            profiling.log_fit_history(log, {"elbo": [1.0, 2.0],
                                            "mse": [torch.tensor(0.5)]})
        rows = profiling.MetricsLogger.read(path)
        assert [r["step"] for r in rows] == [0, 1]
        assert rows[0]["mse"] == 0.5 and "mse" not in rows[1]

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(tmp_path / "tr") as prof:
            torch.ones(8).sum()
        assert (tmp_path / "tr" / "trace.json").exists()
        assert prof.key_averages() is not None
