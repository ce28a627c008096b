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

import pytest
import torch

from tame_torch.scripts import (
    bench,
    block_count_probe,
    em_scale_probe,
    fused_block_probe,
    jacobi_scale_probe,
    layout_probe3,
    masked_scale_probe,
    scale_bench,
    smoother_bench,
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


def test_masked_scale_probe_with_packed_mask(monkeypatch):
    monkeypatch.delenv("TAME_PACKED_MASK", raising=False)
    res = masked_scale_probe.main(FIT + ["--num-blocks", "4", "--short", "2",
                                         "--long", "3", "--packed"])
    assert {"dense", "masked_old", "masked_new", "masked_packed",
            "dense_every4", "masked_new_every4", "mse_observed",
            "mse_held_out"} == set(res)
    assert "TAME_PACKED_MASK" not in os.environ  # restored


def test_em_scale_probe_gaussian_leg_and_binary_leg_waits(capsys):
    res = em_scale_probe.main(FIT + ["--n-em", "2", "--inner-max-iter", "4"])
    assert res["em_iters"] == 2
    assert "queue A item 12" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="queue A item 12"):
        em_scale_probe.main(FIT + ["--binary"])


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
