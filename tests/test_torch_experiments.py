"""The port's experiment harness and experiments
(``tame_torch.experiments``) against ``tame``'s on the CPU: the harness
utilities on the same inputs (directory tree, JSON summary, report, a
pickle of numpy arrays only), each experiment with the port's draws
patched to ``tame``'s (``tests/_host_parity.py``), the sensitivity
replicates against ``tame.inference.cavi.fit_cavi`` on the same replicate
data, the AUC and U'V-correlation helpers, and the sweep seed's
independence of ``PYTHONHASHSEED`` (ROADMAP C.8).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.experiments.binary_comparison as jbin
import tame.experiments.multiplicative_strength_comparison as jmult
import tame.experiments.three_way_comparison as jthree
import tame.experiments.utils as jutils
import tame_torch.experiments.binary_comparison as tbin
import tame_torch.experiments.multiplicative_strength_comparison as tmult
import tame_torch.experiments.sensitivity_analysis as tsens
import tame_torch.experiments.three_way_comparison as tthree
import tame_torch.experiments.utils as tutils
from _host_parity import rel, share_draws, to_torch
from tame.config import ModelConfig as JConfig
from tame.inference import cavi as jcavi
from tame.models import build_params as jbuild
from tame.models import random_dyad_mask as jmask
from tame.models import sample as jsample
from tame.utils import compute_alignment_error as jalign
from tame_torch.config import ModelConfig as TConfig
from tame_torch.models import build_params as tbuild
from tame_torch.utils import compute_alignment_error as talign

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _results(rng, as_tensor):
    """A results dict with arrays (numpy for tame, tensors for the port,
    one of them requiring grad), histories, timings and a nested list."""
    conv = ((lambda a: torch.from_numpy(a)) if as_tensor
            else (lambda a: a))
    X = rng.standard_normal((6, 3, 6)).astype(np.float32)
    out = {}
    for i, name in enumerate(["Naive MF", "Good SMF"]):
        est = conv(X + 0.1 * (i + 1))
        if as_tensor and i == 1:
            est = est.clone().requires_grad_(True)
        out[name] = {"history": {"elbo": [-10.0 - i, -9.0 - i],
                                 "reconstruction_error": [0.5, 0.3 + i]},
                     "X_est": est, "runtime": 1.25 + i, "iterations": 2,
                     "method_name": name, "scalars": np.float32(0.5),
                     "pair": (np.int64(3), "x")}
    return out, X


class TestHarness:
    def test_directory_tree(self, tmp_path):
        for mod in (jutils, tutils):
            d = mod.setup_experiment_dir("exp", base_dir=str(tmp_path / mod
                                                                .__name__))
            assert d.name.startswith("exp_")
            assert sorted(p.name for p in d.iterdir()) == ["data", "figures"]

    def test_json_summary_equals_tame(self, tmp_path, capsys):
        rng = np.random.default_rng(0)
        jres, _ = _results(rng, False)
        tres, _ = _results(np.random.default_rng(0), True)
        summaries = []
        for mod, res in ((jutils, jres), (tutils, tres)):
            d = mod.setup_experiment_dir("exp", base_dir=str(tmp_path / mod
                                                                .__name__))
            mod.save_results(res, d)
            summaries.append(json.loads((d / "data" / "results.json")
                                        .read_text()))
        assert summaries[0] == summaries[1]
        assert summaries[1]["Good SMF"]["X_est"] is None
        assert "Could not save" not in capsys.readouterr().out

    def test_pickle_holds_numpy_never_tensors(self, tmp_path):
        tres, X = _results(np.random.default_rng(0), True)
        d = tutils.setup_experiment_dir("exp", base_dir=str(tmp_path))
        tutils.save_results(tres, d)
        loaded = tutils.load_results(d)

        def leaves(x):
            if isinstance(x, dict):
                for v in x.values():
                    yield from leaves(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    yield from leaves(v)
            else:
                yield x

        kinds = {type(v) for v in leaves(loaded)}
        assert not any(issubclass(k, torch.Tensor) for k in kinds)
        np.testing.assert_array_equal(loaded["Naive MF"]["X_est"], X + 0.1)
        assert isinstance(loaded["Naive MF"]["pair"], tuple)

    def test_report_equals_tame_apart_from_timestamps(self, tmp_path):
        jres, X = _results(np.random.default_rng(0), False)
        tres, _ = _results(np.random.default_rng(0), True)
        texts = []
        for mod, res, Xt in ((jutils, jres, jnp.asarray(X)),
                             (tutils, tres, torch.from_numpy(X))):
            d = mod.setup_experiment_dir("exp", base_dir=str(tmp_path / mod
                                                                .__name__))
            (d / "figures" / "a.png").write_bytes(b"")
            mod.generate_experiment_report(res, d, X_true=Xt,
                                           experiment_name="E")
            texts.append([
                line for line in (d / "report.md").read_text().splitlines()
                if not line.startswith(("**Generated:**",
                                        "**Output Directory:**",
                                        "*Report generated"))])
        assert len(texts[0]) == len(texts[1])
        for a, b in zip(*texts):
            if a.startswith("| Naive MF |") or a.startswith("| Good SMF |"):
                cells_a, cells_b = a.split("|")[2:-1], b.split("|")[2:-1]
                for x, y in zip(cells_a, cells_b):
                    assert abs(float(x) - float(y)) <= 2e-6, (a, b)
            else:
                assert a == b

    def test_run_method_with_timing(self, capsys):
        from tame_torch.inference import TemporalAMENaiveMFVI
        from tame_torch.models import TemporalAMEModel

        model = TemporalAMEModel(n_nodes=6, n_time=3, device="cpu")
        model.generate_data()
        res = tutils.run_method_with_timing(TemporalAMENaiveMFVI, model,
                                            "Naive", max_iter=5,
                                            learning_rate=0.5)
        assert set(res) == {"vi", "history", "X_est", "runtime",
                            "iterations", "method_name"}
        assert res["iterations"] == 5 and res["runtime"] > 0
        assert "Running: Naive" in capsys.readouterr().out

    def test_set_random_seeds_seeds_numpy(self):
        tutils.set_random_seeds(7)
        a = np.random.rand()
        jutils.set_random_seeds(7)
        assert np.random.rand() == a


def _same_methods(jres, tres, X_true, r, keys=("elbo",
                                                "reconstruction_error")):
    """Per method: iterations, final history values and alignment error
    within 1e-4 relative."""
    assert list(jres) == list(tres)
    for name in jres:
        jh, th = jres[name]["history"], tres[name]["history"]
        assert jres[name]["iterations"] == tres[name]["iterations"], name
        for k in keys:
            if k in jh:
                assert rel(th[k][-1], jh[k][-1]) < 1e-4, (name, k)
        ja, _ = jalign(jres[name]["X_est"], jnp.asarray(X_true),
                       latent_dim=r, align=True)
        ta, _ = talign(tres[name]["X_est"], torch.from_numpy(X_true),
                       latent_dim=r, align=True)
        assert rel(ta, ja) < 1e-4, name


def test_three_way_matches_tame(monkeypatch):
    share_draws(monkeypatch)
    kw = dict(n_nodes=10, n_time=4, max_iter=150, learning_rate=0.7,
              save_outputs=False, verbose=False)
    jres, _ = jthree.run_three_way_comparison(**kw)
    tres, _ = tthree.run_three_way_comparison(**kw, device="cpu")
    _, X = jthree.TemporalAMEModel(n_nodes=10, n_time=4, latent_dim=2,
                                   seed=42).generate_data(
                                       return_latents=True)
    assert list(tres) == ["Naive MF", "Good SMF", "Bad SMF", "Smoothed VI"]
    _same_methods(jres, tres, np.asarray(X), 2)


def test_three_way_saves_numpy_results_and_report(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res, exp_dir = tthree.run_three_way_comparison(
        n_nodes=8, n_time=3, max_iter=10, learning_rate=0.7, verbose=False,
        include_smoothed=False, device="cpu")
    figs = sorted(p.name for p in (exp_dir / "figures").iterdir())
    assert len(figs) == 7 and "three_way_comparison.png" in figs
    assert "## Parameter Recovery" in (exp_dir / "report.md").read_text()
    loaded = tutils.load_results(exp_dir)
    assert isinstance(loaded["Good SMF"]["X_aligned"], np.ndarray)
    assert "vi" not in loaded["Good SMF"]


def test_mult_strength_matches_tame(monkeypatch):
    share_draws(monkeypatch)

    def noise(seed, shape, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        return to_torch(jax.random.normal(key, tuple(shape)), device)

    monkeypatch.setattr(tmult, "_rescale_noise", noise)
    kw = dict(additive_scale=2.0, multiplicative_scale=0.2, n_nodes=10,
              n_time=4, max_iter=30, verbose=False)
    jres, _, jX = jmult.run_experiment("weak", **kw)
    tres, tmodel, tX = tmult.run_experiment("weak", **kw, device="cpu")
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-6)
    _same_methods(jres, tres, np.asarray(jX), 2)
    for name in jres:
        assert rel(tres[name]["alignment_error"],
                   jres[name]["alignment_error"]) < 1e-4
        np.testing.assert_allclose(tres[name]["uv_correlation"],
                                   jres[name]["uv_correlation"], atol=1e-4)


def test_binary_comparison_matches_tame(monkeypatch):
    share_draws(monkeypatch)
    kw = dict(n_nodes=12, n_time=4, max_iter=40, save_outputs=False,
              verbose=False)
    jres, _ = jbin.run_binary_comparison(**kw)
    tres, _ = tbin.run_binary_comparison(**kw, device="cpu")
    assert list(tres) == list(jres)
    for name in jres:
        assert tres[name]["iterations"] == jres[name]["iterations"], name
        assert rel(tres[name]["history"]["elbo"][-1],
                   jres[name]["history"]["elbo"][-1]) < 1e-4, name
        for k in ("holdout_accuracy", "holdout_auc"):
            assert abs(tres[name][k] - jres[name][k]) < 1e-4, (name, k)
        np.testing.assert_allclose(tres[name]["scores"],
                                   jres[name]["scores"], atol=1e-4)


@pytest.mark.parametrize("structure", ["diag", "full"])
@pytest.mark.parametrize("missing", [0.0, 0.3])
def test_sensitivity_replicate_matches_fit_cavi(structure, missing):
    """One replicate of the sweep (Jacobi, the sweep's lr and budget) on
    ``tame``'s replicate data and init: the final MSE and iterations of
    ``tame.inference.cavi.fit_cavi``."""
    kd, ki, km = jax.random.split(jax.random.PRNGKey(3), 3)
    jcfg = JConfig(n_nodes=9, n_time=4, latent_dim=2, seed=42)
    jparams = jbuild(jcfg)
    Y, _ = jsample(jparams, kd, 9, 4)
    init = jcavi.init_state(ki, 9, 4, jcfg.d, structure, 0.1, 0.5)
    mask = jmask(km, 9, 4, missing) if missing else None
    out = jcavi.fit_cavi(Y, jparams, init, structure=structure,
                         update_mode="jacobi", max_iter=150,
                         learning_rate=0.7, mask=mask)
    want = (float(out.mse_history[out.n_iter - 1]), int(out.n_iter))
    tparams = tbuild(TConfig(n_nodes=9, n_time=4, latent_dim=2, seed=42))
    from tame_torch.inference.cavi import CaviState

    got = tsens.fit_replicate(
        to_torch(Y), tparams, CaviState(to_torch(init.X_mean),
                                        to_torch(init.X_cov)),
        structure, 150, 0.7, None if mask is None else to_torch(mask))
    assert got[1] == want[1]
    assert rel(got[0], want[0]) < 1e-4


@pytest.mark.parametrize("parameter,values", [
    ("n_nodes", [6, 8]), ("missing_frac", [0.0, 0.3])])
def test_sensitivity_sweep_end_to_end(parameter, values, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    res, exp_dir = tsens.run_sensitivity_analysis(
        parameter=parameter, values=values, max_iter=20, learning_rate=0.7,
        n_replicates=2, device="cpu")
    for v in values:
        for method in ("Naive MF", "Good SMF"):
            cell = res["data"][v][method]
            assert len(cell["mses"]) == 2 and len(cell["iterations"]) == 2
            assert np.isfinite(cell["mse_mean"])
    assert (exp_dir / "figures" / "sensitivity.png").exists()
    assert "one after another" in (exp_dir / "report.md").read_text()
    again, _ = tsens.run_sensitivity_analysis(
        parameter=parameter, values=values, max_iter=20, learning_rate=0.7,
        n_replicates=2, device="cpu", save_outputs=False)
    assert all(again["data"][v][m]["mses"] == res["data"][v][m]["mses"]
               for v in values for m in ("Naive MF", "Good SMF"))
    with pytest.raises(ValueError, match="Unknown parameter"):
        tsens.run_sensitivity_analysis(parameter="bogus", device="cpu")


def test_sweep_seed_is_stable_across_hash_seeds():
    """ROADMAP C.8: ``tame`` offsets the sweep seed by ``hash(parameter)``,
    which Python randomizes per process; the port's offset is the same in
    every process."""
    probe = ("from tame_torch.experiments.sensitivity_analysis import "
             "sweep_seed\nprint(sweep_seed(42, 'n_nodes'), "
             "42 + hash('n_nodes') % 1000)")
    seen = []
    for hs in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hs, PYTHONPATH=str(REPO))
        proc = subprocess.run([sys.executable, "-c", probe],
                              capture_output=True, text=True, env=env,
                              cwd=REPO, timeout=120)
        assert proc.returncode == 0, proc.stderr
        seen.append(tuple(int(x) for x in proc.stdout.split()))
    assert seen[0][0] == seen[1][0]
    assert seen[0][1] != seen[1][1]  # tame's offset moves with the hash seed


def test_auc_matches_tame():
    rng = np.random.default_rng(1)
    labels = (rng.random(200) > 0.6).astype(np.float64)
    scores = np.round(rng.random(200), 2)  # ties
    assert tbin._auc(scores, labels) == jbin._auc(scores, labels)
    assert np.isnan(tbin._auc(scores, np.zeros(200)))


def test_uv_correlation_over_time_matches_tame():
    rng = np.random.default_rng(2)
    X_true = rng.standard_normal((12, 5, 6)).astype(np.float32)
    X_est = (X_true + 0.3 * rng.standard_normal(X_true.shape)).astype(
        np.float32)
    want = jmult.compute_uv_correlation_over_time(X_est, X_true, 2)
    got = tmult.compute_uv_correlation_over_time(torch.from_numpy(X_est),
                                                 torch.from_numpy(X_true), 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_experiments_default_to_the_card():
    """Each experiment runs on the card unless asked for the CPU; without a
    card the default raises before any work."""
    import inspect

    from tame_torch import demo

    entries = [tthree.run_three_way_comparison, tbin.run_binary_comparison,
               tsens.run_sensitivity_analysis, tmult.run_experiment,
               tmult.main, demo.main]
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        for fn in (lambda: tthree.run_three_way_comparison(
                       save_outputs=False),
                   lambda: tbin.run_binary_comparison(save_outputs=False),
                   lambda: tsens.run_sensitivity_analysis(
                       save_outputs=False),
                   lambda: tmult.run_experiment("s"),
                   lambda: demo.main(outdir="unused")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
