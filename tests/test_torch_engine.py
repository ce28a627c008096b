"""The port's public surface end to end on the CPU: model sampling, the
three engines on the demo configuration (the pattern ``chip_smoke.py``
asserts on the card), the engine API, and that ``tame_torch`` imports with
JAX unavailable.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

import tame_torch
from tame_torch import (
    InferenceConfig,
    TemporalAMECaviVI,
    TemporalAMEModel,
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)
from tame_torch.ops import cholesky as tchol
from tame_torch.ops import fused_fit as tff

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPT_MODULES = sorted(
    f"tame_torch.scripts.{p.stem}"
    for p in (REPO / "tame_torch" / "scripts").glob("*.py")
    if p.stem != "__init__")


def demo_pattern(mse):
    """The demo drive's expected pattern: Naive ~ Good at a low MSE, Bad
    blown up.  ``mse`` maps name -> (final MSE, diverged)."""
    (naive, _), (good, _), (bad, bad_div) = (mse["naive"], mse["good"],
                                             mse["bad"])
    assert naive < 0.5 and good < 0.5, mse
    assert abs(naive - good) < 0.05, mse
    assert bad_div or (bad > 1.0 and bad > 3.0 * good), mse


class TestModel:
    def test_reciprocal_layout_and_shapes(self):
        model = TemporalAMEModel(n_nodes=7, n_time=4, latent_dim=2, seed=3,
                                 device="cpu")
        Y, X = model.generate_data(return_latents=True)
        assert Y.shape == (7, 7, 4, 2) and X.shape == (7, 4, 6)
        assert torch.equal(Y[..., 1], Y[..., 0].transpose(0, 1))
        assert (Y[torch.arange(7), torch.arange(7)] == 0).all()
        assert model.Y is Y and model.X is X

    def test_defaults_to_the_card(self):
        """The model's generator and data live on the card unless the
        caller asks for the CPU; without a card that default raises."""
        if torch.cuda.is_available():
            model = TemporalAMEModel(n_nodes=4, n_time=2)
            assert model.generate_data().is_cuda
        else:
            with pytest.raises(RuntimeError, match="needs a CUDA device"):
                TemporalAMEModel(n_nodes=4, n_time=2)
        cpu = TemporalAMEModel(n_nodes=4, n_time=2, device="cpu")
        assert cpu.generate_data().device.type == "cpu"

    def test_seeded_and_fresh_draws(self):
        a = TemporalAMEModel(n_nodes=5, n_time=3, seed=11,
                             device="cpu").generate_data()
        m = TemporalAMEModel(n_nodes=5, n_time=3, seed=11, device="cpu")
        assert torch.equal(m.generate_data(), a)
        assert not torch.equal(m.generate_data(), a)  # generator advanced
        g = torch.Generator().manual_seed(11)
        assert torch.equal(m.generate_data(generator=g), a)

    def test_noise_floor(self):
        """Residuals around the true mean have the model's dyadic variance
        (0.1): a distributional check, as the random streams differ from
        the JAX package's."""
        model = TemporalAMEModel(n_nodes=30, n_time=5, seed=0, device="cpu")
        Y, X = model.generate_data(return_latents=True)
        mse = model.compute_temporal_reconstruction_error(X)
        assert abs(mse - 0.2) < 0.02  # per-dyad (2 entries) normalization


class TestEngines:
    @pytest.fixture(scope="class")
    def demo_model(self):
        model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2,
                                 seed=42, device="cpu")
        model.generate_data(generator=torch.Generator().manual_seed(42))
        return model

    def test_demo_drive_pattern(self, demo_model):
        launches = (tff.fused_fit_kernel.launches,
                    tchol.spd_solve_inv_kernel.launches)
        mse = {}
        for name, vi in [
                ("naive", TemporalAMENaiveMFVI(demo_model,
                                               learning_rate=0.7)),
                ("good", TemporalAMEStructuredMFVI(
                    demo_model, factorization="good", learning_rate=0.7)),
                ("bad", TemporalAMEStructuredMFVI(
                    demo_model, factorization="bad", learning_rate=0.7))]:
            h = vi.fit(max_iter=150, verbose=False)
            assert len(h["elbo"]) == len(h["reconstruction_error"]) <= 150
            mse[name] = (h["reconstruction_error"][-1], vi._diverged)
        demo_pattern(mse)
        # CPU tensors take the twins: no kernel launched
        assert (tff.fused_fit_kernel.launches,
                tchol.spd_solve_inv_kernel.launches) == launches

    def test_engine_surface(self, demo_model, capsys):
        vi = TemporalAMEStructuredMFVI(demo_model, learning_rate=0.7)
        assert vi.get_factorization_type() == "good"
        assert vi.structure == "full"
        h = vi.fit(max_iter=5, verbose=True, check_every=2)
        assert "Iter    4" in capsys.readouterr().out
        assert vi.get_elbo_history() is h["elbo"] and len(h["elbo"]) == 5
        assert vi.get_variational_means().shape == (15, 10, 6)
        assert vi.get_variational_covariances().shape == (15, 10, 6, 6)
        assert dict(vi.named_buffers()).keys() == {"X_mean", "X_cov"}
        vi.fit(max_iter=3, verbose=False)
        assert len(vi.get_reconstruction_history()) == 8

    def test_from_config_and_validation(self, demo_model):
        cfg = InferenceConfig(structure="block", learning_rate=0.5)
        vi = TemporalAMEStructuredMFVI.from_config(demo_model, cfg)
        assert vi.factorization == "bad" and vi.lr == 0.5
        generic = TemporalAMECaviVI.from_config(demo_model, cfg)
        assert generic.structure == "block"
        with pytest.raises(ValueError):
            TemporalAMEStructuredMFVI(demo_model, factorization="ugly")
        with pytest.raises(NotImplementedError):
            TemporalAMENaiveMFVI(demo_model, update_mode="seq")
        with pytest.raises(ValueError):
            TemporalAMENaiveMFVI(TemporalAMEModel(n_nodes=4, n_time=2,
                                                  device="cpu"))

    def test_naive_keeps_diagonal_and_bad_keeps_zero_cross_blocks(
            self, demo_model):
        naive = TemporalAMENaiveMFVI(demo_model, learning_rate=0.7)
        naive.fit(max_iter=4, verbose=False)
        cov = naive.X_cov
        assert torch.equal(cov, torch.diag_embed(
            torch.diagonal(cov, dim1=-2, dim2=-1)))
        bad = TemporalAMEStructuredMFVI(demo_model, factorization="bad",
                                        learning_rate=0.7)
        bad.fit(max_iter=4, verbose=False)
        assert (bad.X_cov[..., :2, 2:] == 0).all()


class TestPackage:
    def test_imports_without_jax(self):
        code = ("import sys; sys.modules['jax'] = None; "
                "import tame_torch, tame_torch.ops.fused_fit as ff; "
                "import tame_torch.ops.fused_smoother as fs; "
                "import tame_torch.inference.smoothed, "
                "tame_torch.inference.em, tame_torch.inference.evidence; "
                "import tame_torch.ops.eta_contract, "
                "tame_torch.utils.profiling; "
                f"import {', '.join(SCRIPT_MODULES)}; "
                "assert 'tame' not in sys.modules; "
                "print(ff.fused_fit_supported(15, 10, 6, structure='full', "
                "update_mode='block', diag_mode='exact', elbo_every=1, "
                "num_blocks=15), fs.fused_smoother_supported(2000, 50, 10))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "True True"

    def test_tf32_off(self):
        assert tame_torch.__version__
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32

    def test_no_jax_or_tame_import_in_port_sources(self):
        import re

        pattern = re.compile(r"^\s*(import|from)\s+(jax|tame)\b", re.M)
        files = list((REPO / "tame_torch").rglob("*.py")) + [
            REPO / "chip_smoke.py"]
        hits = [str(f) for f in files if pattern.search(f.read_text())]
        assert hits == []


def test_demo_pattern_rejects_a_bad_run():
    with pytest.raises(AssertionError):
        demo_pattern({"naive": (0.26, False), "good": (0.26, False),
                      "bad": (0.3, False)})
    demo_pattern({"naive": (0.26, False), "good": (0.26, False),
                  "bad": (float("nan"), True)})
