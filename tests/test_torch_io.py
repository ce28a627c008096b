"""The port's IO layer: the native tensor store, checkpoint round trips,
the asynchronous writer, engine resume, edge lists and the karate-club
data, run as ``tests/test_io.py`` runs them against the JAX package; plus
checkpoints read across the two packages bit for bit, and a port engine
that continues a fit the JAX engine checkpointed.
"""

import json
import types

import numpy as np
import pytest
import torch

import tame.io as jio
from tame.inference import TemporalAMEStructuredMFVI as JaxGood
from tame.models import TemporalAMEModel as JaxTemporalAMEModel
from tame_torch import (
    TemporalAMEModel,
    TemporalAMENaiveMFVI,
    TemporalAMESmoothedVI,
    TemporalAMEStructuredMFVI,
)
from tame_torch.inference import cavi
from tame_torch.io import (
    AsyncCheckpointer,
    edgelist_to_tensors,
    load_checkpoint,
    load_karate_club,
    save_checkpoint,
    tensors_to_edgelist,
)
from tame_torch.io import native
from tame_torch.models import params_from_numpy, random_dyad_mask

torch.set_num_threads(1)

requires_native = pytest.mark.skipif(not native.available(),
                                     reason="no C++ toolchain")


@pytest.fixture
def port_model():
    """The JAX suite's ``temporal_data`` configuration on the port (its
    own random stream), on the CPU."""
    model = TemporalAMEModel(n_nodes=10, n_time=5, latent_dim=2,
                             ar_coefficient=0.8, seed=42, device="cpu")
    model.generate_data()
    return model


@requires_native
class TestNativeStore:
    def test_roundtrip_dtypes(self, tmp_path):
        rng = np.random.default_rng(0)
        for dtype in ("float32", "float64", "int32", "int64", "uint8"):
            arr = (rng.normal(size=(7, 5)) * 100).astype(dtype)
            path = tmp_path / f"t_{dtype}.tame"
            native.write_tensor(path, arr)
            out = native.read_tensor(path)
            assert out.dtype == arr.dtype
            assert np.array_equal(out, arr)

    def test_roundtrip_shapes(self, tmp_path):
        rng = np.random.default_rng(1)
        for shape in [(), (3,), (2, 3, 4, 5)]:
            arr = rng.normal(size=shape).astype(np.float32)
            path = tmp_path / "t.tame"
            native.write_tensor(path, arr)
            out = native.read_tensor(path)
            assert out.shape == arr.shape
            assert np.array_equal(out, arr)

    def test_corruption_detected(self, tmp_path):
        arr = np.arange(100, dtype=np.float32)
        path = tmp_path / "t.tame"
        native.write_tensor(path, arr)
        raw = bytearray(path.read_bytes())
        raw[-5] ^= 0xFF  # flip a payload byte
        path.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="CRC"):
            native.read_tensor(path)

    def test_bad_magic_rejected(self, tmp_path):
        path = tmp_path / "bogus.tame"
        path.write_bytes(b"NOPE" + b"\x00" * 64)
        with pytest.raises(IOError):
            native.read_tensor(path)

    def test_crc32_known_value(self):
        # CRC32 of b"123456789" is the classic check value 0xCBF43926.
        arr = np.frombuffer(b"123456789", dtype=np.uint8)
        assert native.crc32(arr) == 0xCBF43926

    def test_files_byte_identical_to_jax_store(self, tmp_path):
        """The port's copy of the store writes the JAX store's bytes."""
        arr = np.random.default_rng(2).normal(size=(3, 4, 5)).astype(
            np.float32)
        native.write_tensor(tmp_path / "port.tame", arr)
        jio.native.write_tensor(tmp_path / "jax.tame", arr)
        assert ((tmp_path / "port.tame").read_bytes()
                == (tmp_path / "jax.tame").read_bytes())


class TestCheckpoint:
    def test_roundtrip_nested(self, tmp_path):
        state = {
            "X_mean": torch.randn(4, 3, 6, generator=torch.Generator()
                                  .manual_seed(0)),
            "nested": {"a": np.arange(5), "note": "hello"},
            "iteration": 17,
        }
        ckpt = tmp_path / "ckpt"
        save_checkpoint(ckpt, state)
        loaded = load_checkpoint(ckpt)
        assert np.array_equal(loaded["X_mean"], state["X_mean"].numpy())
        assert np.array_equal(loaded["nested"]["a"], state["nested"]["a"])
        assert loaded["nested"]["note"] == "hello"
        assert loaded["iteration"] == 17

    def test_overwrite_atomic(self, tmp_path):
        ckpt = tmp_path / "ckpt"
        save_checkpoint(ckpt, {"x": torch.zeros(3)})
        save_checkpoint(ckpt, {"x": torch.ones(3)})
        assert np.allclose(load_checkpoint(ckpt)["x"], 1.0)
        assert not (tmp_path / "ckpt.tmp").exists()

    def test_npy_fallback(self, tmp_path, monkeypatch):
        monkeypatch.setattr(native, "available", lambda: False)
        ckpt = tmp_path / "ckpt"
        save_checkpoint(ckpt, {"x": torch.arange(4.0)})
        assert list(ckpt.glob("*.npy"))
        assert json.loads((ckpt / "manifest.json").read_text())[
            "format"] == "npy"
        assert np.allclose(load_checkpoint(ckpt)["x"], np.arange(4.0))

    @requires_native
    def test_native_format_recorded(self, tmp_path):
        save_checkpoint(tmp_path / "ck", {"x": torch.arange(4.0)})
        assert json.loads((tmp_path / "ck" / "manifest.json").read_text())[
            "format"] == "tamestore"


class TestAsyncCheckpointer:
    def test_overlapped_writes_roundtrip(self, tmp_path):
        ckptr = AsyncCheckpointer()
        for i in range(3):
            ckptr.save(tmp_path / "ck",
                       {"x": torch.full((8,), float(i)), "step": i})
        ckptr.wait()
        loaded = load_checkpoint(tmp_path / "ck")
        assert np.allclose(loaded["x"], 2.0)
        assert loaded["step"] == 2

    def test_write_error_surfaces(self, tmp_path):
        blocker = tmp_path / "blocked"
        blocker.write_text("not a directory")
        ckptr = AsyncCheckpointer()
        # writing "inside" a file must fail in the background thread...
        ckptr.save(blocker / "ck", {"x": torch.zeros(2)})
        with pytest.raises(Exception):
            ckptr.wait()
        # ...and the checkpointer stays usable afterwards
        ckptr.save(tmp_path / "ok", {"x": torch.ones(2)})
        ckptr.wait()
        assert np.allclose(load_checkpoint(tmp_path / "ok")["x"], 1.0)

    def test_snapshot_isolated_from_later_updates(self, tmp_path):
        """Torch tensors are mutable: ``save`` must copy them before it
        returns, so updating the tensors in place right after (as the next
        fit segment does to the engine's buffers) cannot reach the
        checkpoint."""
        x = torch.arange(200_000, dtype=torch.float32)
        hist = np.arange(5.0)
        ckptr = AsyncCheckpointer()
        ckptr.save(tmp_path / "ck", {"x": x, "history": {"h": hist}})
        x.mul_(-1.0)
        hist *= -1.0
        ckptr.wait()
        loaded = load_checkpoint(tmp_path / "ck")
        assert np.array_equal(loaded["x"], np.arange(200_000,
                                                     dtype=np.float32))
        assert np.array_equal(loaded["history"]["h"], np.arange(5.0))


class TestEngineResume:
    """``tests/test_io.py::TestEngineResume`` on the port (the plain-twin
    path: every fit here runs on the CPU)."""

    def test_fit_resume_continues(self, port_model, tmp_path):
        vi = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                       learning_rate=0.7)
        vi.fit(max_iter=5, verbose=False)
        vi.save_checkpoint(tmp_path / "ckpt")

        vi2 = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                        learning_rate=0.7)
        vi2.load_checkpoint(tmp_path / "ckpt")
        assert torch.equal(vi2.X_mean, vi.X_mean)
        assert vi2.history["elbo"] == vi.history["elbo"]

        # the resumed fit keeps improving from the restored state
        vi2.fit(max_iter=5, verbose=False)
        assert len(vi2.history["elbo"]) == 10
        assert vi2.history["elbo"][-1] >= vi2.history["elbo"][4] - 1.0

    def test_segmented_fit_bitwise_equals_single_shot(self, port_model,
                                                      tmp_path):
        """A checkpoint_every=7 run is bitwise identical (state, history,
        stopping iteration) to one uninterrupted call."""
        ref = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                        learning_rate=0.7)
        ref.fit(max_iter=40, tolerance=1e-3, verbose=False)

        seg = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                        learning_rate=0.7)
        seg.fit(max_iter=40, tolerance=1e-3, verbose=False,
                checkpoint_every=7, ckpt_dir=tmp_path / "seg")
        assert (tmp_path / "seg").exists()

        assert len(seg.history["elbo"]) == len(ref.history["elbo"])
        assert seg.history["elbo"] == ref.history["elbo"]
        assert torch.equal(seg.X_mean, ref.X_mean)
        assert torch.equal(seg.X_cov, ref.X_cov)
        assert seg._converged == ref._converged

    def test_kill_and_resume_bitwise(self, port_model, tmp_path):
        """A fit killed mid-way and resumed from its checkpoint reproduces
        the uninterrupted fit bitwise (total budget semantics)."""
        ref = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                        learning_rate=0.7)
        ref.fit(max_iter=20, tolerance=0.0, verbose=False)

        # "killed" after 10 iterations (2 checkpointed segments of 5)
        a = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                      learning_rate=0.7)
        a.fit(max_iter=10, tolerance=0.0, verbose=False,
              checkpoint_every=5, ckpt_dir=tmp_path / "ck")

        # a fresh engine resumes from the checkpoint
        b = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                      learning_rate=0.7)
        b.fit(max_iter=20, tolerance=0.0, verbose=False,
              checkpoint_every=5, ckpt_dir=tmp_path / "ck", resume=True)

        assert len(b.history["elbo"]) == 20
        assert b.history["elbo"] == ref.history["elbo"]
        assert b.history["reconstruction_error"] == ref.history[
            "reconstruction_error"]
        assert torch.equal(b.X_mean, ref.X_mean)
        assert torch.equal(b.X_cov, ref.X_cov)

        # a no-op resume (budget already spent) leaves everything alone
        c = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                      learning_rate=0.7)
        c.fit(max_iter=20, tolerance=0.0, verbose=False,
              ckpt_dir=tmp_path / "ck", resume=True)
        assert c.history["elbo"] == ref.history["elbo"]

    def test_resume_after_converged_is_a_noop(self, port_model, tmp_path):
        """A checkpoint taken after the stopping rule fired must not
        re-enter the loop on resume with budget remaining."""
        a = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                      learning_rate=0.7)
        a.fit(max_iter=60, tolerance=1e-2, verbose=False,
              checkpoint_every=5, ckpt_dir=tmp_path / "cv")
        assert a._converged
        n_done = len(a.history["elbo"])
        assert n_done < 60  # converged before the budget

        b = TemporalAMEStructuredMFVI(port_model, factorization="good",
                                      learning_rate=0.7)
        b.fit(max_iter=60, tolerance=1e-2, verbose=False,
              checkpoint_every=5, ckpt_dir=tmp_path / "cv", resume=True)
        assert b._converged
        assert len(b.history["elbo"]) == n_done
        assert b.history["elbo"] == a.history["elbo"]
        assert torch.equal(b.X_mean, a.X_mean)

    def test_segmented_smoothed_checkpoint(self, port_model, tmp_path):
        """The smoothed engine checkpoints and restores its whole state
        (means, marginal and cross covariances, logdets)."""
        vi = TemporalAMESmoothedVI(port_model, learning_rate=0.8)
        vi.fit(max_iter=5, verbose=False)
        vi.save_checkpoint(tmp_path / "sm")

        vi2 = TemporalAMESmoothedVI(port_model, learning_rate=0.8)
        vi2.load_checkpoint(tmp_path / "sm")
        assert torch.equal(vi2.X_mean, vi.X_mean)
        assert torch.equal(vi2.X_cross, vi.X_cross)
        assert torch.equal(vi2.logdets, vi.logdets)
        assert vi2.history["elbo"] == vi.history["elbo"]
        vi2.fit(max_iter=3, verbose=False)
        assert len(vi2.history["elbo"]) == 8

    def test_structure_mismatch_rejected(self, port_model, tmp_path):
        vi = TemporalAMEStructuredMFVI(port_model, factorization="good")
        vi.save_checkpoint(tmp_path / "ckpt")
        vi2 = TemporalAMENaiveMFVI(port_model)
        with pytest.raises(ValueError, match="structure"):
            vi2.load_checkpoint(tmp_path / "ckpt")

    def test_smoothed_kill_and_resume_bitwise(self, port_model, tmp_path):
        """The smoothed engine's kill-and-resume reproduces the
        uninterrupted fit bit for bit, X_cross and logdets included."""
        ref = TemporalAMESmoothedVI(port_model, learning_rate=0.8)
        ref.fit(max_iter=12, tolerance=0.0, verbose=False)
        a = TemporalAMESmoothedVI(port_model, learning_rate=0.8)
        a.fit(max_iter=8, tolerance=0.0, verbose=False, checkpoint_every=4,
              ckpt_dir=tmp_path / "sm")
        b = TemporalAMESmoothedVI(port_model, learning_rate=0.8)
        b.fit(max_iter=12, tolerance=0.0, verbose=False, checkpoint_every=4,
              ckpt_dir=tmp_path / "sm", resume=True)
        assert b.history == ref.history
        for name in ("X_mean", "X_cov", "X_cross", "logdets"):
            assert torch.equal(getattr(b, name), getattr(ref, name)), name


def test_fresh_carry_stays_null(port_model, tmp_path):
    """A fresh engine's carry is None and goes to JSON as null (not -inf,
    which JSON cannot hold); after a segment it is the float32 ELBO, which
    the JSON round trip keeps exactly."""
    vi = TemporalAMEStructuredMFVI(port_model, learning_rate=0.7)
    vi.save_checkpoint(tmp_path / "fresh")
    manifest = json.loads((tmp_path / "fresh" / "manifest.json").read_text())
    assert manifest["scalars"]["carry_elbo"] is None
    vi.fit(max_iter=3, tolerance=0.0, verbose=False)
    vi.save_checkpoint(tmp_path / "after")
    carry = load_checkpoint(tmp_path / "after")["carry_elbo"]
    assert carry == vi._carry_elbo == vi.history["elbo"][-1]
    assert np.float32(carry) == carry


class TestAcrossPackages:
    """Checkpoints cross between the packages: the same file layout, the
    same store format, the same scalars."""

    @staticmethod
    def _jax_fit(tmp_path, max_iter=5):
        jmodel = JaxTemporalAMEModel(n_nodes=10, n_time=5, latent_dim=2,
                                     seed=42)
        jmodel.generate_data()
        jvi = JaxGood(jmodel, factorization="good", learning_rate=0.7)
        jvi.fit(max_iter=max_iter, tolerance=1e-3, verbose=False,
                checkpoint_every=max_iter, ckpt_dir=tmp_path / "jax")
        return jmodel, jvi

    @staticmethod
    def _port_twin_model(jmodel):
        """A port model holding the JAX model's data and parameters."""
        model = TemporalAMEModel(n_nodes=10, n_time=5, latent_dim=2,
                                 seed=42, device="cpu")
        model.Y = torch.tensor(np.asarray(jmodel.Y))
        model.params = params_from_numpy(jmodel.params)
        return model

    @staticmethod
    def _assert_same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                TestAcrossPackages._assert_same(a[k], b[k])
            elif isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k],
                                                                   b[k]), k
            else:
                assert a[k] == b[k], k

    def test_port_reads_jax_checkpoint_bitwise(self, tmp_path):
        _, jvi = self._jax_fit(tmp_path)
        self._assert_same(load_checkpoint(tmp_path / "jax"),
                          jio.load_checkpoint(tmp_path / "jax"))
        state = load_checkpoint(tmp_path / "jax")
        assert np.array_equal(state["X_mean"], np.asarray(jvi.X_mean))
        assert state["carry_elbo"] == jvi._carry_elbo

    def test_jax_reads_port_checkpoint_bitwise(self, tmp_path):
        jmodel, _ = self._jax_fit(tmp_path)
        vi = TemporalAMEStructuredMFVI(self._port_twin_model(jmodel),
                                       learning_rate=0.7)
        vi.fit(max_iter=5, tolerance=1e-3, verbose=False, checkpoint_every=5,
               ckpt_dir=tmp_path / "port")
        ours = load_checkpoint(tmp_path / "port")
        theirs = jio.load_checkpoint(tmp_path / "port")
        self._assert_same(theirs, ours)
        assert np.array_equal(theirs["X_mean"], vi.X_mean.numpy())
        assert np.array_equal(theirs["X_cov"], vi.X_cov.numpy())
        assert theirs["carry_elbo"] == vi._carry_elbo
        # the manifests carry the same keys and the same store format
        jman = json.loads((tmp_path / "jax" / "manifest.json").read_text())
        pman = json.loads((tmp_path / "port" / "manifest.json").read_text())
        assert jman["format"] == pman["format"]
        assert jman["tensors"] == pman["tensors"]
        assert jman["scalars"].keys() == pman["scalars"].keys()

    def test_port_engine_continues_jax_fit(self, tmp_path):
        """A port engine resumes the JAX engine's checkpoint and matches
        the JAX engine's own continued fit: ELBO within 1e-4 relative at
        every iteration and the same stop."""
        jmodel, _ = self._jax_fit(tmp_path)
        jvi = JaxGood(jmodel, factorization="good", learning_rate=0.7)
        jvi.fit(max_iter=60, tolerance=1e-3, verbose=False,
                ckpt_dir=tmp_path / "jax", resume=True)
        vi = TemporalAMEStructuredMFVI(self._port_twin_model(jmodel),
                                       learning_rate=0.7)
        vi.fit(max_iter=60, tolerance=1e-3, verbose=False,
               ckpt_dir=tmp_path / "jax", resume=True)
        assert jvi._converged and len(jvi.history["elbo"]) < 60
        assert len(vi.history["elbo"]) == len(jvi.history["elbo"])
        assert vi._converged == jvi._converged
        assert vi.history["elbo"][:5] == jvi.history["elbo"][:5]
        e_t, e_j = np.asarray(vi.history["elbo"]), np.asarray(
            jvi.history["elbo"])
        assert np.max(np.abs(e_t - e_j) / np.abs(e_j)) < 1e-4


class TestEdgelist:
    """``tests/test_io.py::TestEdgelist`` on the port: directed panel
    records <-> (Y, mask) tensors."""

    def test_roundtrip_through_model_layout(self):
        model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1, seed=2,
                                 device="cpu")
        Y_true, _ = model.generate_data(return_latents=True)
        mask = random_dyad_mask(torch.Generator().manual_seed(0), 8, 4, 0.4)
        i, j, t, v = tensors_to_edgelist(Y_true, mask)
        Y, m, info = edgelist_to_tensors(i.numpy(), j.numpy(), t.numpy(),
                                         v.numpy(), n_nodes=8, n_time=4,
                                         node_ids=list(range(8)),
                                         device="cpu")
        assert torch.equal(m, mask)
        assert info["n_dropped_oneway"] == 0
        # observed entries reproduce Y exactly, the reciprocal slot too
        obs = mask > 0
        assert torch.equal(Y[obs], Y_true[obs])
        assert torch.equal(Y[..., 1], Y[..., 0].transpose(0, 1))
        # unobserved entries zeroed
        assert bool((Y[~obs] == 0).all())

    def test_oneway_records_dropped(self):
        Y, m, info = edgelist_to_tensors(
            ["a", "b", "a"], ["b", "a", "c"], [0, 0, 0], [1.0, 2.0, 3.0],
            n_time=1, device="cpu")
        # a<->b observed both ways; a->c lacks its reverse
        assert info["n_dropped_oneway"] == 1
        assert m.sum() == 2  # (a,b) and (b,a)
        assert Y[0, 1, 0, 0] == 1.0 and Y[0, 1, 0, 1] == 2.0
        assert m[0, 2, 0] == 0 and Y[0, 2, 0, 0] == 0

    def test_self_loop_rejected(self):
        with pytest.raises(ValueError, match="self-loops"):
            edgelist_to_tensors(["a"], ["a"], [0], [1.0], device="cpu")

    def test_same_tensors_as_jax(self):
        """The port's parser gives the JAX parser's tensors and counts on
        records with duplicates and one-way entries."""
        rng = np.random.default_rng(3)
        s = rng.integers(0, 6, 80)
        r = (s + rng.integers(1, 6, 80)) % 6
        t = rng.integers(0, 3, 80)
        v = rng.normal(size=80)
        jY, jm, jinfo = jio.edgelist_to_tensors(s, r, t, v)
        Y, m, info = edgelist_to_tensors(s, r, t, v, device="cpu")
        assert np.array_equal(Y.numpy(), jY) and np.array_equal(m.numpy(), jm)
        assert info == jinfo

    def test_csv_roundtrip(self, tmp_path):
        path = tmp_path / "records.csv"
        path.write_text("sender,receiver,time,value\n"
                        "x,y,0,1.5\ny,x,0,-2.0\nx,z,1,3.0\nz,x,1,4.0\n")
        Y, m, info = jio.load_edgelist_csv(path)
        from tame_torch.io import load_edgelist_csv

        tY, tm, tinfo = load_edgelist_csv(path, device="cpu")
        assert np.array_equal(tY.numpy(), Y) and np.array_equal(tm.numpy(),
                                                                m)
        assert tinfo == info

    def test_masked_fit_from_edgelist(self):
        """End to end: records -> tensors -> masked fit improves."""
        model = TemporalAMEModel(n_nodes=10, n_time=4, latent_dim=1, seed=5,
                                 device="cpu")
        Y_true, _ = model.generate_data(return_latents=True)
        mask = random_dyad_mask(torch.Generator().manual_seed(1), 10, 4,
                                0.25)
        i, j, t, v = tensors_to_edgelist(Y_true, mask)
        Y, m, _ = edgelist_to_tensors(i.numpy(), j.numpy(), t.numpy(),
                                      v.numpy(), n_nodes=10, n_time=4,
                                      node_ids=list(range(10)), device="cpu")
        init = cavi.init_state(torch.Generator().manual_seed(2), 10, 4, 4,
                               "full", 0.1, 0.5)
        out = cavi.fit_cavi(Y, model.params, init, structure="full",
                            update_mode="jacobi", mask=m, max_iter=50,
                            learning_rate=0.7, tolerance=0.0)
        eh = out.elbo_history.numpy()[:50]
        assert np.all(np.isfinite(eh)) and eh[-1] > eh[0]


def _auc(scores, labels):
    pos, neg = scores[labels > 0.5], scores[labels < 0.5]
    return float(np.mean([(p > q) + 0.5 * (p == q) for p in pos
                          for q in neg]))


class TestKarateClub:
    """The bundled real network, and the masked Poisson fit of
    ``tests/test_io.py::TestKarateClub`` against ``tame``'s on ``tame``'s
    own mask (20 % of the dyads hidden) and warm init."""

    # fitted rates, port vs tame: 300 guarded iterations to a 1e-6 stop
    RATE_RTOL = 1e-3

    @pytest.fixture(scope="class")
    def karate_fits(self):
        import jax
        import jax.numpy as jnp
        from tame.config import ModelConfig as JaxModelConfig
        from tame.inference import TemporalAMEPoissonVI as JaxPoissonVI
        from tame.models import build_params as jax_build_params
        from tame.models import random_dyad_mask as jax_random_dyad_mask
        from tame_torch.inference import TemporalAMEPoissonVI

        jdata = jio.load_karate_club()
        n = jdata.n_nodes
        hide = np.asarray(jax_random_dyad_mask(jax.random.PRNGKey(1), n, 1,
                                               0.2))
        off = 1.0 - np.eye(n)[:, :, None]
        fitmask, held = off * hide, off * (1.0 - hide)
        p = jax_build_params(JaxModelConfig(n_nodes=n, n_time=1,
                                            latent_dim=2, seed=0))
        jm = types.SimpleNamespace(Y=jdata.Y, params=p, n=n, T=1, d=6, r=2)
        ref = JaxPoissonVI(jm, mask=jnp.asarray(fitmask), init_mode="warm")
        init = (np.asarray(ref.X_mean), np.asarray(ref.X_cov))
        ref.fit(max_iter=300, tolerance=1e-6, verbose=False)
        data = load_karate_club(device="cpu")
        pm = types.SimpleNamespace(Y=data.Y, params=params_from_numpy(p),
                                   n=n, T=1, d=6, r=2)
        vi = TemporalAMEPoissonVI(pm, mask=torch.from_numpy(fitmask),
                                  init_mode="warm")
        vi.X_mean = torch.from_numpy(init[0])
        vi.X_cov = torch.from_numpy(init[1])
        vi.fit(max_iter=300, tolerance=1e-6, verbose=False)
        return data, vi, np.asarray(ref.predict_rate()), fitmask, held

    def test_load(self):
        data = load_karate_club(device="cpu")
        assert data.Y.shape == (34, 34, 1, 2)
        # reciprocal layout and symmetry of the real counts
        assert torch.equal(data.Y[..., 1], data.Y[..., 0].transpose(0, 1))
        assert data.Y.max() == 7.0          # Zachary's max context count
        assert (data.Y[..., 0] > 0).sum() == 156  # 78 undirected edges
        assert data.factions.sum() == 17    # the split was 17 / 17

    def test_masked_poisson_fit_matches_tame(self, karate_fits):
        _, vi, ref_rate, _, _ = karate_fits
        assert not vi._diverged
        np.testing.assert_allclose(vi.predict_rate().numpy(), ref_rate,
                                   rtol=self.RATE_RTOL)

    def test_holdout_link_prediction_beats_degree_baseline(self,
                                                           karate_fits):
        """``tame`` measured AUC 0.789 against the degree baseline's
        0.754 on the held-out dyads."""
        data, vi, _, fitmask, held = karate_fits
        y0 = data.Y[..., 0].numpy()
        sel = held > 0
        lbl = (y0[sel] > 0).astype(float)
        auc_model = _auc(vi.predict_rate().numpy()[sel], lbl)
        deg_out = (y0 * fitmask).sum(axis=(1, 2))
        deg_in = (y0 * fitmask).sum(axis=(0, 2))
        base = np.broadcast_to(
            (deg_out[:, None] + deg_in[None, :])[:, :, None], y0.shape)
        auc_base = _auc(base[sel], lbl)
        assert auc_model > 0.75, auc_model
        assert auc_model > auc_base, (auc_model, auc_base)

    def test_same_as_jax(self):
        jdata = jio.load_karate_club()
        data = load_karate_club(device="cpu")
        assert np.array_equal(data.Y.numpy(), jdata.Y)
        assert np.array_equal(data.factions.numpy(), jdata.factions)
        assert data.n_nodes == jdata.n_nodes
