"""Port parity for ``tame_torch.parallel``: fits and samplers sharded over
ranks of ``torch.distributed`` equal the port's unsharded ones and
``tame``'s (JAX, CPU) on the same numpy inputs.

The sharded runs happen in one spawned gloo world of 8 CPU processes,
started once for the file on a FileStore under ``tmp_path`` (no port, so
test workers cannot clash); the rank-side cases live in
``tests/_torch_dist.py``, which imports no JAX.  The JAX references run
here, the sharded one on ``conftest.py``'s virtual 8-device mesh.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import tame
from tame.config import ModelConfig
from tame.inference import cavi as jcavi
from tame.inference import fit_cavi_bernoulli as j_bernoulli
from tame.inference import fit_cavi_poisson as j_poisson
from tame.inference import smoothed as jsm
from tame.models import TemporalAMEModel as JModel
from tame.models import build_params as j_build_params
from tame.models import sample as j_sample
from tame.parallel import make_mesh as j_make_mesh
from tame.parallel import shard_fit_inputs as j_shard_fit_inputs
import tame_torch
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import smoothed as tsm
from tame_torch.models import params_from_numpy
from tame_torch.parallel import (
    chain_sharding,
    cov_sharding,
    initialize_distributed,
    make_mesh,
    obs_sharding,
    replicated,
    shard_fit_inputs,
    shard_smoothed_inputs,
    state_sharding,
)
from tame_torch.parallel import comm
from tame_torch.parallel.comm_analysis import analyze_sharded_fit, layout_bytes

from _torch_dist import run_world

torch.set_num_threads(1)

# test_parallel.py's tolerances for a sharded fit against one device.
ATOL_X = 1e-4
RTOL_ELBO = 1e-4
# HMC chains are independent: sharding only places them (1e-5, as JAX).
ATOL_HMC = 1e-5
# SMC: the same draws; reductions over the gathered weights.
ATOL_SMC = 1e-4
FIT = dict(structure="full", learning_rate=0.7, max_iter=20)
NODES_TIME = {"jacobi-2x1": (2, 1, "jacobi"), "jacobi-2x2": (2, 2, "jacobi"),
              "jacobi-1x2": (1, 2, "jacobi"), "block-4x1": (4, 1, "block"),
              "block-2x2": (2, 2, "block")}


def _np(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def _fit_kw(mode):
    kw = dict(FIT, update_mode=mode)
    if mode == "block":
        kw["num_blocks"] = 4
    return kw


def _problem(n=16, T=8, r=2, seed=5):
    """test_parallel.py's problem: tame's data and init as numpy."""
    model = JModel(n_nodes=n, n_time=T, latent_dim=r, seed=seed)
    Y, _ = model.generate_data(return_latents=True)
    init = jcavi.init_state(jax.random.PRNGKey(0), n, T, model.d, "full",
                            0.1, 0.5)
    return np.asarray(Y), _np(init), _np(model.params)


def _family_problem(family):
    n, T = 32, 8
    p = j_build_params(ModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                   seed=0))
    Y, _ = j_sample(p, jax.random.PRNGKey(0), n, T, family=family)
    init = jcavi.init_state(jax.random.PRNGKey(1), n, T, p.d, "full", 0.1,
                            0.5)
    return np.asarray(Y), _np(init), _np(p)


def _smoothed_problem():
    model = JModel(n_nodes=16, n_time=6, latent_dim=1, seed=11)
    Y, _ = model.generate_data(return_latents=True)
    init = jsm.init_smoothed_state(jax.random.PRNGKey(0), 16, 6, 4)
    return np.asarray(Y), _np(init), _np(model.params)


@pytest.fixture(scope="module")
def problems():
    return {"base": _problem(), "uneven": _problem(n=20, seed=6),
            "bernoulli": _family_problem("bernoulli"),
            "poisson": _family_problem("poisson"),
            "smoothed": _smoothed_problem()}


@pytest.fixture(scope="module")
def world(problems, tmp_path_factory):
    """Every case run once in one world of 8 ranks: rank-ordered results."""
    Y, init, p = problems["base"]
    cases = [(name, "fit", dict(nodes=a, time=b, Y=Y, init=init, params=p,
                                kw=_fit_kw(mode)))
             for name, (a, b, mode) in NODES_TIME.items()]
    Yu, iu, pu = problems["uneven"]
    cases.append(("uneven", "fit", dict(nodes=2, time=1, Y=Yu, init=iu,
                                        params=pu, kw=_fit_kw("block"))))
    cases.append(("block-4x2", "fit", dict(nodes=4, time=2, Y=Y, init=init,
                                           params=p, kw=_fit_kw("block"))))
    for fam in ("bernoulli", "poisson"):
        Yf, fi, fp = problems[fam]
        cases.append((fam, "fit", dict(nodes=2, time=2, Y=Yf, init=fi,
                                       params=fp, family=fam,
                                       kw=dict(max_iter=40,
                                               tolerance=0.0))))
    Ys, si, sp = problems["smoothed"]
    cases.append(("smoothed", "smoothed", dict(
        nodes=4, Y=Ys, init=si, params=sp,
        kw=dict(max_iter=15, learning_rate=0.8, tolerance=0.0))))
    cases.append(("samplers", "samplers", dict(batch=2)))
    cases.append(("meshes", "meshes", {}))
    cases.append(("scaling", "scaling", dict(Y=Y, init=init, params=p,
                                             kw=dict(FIT, max_iter=3))))
    cases.append(("bytes", "bytes", dict(nodes=2, time=2, n=16, T=8, r=2,
                                         num_blocks=4)))
    for nodes in (1, 2):
        cases.append((f"weights-{nodes}", "weights", dict(
            nodes=nodes, Y=Y, init=init, params=p)))
    return run_world(8, cases, tmp_path_factory.mktemp("world"))


def _port_fit(Y, init, p, **kw):
    return tcavi.fit_cavi(torch.as_tensor(Y), params_from_numpy(p),
                          tcavi.state_from_numpy(init), **kw)


def _same_fit(got, X_ref, elbo_ref):
    assert np.allclose(got["X_mean"], X_ref, atol=ATOL_X)
    n = len(elbo_ref)
    assert got["n_iter"] == n
    assert np.allclose(got["elbo"], elbo_ref, rtol=RTOL_ELBO)


def _members(world, name):
    return [r[name] for r in world if r[name] is not None]


@pytest.mark.parametrize("name", [*NODES_TIME, "uneven"])
def test_sharded_fit_matches_port_and_tame(world, problems, name):
    Y, init, p = problems["uneven" if name == "uneven" else "base"]
    mode = "block" if name == "uneven" else NODES_TIME[name][2]
    kw = _fit_kw(mode)
    port = _port_fit(Y, init, p, **kw)
    ref = jcavi.fit_cavi(Y, tame.models.params.AMEParams(**p),
                         jcavi.CaviState(**init), **kw)
    members = _members(world, name)
    got = members[0]
    _same_fit(got, port.X_mean.numpy(),
              port.elbo_history[:port.n_iter].numpy())
    _same_fit(got, np.asarray(ref.X_mean),
              np.asarray(ref.elbo_history)[:int(ref.n_iter)])
    # every rank stopped at the same iteration on the same ELBOs
    assert all(m["n_iter"] == got["n_iter"] for m in members)
    assert all(np.array_equal(m["elbo"], got["elbo"]) for m in members)


@pytest.mark.parametrize("nodes", [1, 2])
def test_rank_weights_are_its_time_major_rows(world, problems, nodes):
    """Each rank of a one- or two-rank mesh stores the time-major weights
    of the rows it holds, bit for bit the network's rows, which its
    block phases hand K7 as stripes."""
    Y, _, p = problems["base"]
    obs = tcavi.precompute_obs_constants(torch.as_tensor(Y),
                                         params_from_numpy(p).R_inv)
    members = _members(world, f"weights-{nodes}")
    assert len(members) == nodes
    for got in members:
        rows = slice(*got["rows"])
        assert got["time_major"]
        np.testing.assert_array_equal(got["W0"], obs.W0.tm[:, rows].numpy())
        np.testing.assert_array_equal(got["W1"], obs.W1.tm[:, rows].numpy())
        np.testing.assert_array_equal(got["eta_a"], obs.eta_a[rows].numpy())


@pytest.mark.parametrize("n,blocks,nodes,shares", [
    (20, 4, 2, [3, 2]), (2000, 16, 2, [63, 62]),
    (2000, 16, 4, [32, 31, 31, 31])])
def test_block_shares(n, blocks, nodes, shares):
    """Every block is split over the nodes ranks, unevenly where bs is no
    multiple of them (the uneven case above; the north-star bs = 125)."""
    from tame_torch.parallel.mesh import axis_slice, slice_len
    from tame_torch.parallel.sharded_cavi import Geometry

    fake = SimpleNamespace(
        shape={"nodes": nodes, "time": 1}, coord={"nodes": 0, "time": 0},
        piece=lambda axis, size, index=None: axis_slice(axis, size, 1, 0))
    geo = Geometry(fake, n, 4)
    bs = n // blocks
    got = [slice_len(geo.share(0, bs, k), n) for k in range(nodes)]
    assert got == shares
    # a block's shares tile it, and each sits in a rank's rows
    for b in range(blocks):
        rows = sorted(i for k in range(nodes) for i in range(n)[
            geo.share(b * bs, (b + 1) * bs, k)])
        assert rows == list(range(b * bs, (b + 1) * bs))
        assert all(i % nodes == k for k in range(nodes) for i in range(n)[
            geo.share(b * bs, (b + 1) * bs, k)])


def test_sharded_fit_matches_jax_sharded(world, problems):
    """The (4, 2) block fit against tame's on the virtual 8-device mesh."""
    Y, init, p = problems["base"]
    kw = _fit_kw("block")
    mesh = j_make_mesh(nodes=4, time=2, devices=jax.devices()[:8])
    Y_s, init_s = j_shard_fit_inputs(mesh, Y, jcavi.CaviState(**init))
    ref = jcavi.fit_cavi(Y_s, tame.models.params.AMEParams(**p), init_s,
                         **kw)
    got = _members(world, "block-4x2")
    assert len(got) == 8
    _same_fit(got[0], np.asarray(ref.X_mean),
              np.asarray(ref.elbo_history)[:int(ref.n_iter)])


def test_smoothed_sharded_matches_tame(world, problems):
    Y, init, p = problems["smoothed"]
    ref = jsm.fit_cavi_smoothed(Y, tame.models.params.AMEParams(**p),
                                jsm.SmoothedState(**init), max_iter=15,
                                learning_rate=0.8, tolerance=0.0)
    got = _members(world, "smoothed")
    assert len(got) == 4
    assert np.allclose(got[0]["X_mean"], np.asarray(ref.state.X_mean),
                       atol=ATOL_X)
    assert np.allclose(got[0]["elbo"], np.asarray(ref.elbo_history)[:15],
                       rtol=RTOL_ELBO)
    assert "nodes" in got[0]["refused"]


@pytest.mark.parametrize("family", ["bernoulli", "poisson"])
def test_family_sharded_matches_tame(world, problems, family):
    Y, init, p = problems[family]
    fit = j_bernoulli if family == "bernoulli" else j_poisson
    ref = fit(Y, tame.models.params.AMEParams(**p), jcavi.CaviState(**init),
              max_iter=40, tolerance=0.0)
    got = _members(world, family)
    assert len(got) == 4
    assert np.allclose(got[0]["X_mean"], np.asarray(ref.X_mean), atol=ATOL_X)
    assert np.allclose(got[0]["elbo"], np.asarray(ref.elbo_history)[:40],
                       rtol=RTOL_ELBO)


def test_sharded_hmc_equals_unsharded(world):
    got = _members(world, "samplers")
    assert len(got) == 2 and got[0]["hmc_local"] == 32
    assert got[0]["hmc"].shape[:2] == (64, 15)
    assert np.allclose(got[0]["hmc"], got[0]["hmc_ref"], atol=ATOL_HMC)


def test_sharded_nuts_statistically_unchanged(world):
    got = _members(world, "samplers")[0]
    assert got["nuts"].shape[:2] == (8, 10)
    assert np.all(np.isfinite(got["nuts"]))
    assert np.allclose(got["nuts"].mean(axis=(0, 1)),
                       got["nuts_ref"].mean(axis=(0, 1)), atol=0.5)


def test_sharded_smc_matches_unsharded(world):
    got = _members(world, "samplers")
    assert got[0]["smc_local"] == 32 and got[0]["smc"].shape[0] == 64
    assert np.allclose(got[0]["smc"], got[0]["smc_ref"], atol=ATOL_SMC)
    assert abs(got[0]["evidence"] - got[0]["evidence_ref"]) < ATOL_SMC
    assert got[0]["evidence"] == got[1]["evidence"]


def test_mesh_shapes_and_errors(world):
    m = world[0]["meshes"]
    assert m["global"] == {"batch": 1, "nodes": 8, "time": 1}
    assert m["auto"] == {"batch": 1, "nodes": 4, "time": 2}
    assert m["auto4"] == {"batch": 1, "nodes": 2, "time": 2}
    assert m["auto2"] == {"batch": 1, "nodes": 2, "time": 1}
    assert m["batch"] == {"batch": 2, "nodes": 2, "time": 2}
    assert m["too_big"] == "mesh 1x16x1 needs 16 devices, have 8"


def test_scaling_harness_keys(world):
    s = world[0]["scaling"]
    assert set(s["strong"]) == {1, 2} and set(s["weak"]) == {1, 2}
    assert set(s["strong"][2]) == {"wall_s", "speedup", "efficiency"}
    assert set(s["weak"][2]) == {"wall_s", "efficiency"}
    assert s["strong"][1]["efficiency"] == 1.0
    assert s["weak"][1]["efficiency"] == 1.0
    assert s["strong"][2]["wall_s"] > 0 and s["weak"][2]["wall_s"] > 0
    # every rank holds rank 0's times
    assert world[5]["scaling"] == s


def test_collective_bytes_follow_layout(world):
    """(2, 2) block fit, n=16, T=8, r=2, 4 blocks: per block phase one
    all-gather of 4 padded (2, 4, 6) pieces, one 6-float all-reduce."""
    for stats in _members(world, "bytes"):
        assert stats["all_gather"] == {"count": 4, "bytes": 4 * 4 * 48 * 4}
        assert stats["all_reduce"] == {"count": 1, "bytes": 6 * 4}
        total = sum(v["bytes"] for v in stats.values())
        assert total == layout_bytes(16, 8, 2, 2, 2, 4)
        # cross-rank traffic carries means, never observation-sized data
        assert total < 16 * 16 * 8 * 2 * 4


def test_analyze_sharded_fit(tmp_path):
    prof = analyze_sharded_fit(20, 6, 1, nodes=2, num_blocks=4)
    assert set(prof) == {"n", "T", "r", "nodes", "time", "num_blocks",
                         "structure", "update_mode", "collectives",
                         "collective_bytes", "flops", "bytes_accessed"}
    assert prof["collective_bytes"] == layout_bytes(20, 6, 1, 2, 1, 4)
    assert prof["collectives"]["all_gather"]["count"] == 4
    assert prof["flops"] > 0 and prof["bytes_accessed"] > 0


# -- one process -------------------------------------------------------------

@pytest.fixture
def one_rank():
    """A one-rank mesh on an in-memory store; the group ends with the
    test."""
    assert not comm.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    comm.destroy()


def test_mesh_config_matches_tame():
    fields = [(f.name, f.default) for f in dataclasses.fields(
        tame_torch.MeshConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(
        tame.MeshConfig)]
    assert tame_torch.MeshConfig(nodes=4).nodes == 4


def test_exports_match_tame():
    import tame.parallel
    import tame_torch.parallel

    assert tame_torch.parallel.__all__ == tame.parallel.__all__


def test_single_process_helpers():
    assert initialize_distributed() is False
    assert not comm.is_initialized()
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(nodes=2, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        make_mesh(device="cpu", backend="nccl")


def test_one_rank_mesh_is_the_plain_fit(one_rank, problems):
    """Sharded over one rank, the block fit is the single-device loop."""
    Y, init, p = problems["base"]
    assert one_rank.shape == {"batch": 1, "nodes": 1, "time": 1}
    assert one_rank.size == 1 and one_rank.device == torch.device("cpu")
    assert state_sharding(one_rank).spec == ("nodes", "time", None)
    assert cov_sharding(one_rank).spec == ("nodes", "time", None, None)
    assert obs_sharding(one_rank).spec == ("nodes", None, "time", None)
    assert replicated(one_rank).spec == ()
    assert chain_sharding(one_rank, 3).spec == ("batch", None, None)
    kw = _fit_kw("block")
    ref = _port_fit(Y, init, p, **kw)
    Y_s, init_s = shard_fit_inputs(one_rank, Y, tcavi.state_from_numpy(init))
    out = tcavi.fit_cavi(Y_s, params_from_numpy(p), init_s, **kw)
    assert torch.equal(out.full().X_mean, ref.X_mean)
    n = ref.n_iter
    assert torch.equal(out.elbo_history[:n], ref.elbo_history[:n])
    assert (out.n_iter, out.converged) == (ref.n_iter, ref.converged)
    with pytest.raises(TypeError, match="both"):
        tcavi.fit_cavi(torch.as_tensor(Y), params_from_numpy(p), init_s)


@pytest.mark.parametrize("what", ["fused", "family_inputs"])
def test_out_of_scope_raises(one_rank, problems, what):
    """K3 never runs under a mesh; the internal ``family_inputs`` takes the
    whole network and names the sharded engines for a sharded ``Y``."""
    from tame_torch.inference.binary_cavi import family_inputs

    Y, init, p = problems["base"]
    Y_s, init_s = shard_fit_inputs(one_rank, Y, tcavi.state_from_numpy(init))
    if what == "fused":
        with pytest.raises(ValueError, match="K3"):
            tcavi.fit_cavi(Y_s, params_from_numpy(p), init_s, fused=True)
        return
    with pytest.raises(TypeError, match="family_inputs.*sharded_family"):
        family_inputs(Y_s)


@pytest.mark.parametrize("what", ["compute_elbo", "smoothed_elbo",
                                  "em_update_params", "exact_elbo"])
def test_public_function_takes_a_sharded_y(one_rank, problems, what):
    """The public functions that read a whole ``Y`` take a sharded one in
    its sharded form (no opaque failure): on one rank, the plain
    function's bits; a sharded ``Y`` with a whole state raises
    ``TypeError``."""
    from tame_torch.inference import em_update_params, exact_elbo

    Y, init, p = problems["base"]
    Yt, params = torch.as_tensor(Y), params_from_numpy(p)
    pri = tcavi.precompute_priors(params)
    if what == "compute_elbo":
        state = tcavi.state_from_numpy(init)
        Y_s, state_s = shard_fit_inputs(one_rank, Yt, state)

        def call(y, s):
            return tcavi.compute_elbo(y, params, pri, s, "full")
    else:
        state = tsm.fit_cavi_smoothed(
            Yt, params, tsm.warm_init_smoothed_state(Yt, params),
            max_iter=3).state
        Y_s, state_s = shard_smoothed_inputs(one_rank, Yt, state)
        call = {"smoothed_elbo": lambda y, s: tsm.smoothed_elbo(
                    y, params, pri, s),
                "em_update_params": lambda y, s: em_update_params(
                    params, y, s),
                "exact_elbo": lambda y, s: exact_elbo(y, params, s)}[what]
    got, want = call(Y_s, state_s), call(Yt, state)
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    else:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(TypeError, match="both"):
        call(Y_s, state)


def test_no_jax_in_the_worker_module():
    src = open(os.path.join(os.path.dirname(__file__),
                            "_torch_dist.py")).read()
    assert "jax" not in src.replace("JAX", "") and "import tame\n" not in src


# -- the scripts ---------------------------------------------------------------

def test_probe_and_proof_scripts(tmp_path):
    from tame_torch.scripts import multihost_probe, multihost_proof

    probe = multihost_probe.main(["--device", "cpu"])
    assert probe["ok"] and probe["sums"] == [120.0, 120.0]
    path = tmp_path / "proof.json"
    proof = multihost_proof.main(["--device", "cpu", "--out", str(path)])
    assert proof["ok"] and json.loads(path.read_text()) == proof
    assert proof["max_abs_dx"] < 5e-4 and proof["elbo_rel_err"] < 1e-5
    assert len(set(proof["converged_iter"])) == 1
    assert os.listdir(tmp_path) == ["proof.json"]


def test_scaling_eval_and_sharded_probe(tmp_path):
    from tame_torch.scripts import scaling_eval, sharded_probe

    path = tmp_path / "scaling.json"
    res = scaling_eval.main(["--device", "cpu", "--n", "32", "--T", "8",
                             "--r", "2", "--iters", "2", "--repeats", "1",
                             "--out", str(path)])
    assert json.loads(path.read_text()) == res
    assert set(res["scaling"]) == {"1", "2"}
    assert res["scaling"]["1"]["efficiency"] == 1.0
    assert res["collective_bytes_per_iteration"] == layout_bytes(
        32, 8, 2, 2, 1, 16) < res["observation_bytes"]
    probe = sharded_probe.main(["--device", "cpu", "--n", "32", "--T", "4",
                                "--r", "1", "--iters", "2"])
    assert set(probe["ms_per_iter_turns"]) == {"plain", "one rank"}
    # no device time on the CPU: the profile says so, it invents nothing
    assert probe["profile"]["plain"]["device_ms_per_iter"] is None
    assert len(probe["host_us_per_collective"]) == 4
    assert not comm.is_initialized()


def test_scripts_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from tame_torch.scripts import multihost_probe, scaling_eval

    for main in (multihost_probe.main, scaling_eval.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main([])
