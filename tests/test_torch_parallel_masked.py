"""Port parity for the sharded fits' options: masks (the dense mask path
and K5's twin under ``TAME_PACKED_MASK=1``), bf16 weights, stats
diagnostics, the seq sweep, and the masked and segmented non-Gaussian
fits, sharded over ranks of ``torch.distributed``, against the port's
unsharded fits and ``tame``'s (JAX, CPU; its Pallas mask kernel in
interpret mode) on the same numpy inputs.

The sharded runs happen in one spawned gloo world of 4 CPU processes,
started once for the file on a FileStore under ``tmp_path``; the
rank-side cases live in ``tests/_torch_dist.py``, which imports no JAX.
Stats diagnostics run on 2 x 2 meshes too: a term that every rank added
whole would be counted once per rank of a time slice, which one rank
cannot show.  The one-rank cases hold the sharded fit to the plain one
bit for bit.

The K5 cases (``TAME_PACKED_MASK=1``) run a fixed horizon of
:data:`PACKED_ITERS` iterations.  K5 rounds the feature panel to bf16,
which makes one step a step function of the means: where ranks sum a
row's products in another order, an ulp of a mean can cross a bf16
rounding boundary, and from there the fits differ by about one bf16 step
(~4e-3 in a mean), which the iteration does not damp.  On the base
problem on 2 x 2 ranks the first such crossing comes in iteration 2 (the
means 8e-6 apart after it against 2e-7 after iteration 1) and the gap
reaches 3e-3 by iteration 8.  ``tests/test_torch_masked.py`` documents
the same between the port and ``tame``, whose Pallas kernel sums the
bf16 products in its own order: on the base problem their unsharded K5
fits are 1.1e-5 apart after one iteration and 1.3e-4 after three.  So
the K5 cases hold the sharded bounds against both over two iterations;
to the stop, on one rank, they hold the plain fit's bits; and over the
card's fixed horizon of :data:`HORIZON_ITERS` iterations on several ranks
they stay within one bf16 step of the unsharded port's fit (0.0065 on
2 x 2 and 0.0067 on 4 x 1 with max |X| 2.2, ELBO 1.7e-4 and 1.1e-3
apart, against a step of 0.017 at that scale).  The smoothed
K5 fit is 2.5e-4 from ``tame``'s after two iterations unsharded
(``tests/test_torch_masked_smoothed.py`` holds one step to 1e-3): its
sharded fit is held to that gap plus the sharded bound.
"""

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
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import fit_cavi_bernoulli, fit_cavi_poisson
from tame_torch.inference import smoothed as tsm
from tame_torch.models import params_from_numpy
from tame_torch.parallel import comm, make_mesh, shard_fit_inputs
from tame_torch.parallel import shard_smoothed_inputs
from tame_torch.parallel.comm_analysis import layout_bytes
from tame_torch.ops import masked_contract as tmc

from _torch_dist import run_world

torch.set_num_threads(1)

# test_parallel.py's tolerances for a sharded fit against one device.
ATOL_X = 1e-4
RTOL_ELBO = 1e-4
MISSING = 0.3
FIT = dict(structure="full", learning_rate=0.7, max_iter=20)
PACKED_ITERS = 2
PACKED = dict(FIT, max_iter=PACKED_ITERS, tolerance=0.0)
HORIZON_ITERS = 30   # chip_smoke.py's fixed budget for the sharded legs
BF16_STEP = torch.finfo(torch.bfloat16).eps   # 2^-7, a step at 1.0


def _np(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def _mask(n, T, seed):
    """A symmetric zero-diagonal float32 mask, 30 % of the dyads hidden."""
    rng = np.random.default_rng(seed)
    keep = ((rng.random((n, n, T)) > MISSING)
            * np.triu(np.ones((n, n)), k=1)[:, :, None])
    return (keep + keep.transpose(1, 0, 2)).astype(np.float32)


def _gaussian(n=16, T=8, r=2, seed=5):
    model = JModel(n_nodes=n, n_time=T, latent_dim=r, seed=seed)
    Y, _ = model.generate_data(return_latents=True)
    init = jcavi.init_state(jax.random.PRNGKey(0), n, T, model.d, "full",
                            0.1, 0.5)
    return dict(Y=np.asarray(Y), init=_np(init), params=_np(model.params),
                mask=_mask(n, T, seed))


def _family(family):
    n, T = 32, 8
    p = j_build_params(ModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                   seed=0))
    Y, _ = j_sample(p, jax.random.PRNGKey(0), n, T, family=family)
    init = jcavi.init_state(jax.random.PRNGKey(1), n, T, p.d, "full", 0.1,
                            0.5)
    return dict(Y=np.asarray(Y), init=_np(init), params=_np(p),
                mask=_mask(n, T, 7))


def _smoothed():
    model = JModel(n_nodes=16, n_time=6, latent_dim=1, seed=11)
    Y, _ = model.generate_data(return_latents=True)
    init = jsm.init_smoothed_state(jax.random.PRNGKey(0), 16, 6, 4)
    return dict(Y=np.asarray(Y), init=_np(init), params=_np(model.params),
                mask=_mask(16, 6, 11))


def _block(**kw):
    return dict(FIT, update_mode="block", num_blocks=4, **kw)


# name -> (problem, nodes, time, fit keywords, masked, packed)
GAUSSIAN = {
    "mask-jacobi-2x1": ("base", 2, 1, dict(FIT, update_mode="jacobi"),
                        True, False),
    "mask-jacobi-2x2": ("base", 2, 2, dict(FIT, update_mode="jacobi"),
                        True, False),
    "mask-block-4x1": ("base", 4, 1, _block(), True, False),
    "mask-block-2x2": ("base", 2, 2, _block(), True, False),
    "mask-uneven-2x1": ("uneven", 2, 1, _block(), True, False),
    "packed-2x2": ("base", 2, 2, dict(PACKED, update_mode="block",
                                      num_blocks=4, corrected=True),
                   True, True),
    "packed-jacobi-4x1": ("base", 4, 1, dict(PACKED, update_mode="jacobi"),
                          True, True),
    "bf16-mask-2x2": ("base", 2, 2, _block(mixed_precision=True), True,
                      False),
    "stats-2x1": ("base", 2, 1, _block(diag_mode="stats"), False, False),
    "stats-2x2": ("base", 2, 2, _block(diag_mode="stats"), False, False),
    "stats-mask-2x1": ("base", 2, 1, _block(diag_mode="stats"), True,
                       False),
    "stats-mask-2x2": ("base", 2, 2, _block(diag_mode="stats"), True,
                       False),
    "stats-mask-4x1": ("base", 4, 1, _block(diag_mode="stats"), True,
                       False),
    "stats-packed-2x2": ("base", 2, 2, dict(PACKED, update_mode="block",
                                            num_blocks=4, diag_mode="stats"),
                         True, True),
    "seq-2x1": ("base", 2, 1, dict(FIT, update_mode="seq"), False, False),
    "seq-2x2": ("base", 2, 2, dict(FIT, update_mode="seq"), False, False),
}
SMOOTHED = {
    "smoothed-mask-4x1": (dict(max_iter=15, learning_rate=0.8,
                               tolerance=0.0), False),
    "smoothed-packed-stats-4x1": (dict(max_iter=PACKED_ITERS,
                                       learning_rate=0.8, tolerance=0.0,
                                       update_mode="block", num_blocks=4,
                                       diag_mode="stats"), True),
}
# K5 on several ranks over the card's fixed horizon: (nodes, time, fit)
HORIZON = {
    "packed-2x2-horizon": (2, 2, dict(
        FIT, max_iter=HORIZON_ITERS, tolerance=0.0, update_mode="block",
        num_blocks=4, corrected=True)),
    "packed-jacobi-4x1-horizon": (4, 1, dict(
        FIT, max_iter=HORIZON_ITERS, tolerance=0.0, update_mode="jacobi")),
}
FAMILY_KW = dict(max_iter=40, tolerance=0.0)
RESUME = dict(total=16, first=8, kw=dict(tolerance=0.0))


@pytest.fixture(scope="module")
def problems():
    return {"base": _gaussian(), "uneven": _gaussian(n=20, seed=6),
            "bernoulli": _family("bernoulli"), "poisson": _family("poisson"),
            "smoothed": _smoothed()}


def _with_mask(kw, prob, masked):
    return dict(kw, mask=prob["mask"]) if masked else kw


@pytest.fixture(scope="module")
def world(problems, tmp_path_factory):
    """Every case run once in one world of 4 ranks: rank-ordered results."""
    cases = []
    for name, (which, a, b, kw, masked, packed) in GAUSSIAN.items():
        prob = problems[which]
        cases.append((name, "fit", dict(
            nodes=a, time=b, Y=prob["Y"], init=prob["init"],
            params=prob["params"], kw=_with_mask(kw, prob, masked),
            packed=packed)))
    prob = problems["base"]
    for name, (a, b, kw) in HORIZON.items():
        cases.append((name, "fit", dict(
            nodes=a, time=b, Y=prob["Y"], init=prob["init"],
            params=prob["params"], kw=dict(kw, mask=prob["mask"]),
            packed=True)))
    prob = problems["smoothed"]
    for name, (kw, packed) in SMOOTHED.items():
        cases.append((name, "smoothed", dict(
            nodes=4, Y=prob["Y"], init=prob["init"], params=prob["params"],
            kw=dict(kw, mask=prob["mask"]), packed=packed)))
    for fam in ("bernoulli", "poisson"):
        prob = problems[fam]
        cases.append((f"{fam}-mask-2x2", "fit", dict(
            nodes=2, time=2, Y=prob["Y"], init=prob["init"],
            params=prob["params"], family=fam,
            kw=dict(FAMILY_KW, mask=prob["mask"]))))
    prob = problems["poisson"]
    cases.append(("poisson-resume-2x2", "resume", dict(
        nodes=2, time=2, Y=prob["Y"], init=prob["init"],
        params=prob["params"], total=RESUME["total"],
        first=RESUME["first"],
        kw=dict(RESUME["kw"], mask=prob["mask"]))))
    cases.append(("bytes-masked", "bytes", dict(
        nodes=2, time=2, n=16, T=8, r=2, num_blocks=4, masked=True,
        mixed_precision=True, diag_mode="stats")))
    return run_world(4, cases, tmp_path_factory.mktemp("masked_world"))


def _members(world, name):
    return [r[name] for r in world if r[name] is not None]


def _packed_env(monkeypatch, packed):
    if packed:
        monkeypatch.setenv("TAME_PACKED_MASK", "1")
    else:
        monkeypatch.delenv("TAME_PACKED_MASK", raising=False)


def _same_fit(got, X_ref, elbo_ref, gap=0.0):
    """``got`` within the sharded bounds of a reference fit, its means
    beyond a ``gap`` the unsharded port already has from it."""
    assert np.allclose(got["X_mean"], X_ref, atol=gap + ATOL_X)
    assert got["n_iter"] == len(elbo_ref)
    assert np.allclose(got["elbo"], elbo_ref, rtol=RTOL_ELBO)


def _same_on_every_rank(members, size):
    got = members[0]
    assert len(members) == size
    assert all(m["n_iter"] == got["n_iter"] for m in members)
    assert all(np.array_equal(m["elbo"], got["elbo"]) for m in members)
    return got


@pytest.mark.parametrize("name", list(GAUSSIAN))
def test_sharded_option_matches_port_and_tame(world, problems, name,
                                              monkeypatch):
    which, a, b, kw, masked, packed = GAUSSIAN[name]
    prob = problems[which]
    _packed_env(monkeypatch, packed)
    got = _same_on_every_rank(_members(world, name), a * b)
    mask = prob["mask"] if masked else None
    port = tcavi.fit_cavi(
        torch.as_tensor(prob["Y"]), params_from_numpy(prob["params"]),
        tcavi.state_from_numpy(prob["init"]), fused=False,
        mask=None if mask is None else torch.as_tensor(mask), **kw)
    ref = jcavi.fit_cavi(prob["Y"], tame.models.params.AMEParams(
        **prob["params"]), jcavi.CaviState(**prob["init"]), mask=mask,
        **kw)
    _same_fit(got, port.X_mean.numpy(),
              port.elbo_history[:port.n_iter].numpy())
    _same_fit(got, np.asarray(ref.X_mean),
              np.asarray(ref.elbo_history)[:int(ref.n_iter)])


@pytest.mark.parametrize("name", list(HORIZON))
def test_sharded_packed_stays_within_a_bf16_step(world, problems, name,
                                                 monkeypatch):
    """K5 on several ranks against the unsharded port's K5 fit over the
    card's fixed horizon: a flipped bf16 rounding of the panel moves the
    fits apart by about one bf16 step at the means' scale, and the
    iteration does not let it grow past that."""
    a, b, kw = HORIZON[name]
    prob = problems["base"]
    _packed_env(monkeypatch, True)
    got = _same_on_every_rank(_members(world, name), a * b)
    port = tcavi.fit_cavi(
        torch.as_tensor(prob["Y"]), params_from_numpy(prob["params"]),
        tcavi.state_from_numpy(prob["init"]), fused=False,
        mask=torch.as_tensor(prob["mask"]), **kw)
    X = port.X_mean.numpy()
    elbo = port.elbo_history[:port.n_iter].numpy()
    assert got["n_iter"] == port.n_iter == HORIZON_ITERS
    assert np.abs(got["X_mean"] - X).max() <= BF16_STEP * np.abs(X).max()
    assert np.allclose(got["elbo"], elbo, rtol=BF16_STEP)


@pytest.mark.parametrize("name", list(SMOOTHED))
def test_sharded_masked_smoothed_matches_port_and_tame(world, problems,
                                                       name, monkeypatch):
    kw, packed = SMOOTHED[name]
    prob = problems["smoothed"]
    _packed_env(monkeypatch, packed)
    got = _same_on_every_rank(_members(world, name), 4)
    port = tsm.fit_cavi_smoothed(
        torch.as_tensor(prob["Y"]), params_from_numpy(prob["params"]),
        tsm.smoothed_state_from_numpy(prob["init"]),
        mask=torch.as_tensor(prob["mask"]), **kw)
    # K5's bf16 panels with stats diagnostics: the port's diagnostics
    # carry their panels at ~16 bits (cavi._diag_contract), so its ELBO is
    # held to JAX's exact diagnostics on the same packed steps
    jkw = (dict(kw, diag_mode="exact")
           if packed and kw.get("diag_mode") == "stats" else kw)
    ref = jsm.fit_cavi_smoothed(
        prob["Y"], tame.models.params.AMEParams(**prob["params"]),
        jsm.SmoothedState(**prob["init"]), mask=prob["mask"], **jkw)
    _same_fit(got, port.state.X_mean.numpy(),
              port.elbo_history[:port.n_iter].numpy())
    gap = np.abs(port.state.X_mean.numpy() - np.asarray(ref.state.X_mean))
    _same_fit(got, np.asarray(ref.state.X_mean),
              np.asarray(ref.elbo_history)[:int(ref.n_iter)],
              gap=gap.max() if packed else 0.0)


@pytest.mark.parametrize("family", ["bernoulli", "poisson"])
def test_sharded_masked_family_matches_port_and_tame(world, problems,
                                                     family):
    prob = problems[family]
    got = _same_on_every_rank(_members(world, f"{family}-mask-2x2"), 4)
    port_fit = fit_cavi_bernoulli if family == "bernoulli" \
        else fit_cavi_poisson
    port = port_fit(torch.as_tensor(prob["Y"]),
                    params_from_numpy(prob["params"]),
                    tcavi.state_from_numpy(prob["init"]),
                    mask=torch.as_tensor(prob["mask"]), **FAMILY_KW)
    ref_fit = j_bernoulli if family == "bernoulli" else j_poisson
    ref = ref_fit(prob["Y"], tame.models.params.AMEParams(**prob["params"]),
                  jcavi.CaviState(**prob["init"]), mask=prob["mask"],
                  **FAMILY_KW)
    _same_fit(got, port.X_mean.numpy(),
              port.elbo_history[:port.n_iter].numpy())
    _same_fit(got, np.asarray(ref.X_mean),
              np.asarray(ref.elbo_history)[:int(ref.n_iter)])


def test_sharded_poisson_resume_is_the_one_shot_fit(world, problems):
    """Killed at 8 of 16 iterations and resumed from the sharded result's
    ``resume_carry()``: the one-shot sharded fit's bits, which are
    ``tame``'s one-shot fit to the sharded bounds."""
    members = _members(world, "poisson-resume-2x2")
    assert len(members) == 4
    prob = problems["poisson"]
    ref = j_poisson(prob["Y"], tame.models.params.AMEParams(
        **prob["params"]), jcavi.CaviState(**prob["init"]),
        mask=prob["mask"], max_iter=RESUME["total"], **RESUME["kw"])
    for got in members:
        assert got["n_iter"] == RESUME["total"]
        assert np.array_equal(got["resumed"], got["one"])
        assert np.array_equal(got["resumed_elbo"], got["one_elbo"])
        assert np.allclose(got["one"], np.asarray(ref.X_mean), atol=ATOL_X)
        assert np.allclose(got["one_elbo"], np.asarray(
            ref.elbo_history)[:RESUME["total"]], rtol=RTOL_ELBO)


def test_masked_iteration_moves_the_layout_bytes(world):
    """A masked bf16 iteration with stats diagnostics moves what a dense
    one moves: the mask's counts are all-reduced once, before the loop."""
    for stats in _members(world, "bytes-masked"):
        assert stats["all_gather"] == {"count": 4, "bytes": 4 * 4 * 48 * 4}
        assert stats["all_reduce"] == {"count": 1, "bytes": 6 * 4}
        assert sum(v["bytes"] for v in stats.values()) == layout_bytes(
            16, 8, 2, 2, 2, 4)


@pytest.mark.parametrize("n,blocks,nodes", [(20, 4, 2), (2000, 16, 2),
                                            (37, 1, 3)])
def test_rank_stripes(n, blocks, nodes):
    """A rank's K5 stripes: its share of each phase, ragged (62 or 63 rows
    of a 125-row block on two ranks), each laid out as a ``pack_mask``
    entry; one rank's stripes are ``pack_mask``'s blocks."""
    from types import SimpleNamespace

    from tame_torch.parallel.mesh import axis_slice
    from tame_torch.parallel.sharded_cavi import Geometry, phases

    T = 3
    mask = torch.from_numpy(_mask(n, T, 0))
    bs = n // blocks
    steps = phases(n, "block", blocks)
    for k in range(nodes):
        fake = SimpleNamespace(
            shape={"nodes": nodes, "time": 1}, coord={"nodes": k, "time": 0},
            piece=lambda axis, size, index=None, k=k: axis_slice(
                axis, size, nodes if axis == "nodes" else 1,
                k if axis == "nodes" else 0))
        geo = Geometry(fake, n, T)
        local = mask[geo.rows]
        stripes = tmc.pack_rows(local, [geo.local(geo.share(lo, hi))
                                        for lo, hi in steps])
        rows = [len(range(n)[geo.share(lo, hi)]) for lo, hi in steps]
        assert [s.shape[1] for s in stripes] == rows
        assert all(s.shape == (T, m, -(-n // 16) * 16)
                   for s, m in zip(stripes, rows))
        Z = torch.randn(n, T, 5, generator=torch.Generator().manual_seed(k))
        got = torch.cat([tmc.packed_rows_contract(s, Z) for s in stripes])
        want = torch.einsum("ijt,jtk->itk", local,
                            Z.to(torch.bfloat16).float())
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        if n == 2000:
            assert set(rows) == {62, 63}
    whole = tmc.pack_rows(mask, [slice(b * bs, (b + 1) * bs)
                                 for b in range(blocks)])
    assert torch.equal(torch.stack(whole), tmc.pack_mask(mask, blocks))


# -- one rank: the plain fit, bit for bit ------------------------------------

@pytest.fixture
def one_rank():
    assert not comm.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    comm.destroy()


ONE_RANK = {
    "mask-jacobi": (dict(FIT, update_mode="jacobi", corrected=True), True,
                    False),
    "mask-block": (_block(), True, False),
    "packed-block": (_block(corrected=True), True, True),
    "packed-jacobi": (dict(FIT, update_mode="jacobi"), True, True),
    "bf16-stats-mask": (_block(mixed_precision=True, diag_mode="stats"),
                        True, False),
    "bf16-stats-packed": (_block(mixed_precision=True, diag_mode="stats"),
                          True, True),
    "stats": (_block(diag_mode="stats"), False, False),
    "bf16": (_block(mixed_precision=True), False, False),
    "seq": (dict(FIT, update_mode="seq", max_iter=6), False, False),
}


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_option_is_the_plain_fit(one_rank, problems, name,
                                          monkeypatch):
    kw, masked, packed = ONE_RANK[name]
    prob = problems["base"]
    _packed_env(monkeypatch, packed)
    mask = torch.as_tensor(prob["mask"]) if masked else None
    Y, p = torch.as_tensor(prob["Y"]), params_from_numpy(prob["params"])
    init = tcavi.state_from_numpy(prob["init"])
    ref = tcavi.fit_cavi(Y, p, init, mask=mask, fused=False, **kw)
    Y_s, init_s = shard_fit_inputs(one_rank, Y, init)
    out = tcavi.fit_cavi(Y_s, p, init_s, mask=mask, **kw)
    full = out.full()
    assert torch.equal(full.X_mean, ref.X_mean)
    assert torch.equal(full.X_cov, ref.X_cov)
    n = ref.n_iter
    assert torch.equal(out.elbo_history[:n], ref.elbo_history[:n])
    assert torch.equal(out.mse_history[:n], ref.mse_history[:n])
    assert (out.n_iter, out.converged) == (ref.n_iter, ref.converged)


@pytest.mark.parametrize("packed", [False, True])
def test_one_rank_masked_smoothed_is_the_plain_fit(one_rank, problems,
                                                   packed, monkeypatch):
    _packed_env(monkeypatch, packed)
    prob = problems["smoothed"]
    Y, p = torch.as_tensor(prob["Y"]), params_from_numpy(prob["params"])
    init = tsm.smoothed_state_from_numpy(prob["init"])
    kw = dict(max_iter=8, update_mode="block", num_blocks=4,
              mixed_precision=True, diag_mode="stats",
              mask=torch.as_tensor(prob["mask"]))
    ref = tsm.fit_cavi_smoothed(Y, p, init, **kw)
    Y_s, init_s = shard_smoothed_inputs(one_rank, Y, init)
    out = tsm.fit_cavi_smoothed(Y_s, p, init_s, **kw)
    assert torch.equal(out.full().state.X_mean, ref.state.X_mean)
    assert torch.equal(out.elbo_history[:8], ref.elbo_history[:8])


@pytest.mark.parametrize("family", ["bernoulli", "poisson"])
def test_one_rank_masked_family_is_the_plain_fit(one_rank, problems,
                                                 family):
    prob = problems[family]
    fit = fit_cavi_bernoulli if family == "bernoulli" else fit_cavi_poisson
    Y, p = torch.as_tensor(prob["Y"]), params_from_numpy(prob["params"])
    init = tcavi.state_from_numpy(prob["init"])
    mask = torch.as_tensor(prob["mask"])
    ref = fit(Y, p, init, mask=mask, max_iter=12, tolerance=0.0)
    Y_s, init_s = shard_fit_inputs(one_rank, Y, init)
    out = fit(Y_s, p, init_s, mask=mask, max_iter=12, tolerance=0.0)
    assert torch.equal(out.full().X_mean, ref.X_mean)
    assert torch.equal(out.elbo_history[:12], ref.elbo_history[:12])


def test_one_rank_poisson_resume_is_the_plain_segmented_fit(one_rank,
                                                            problems):
    """A sharded segment resumed from ``resume_carry()`` gives the plain
    segmented fit's bits, which are the plain one-shot fit's."""
    prob = problems["poisson"]
    Y, p = torch.as_tensor(prob["Y"]), params_from_numpy(prob["params"])
    init = tcavi.state_from_numpy(prob["init"])
    one = fit_cavi_poisson(Y, p, init, max_iter=12, tolerance=0.0)
    Y_s, init_s = shard_fit_inputs(one_rank, Y, init)
    head = fit_cavi_poisson(Y_s, p, init_s, max_iter=6, tolerance=0.0)
    _, mid = shard_fit_inputs(one_rank, Y, head.full())
    tail = fit_cavi_poisson(Y_s, p, mid, max_iter=6, tolerance=0.0,
                            carry=head.resume_carry())
    assert torch.equal(tail.full().X_mean, one.X_mean)
    assert torch.equal(tail.elbo_history[:6], one.elbo_history[6:12])
