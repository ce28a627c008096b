"""Port parity for K7's plain twin (``tame_torch.ops.eta_contract``): the
same numpy inputs go through the JAX einsum that
``scripts/layout_probe3.py`` checks its Pallas kernel against, through that
kernel's body (``_eta_kernel``, rebuilt here: the script runs everything at
import) in a ``pl.pallas_call`` in interpret mode, and through the port,
which takes the panel as (n, T, R) and returns (m, T, R) (the probe's
(T, N, R) transposed); and the engines' contraction
(``cavi._eta_contract``) on time-major weights against the einsum of the
(i, j, t) weights it replaced.

Tolerance: rtol 1e-5.  Every product of two bf16 values is exact in
float32, so the three differ only in the order of the float32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tame_torch.inference import cavi as tcavi
from tame_torch.ops import eta_contract as tec
from tame_torch.utils import profiling

torch.set_num_threads(1)

RTOL = 1e-5


def _eta_kernel(W_ref, Z_ref, out_ref):
    """``scripts/layout_probe3.py:84``, line for line."""
    out_ref[...] = jnp.dot(
        W_ref[0], Z_ref[0],
        preferred_element_type=jnp.float32)[None]


def _pallas_eta(W, Z, BI, RP=128):
    """The probe's ``pallas_eta``: Z padded to a (T, N, RP) bf16 copy,
    grid (T, N / BI), one dot per (t, row tile); interpret mode."""
    T, N, _ = W.shape
    R = Z.shape[-1]
    Zp = jnp.zeros((T, N, RP), jnp.bfloat16).at[:, :, :R].set(
        Z.astype(jnp.bfloat16))
    out = pl.pallas_call(
        _eta_kernel,
        grid=(T, N // BI),
        in_specs=[
            pl.BlockSpec((1, BI, N), lambda t, i: (t, i, 0)),
            pl.BlockSpec((1, N, RP), lambda t, i: (t, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, BI, RP), lambda t, i: (t, i, 0)),
        out_shape=jax.ShapeDtypeStruct((T, N, RP), jnp.float32),
        interpret=True,
    )(W, Zp)
    return out[:, :, :R]


def _jax_einsum(W, Z):
    """``scripts/layout_probe3.py:110-112``: the kernel's reference."""
    return jnp.einsum("tij,tjr->tir", W, Z.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)


def _inputs(T, N, R, seed):
    """bf16 weights (T, N, N) and a (T, N, R) panel for JAX; the port's
    panel is its (N, T, R) transpose."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(T, N, N)).astype(np.float32)
    Z = rng.normal(size=(T, N, R)).astype(np.float32)
    return (jnp.asarray(W, jnp.bfloat16), jnp.asarray(Z),
            torch.from_numpy(W).to(torch.bfloat16),
            torch.from_numpy(Z).transpose(0, 1))


def _tmr(out):
    """The port's (m, T, R) as the probe's (T, m, R)."""
    return out.transpose(0, 1).numpy()


def test_twin_matches_the_pallas_kernel_and_the_einsum():
    jW, jZ, tW, tZ = _inputs(3, 48, 4, seed=0)
    got = _tmr(tec.eta_contract_twin(tW, tZ))
    np.testing.assert_allclose(got, np.asarray(_pallas_eta(jW, jZ, BI=16)),
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, np.asarray(_jax_einsum(jW, jZ)),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("R", [1, 16])
def test_twin_matches_the_einsum_at_a_ragged_n(R):
    jW, jZ, tW, tZ = _inputs(3, 37, R, seed=R)
    np.testing.assert_allclose(_tmr(tec.eta_contract_twin(tW, tZ)),
                               np.asarray(_jax_einsum(jW, jZ)), rtol=RTOL,
                               atol=0)


def test_panel_is_rounded_to_bf16_and_weights_read_as_given():
    """Z is rounded to bf16 before the products with bf16 weights, and
    not with float32 ones; W is not touched."""
    W = torch.ones(1, 2, 2, dtype=torch.bfloat16)
    Z = torch.full((2, 1, 1), 1.0 + 2.0 ** -10)   # not a bf16 value
    out = tec.eta_contract(W, Z)
    assert out.dtype == torch.float32 and out.shape == (2, 1, 1)
    assert torch.equal(out, torch.full((2, 1, 1), 2.0))
    assert torch.equal(tec.eta_contract(W.float(), Z),
                       torch.full((2, 1, 1), 2.0 + 2.0 ** -9))


def test_cpu_takes_the_twin_and_the_kernel_wrapper_raises_off_the_card():
    tW = torch.randn(2, 8, 8).to(torch.bfloat16)
    tZ = torch.randn(8, 2, 3)
    before = tec.eta_contract_kernel.launches
    torch.testing.assert_close(tec.eta_contract(tW, tZ),
                               tec.eta_contract_twin(tW, tZ), rtol=0, atol=0)
    assert tec.eta_contract_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tec.eta_contract_kernel(tW, tZ)


@pytest.mark.parametrize("W_shape,Z_shape,dtype,err", [
    ((2, 8, 8), (8, 2, 93), torch.bfloat16, ValueError),  # R > 92
    ((2, 8, 8), (8, 2, 0), torch.bfloat16, ValueError),   # R = 0
    ((2, 8, 9), (8, 2, 4), torch.bfloat16, ValueError),   # n differs
    ((2, 8, 8), (8, 3, 4), torch.bfloat16, ValueError),   # T differs
    ((2, 8, 8), (8, 2, 4), torch.float64, TypeError),     # f64 weights
])
def test_envelope(W_shape, Z_shape, dtype, err):
    with pytest.raises(err):
        tec.eta_contract(torch.zeros(W_shape, dtype=dtype),
                         torch.zeros(Z_shape))


# ---------------------------------------------------------------------------
# The engines' contraction on time-major weights (cavi._eta_contract)
# ---------------------------------------------------------------------------

def _problem(n, T, dtype, seed=0):
    """A reciprocal-free random ``Y`` (the contraction does not care),
    R^-1, the port's time-major weights and the (i, j, t) ``W0`` they
    replaced, rounded as the weights are."""
    rng = np.random.default_rng(seed)
    Y = torch.from_numpy(rng.normal(size=(n, n, T, 2)).astype(np.float32))
    R_inv = torch.tensor([[2.0, 0.6], [0.6, 2.0]])
    obs = tcavi.precompute_obs_constants(Y, R_inv, w_dtype=dtype)
    W_ijt = R_inv[0, 0] * Y[..., 0] + R_inv[0, 1] * Y[..., 1]
    return obs, W_ijt if dtype is None else W_ijt.to(dtype)


def _ijt_einsum(W, Z):
    """``cavi._eta_contract`` on the (i, j, t) weights before they went
    time-major (its CPU branches)."""
    if W.dtype == torch.bfloat16:
        return torch.einsum("ijt,jtr->itr", W.float(),
                            Z.to(torch.bfloat16).float())
    return torch.einsum("ijt,jtr->itr", W, Z)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [slice(None), slice(5, 17)],
                         ids=["whole", "stripe"])
@pytest.mark.parametrize("R,n", [(1, 37), (4, 48), (16, 37), (24, 40),
                                 (28, 37), (92, 16)])
def test_time_major_contract_equals_the_ijt_einsum(dtype, rows, R, n):
    """Whole matrix or a stripe at a row offset, against a panel that is
    a strided view of a state's means, R from 1 to 4r at r = 23, n a
    multiple of 8 or not: the einsum's values up to the order of the
    float32 sums."""
    T = 5
    obs, W_ijt = _problem(n, T, dtype, seed=R + n)
    assert isinstance(obs.W0, tcavi.TimeMajorWeights)
    assert obs.W0.tm.shape == (T, n, n) and obs.W0.dtype == W_ijt.dtype
    X = torch.randn(n, T, 2 + 2 * R, generator=torch.Generator()
                    .manual_seed(n))
    Z = X[..., 2 + R:]
    assert not Z.is_contiguous()
    got = tcavi._eta_contract(obs.W0[rows], Z)
    ref = _ijt_einsum(W_ijt[rows], Z)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=RTOL * ref.abs().max().item())


def test_twin_takes_a_float64_reference():
    """The CPU's float64 reference fits contract float64 weights in
    float64; K7's envelope on the card stays float32 and bf16."""
    obs, W_ijt = _problem(11, 4, None)
    W64 = tcavi.TimeMajorWeights(obs.W0.tm.double())
    Z = torch.randn(11, 4, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    got = tcavi._eta_contract(W64[2:9], Z)
    assert got.dtype == torch.float64
    torch.testing.assert_close(
        got, torch.einsum("ijt,jtr->itr", W_ijt[2:9].double(), Z),
        rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError):
        tec.eta_contract_kernel(W64.tm, Z)


def test_weights_are_stored_time_major_once():
    """Written time-major: the (i, j, t) weights' values, and the row sums
    of the whole float32 (i, j, t) weights, before any rounding, bit for
    bit; no (n, n, T) tensor is kept."""
    n, T = 9, 7
    f32_rows = _problem(n, T, None)[1].sum(1)
    for dtype in (None, torch.bfloat16):
        obs, W_ijt = _problem(n, T, dtype)
        assert torch.equal(obs.W0.tm, W_ijt.permute(2, 0, 1))
        assert torch.equal(obs.eta_a, f32_rows)
        assert obs.W0.tm.is_contiguous() and obs.W1.tm.is_contiguous()
        assert obs.eta_a.dtype == torch.float32
        stripe = obs.W1[2:5]
        assert stripe.tm.data_ptr() == obs.W1.tm[:, 2].data_ptr()


def _k7():
    return profiling.counters().get(profiling.K7_CONTRACTS, 0)


def _fit_parts(num_blocks=3, mask=None, mixed_precision=False,
               diag_mode="exact"):
    from tame_torch.models import TemporalAMEModel

    model = TemporalAMEModel(12, 5, 1, device="cpu", seed=1)
    model.generate_data()
    p = model.params
    state = tcavi.init_state(torch.Generator().manual_seed(3), 12, 5, 4,
                             "full", 0.1, 0.5)
    fi = tcavi.fit_inputs(model.Y, p.R_inv, mask,
                          mixed_precision=mixed_precision,
                          diag_mode=diag_mode, packed_mask=False,
                          num_blocks=num_blocks)
    return fi, tcavi.precompute_priors(p), p, state


@pytest.mark.parametrize("num_blocks", [3, 4])
@pytest.mark.parametrize("step", ["cavi", "smoothed"])
def test_a_block_step_counts_two_k7_contracts_a_block(num_blocks, step):
    from tame_torch.inference import smoothed as tsm

    fi, pri, p, state = _fit_parts(num_blocks)
    before = _k7()
    if step == "cavi":
        tcavi.cavi_step_block(state, fi.obs, pri, p, "full", 0.7,
                              num_blocks)
    else:
        tsm.smoothed_step_block(
            tsm.init_smoothed_state(torch.Generator().manual_seed(2), 12,
                                    5, 4), fi.obs, pri, p, 0.7, num_blocks)
    assert _k7() - before == 2 * num_blocks


@pytest.mark.parametrize("masked,mixed_precision,diag_mode,want", [
    (False, False, "stats", 1), (True, True, "stats", 1),
    (True, False, "stats", 1), (False, False, "exact", 0)])
def test_the_stats_diagnostics_count_one_k7_contract(masked,
                                                     mixed_precision,
                                                     diag_mode, want):
    """``W0 @ [V | U]`` in one launch: the two bf16 halves side by side
    under bf16 weights; the exact residual pass reads no weights."""
    from tame_torch.models import random_dyad_mask

    mask = (tcavi.gated_mask(random_dyad_mask(
        torch.Generator().manual_seed(4), 12, 5, 0.3), torch.zeros(12, 12, 5,
                                                                   2))
            if masked else None)
    fi, _, p, state = _fit_parts(mask=mask, mixed_precision=mixed_precision,
                                 diag_mode=diag_mode)
    before = _k7()
    tcavi.residual_stats(fi, state.X_mean, p.R_inv, diag_mode)
    assert _k7() - before == want


def test_jacobi_and_seq_steps_count_their_k7_contracts():
    """Two whole-matrix contractions a Jacobi step; two one-row
    contractions a node in the seq sweep."""
    fi, pri, p, state = _fit_parts()
    before = _k7()
    tcavi.cavi_step_jacobi(state, fi.obs, pri, p, "full", 0.7)
    assert _k7() - before == 2
    before = _k7()
    tcavi.cavi_step_seq(state, fi.obs, pri, p, "full", 0.7)
    assert _k7() - before == 2 * 12
