"""Port parity for K7's plain twin (``tame_torch.ops.eta_contract``): the
same numpy inputs go through the JAX einsum that
``scripts/layout_probe3.py`` checks its Pallas kernel against, through that
kernel's body (``_eta_kernel``, rebuilt here: the script runs everything at
import) in a ``pl.pallas_call`` in interpret mode, and through the port.

Tolerance: rtol 1e-5.  Every product of two bf16 values is exact in
float32, so the three differ only in the order of the float32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tame_torch.ops import eta_contract as tec

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
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(T, N, N)).astype(np.float32)
    Z = rng.normal(size=(T, N, R)).astype(np.float32)
    return (jnp.asarray(W, jnp.bfloat16), jnp.asarray(Z),
            torch.from_numpy(W).to(torch.bfloat16), torch.from_numpy(Z))


def test_twin_matches_the_pallas_kernel_and_the_einsum():
    jW, jZ, tW, tZ = _inputs(3, 48, 4, seed=0)
    got = tec.eta_contract_twin(tW, tZ).numpy()
    np.testing.assert_allclose(got, np.asarray(_pallas_eta(jW, jZ, BI=16)),
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, np.asarray(_jax_einsum(jW, jZ)),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("R", [1, 16])
def test_twin_matches_the_einsum_at_a_ragged_n(R):
    jW, jZ, tW, tZ = _inputs(3, 37, R, seed=R)
    np.testing.assert_allclose(tec.eta_contract_twin(tW, tZ).numpy(),
                               np.asarray(_jax_einsum(jW, jZ)), rtol=RTOL,
                               atol=0)


def test_panel_is_rounded_to_bf16_and_weights_read_as_given():
    """Z is rounded to bf16 before the products, W is not touched."""
    W = torch.ones(1, 2, 2, dtype=torch.bfloat16)
    Z = torch.full((1, 2, 1), 1.0 + 2.0 ** -10)   # not a bf16 value
    out = tec.eta_contract(W, Z)
    assert out.dtype == torch.float32 and out.shape == (1, 2, 1)
    assert torch.equal(out, torch.full((1, 2, 1), 2.0))


def test_cpu_takes_the_twin_and_the_kernel_wrapper_raises_off_the_card():
    tW = torch.randn(2, 8, 8).to(torch.bfloat16)
    tZ = torch.randn(2, 8, 3)
    before = tec.eta_contract_kernel.launches
    torch.testing.assert_close(tec.eta_contract(tW, tZ),
                               tec.eta_contract_twin(tW, tZ), rtol=0, atol=0)
    assert tec.eta_contract_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tec.eta_contract_kernel(tW, tZ)


@pytest.mark.parametrize("W_shape,Z_shape,dtype,err", [
    ((2, 8, 8), (2, 8, 17), torch.bfloat16, ValueError),  # R > 16
    ((2, 8, 8), (2, 8, 0), torch.bfloat16, ValueError),   # R = 0
    ((2, 8, 9), (2, 8, 4), torch.bfloat16, ValueError),   # not square
    ((2, 8, 8), (3, 8, 4), torch.bfloat16, ValueError),   # T differs
    ((2, 8, 8), (2, 8, 4), torch.float32, TypeError),     # f32 weights
])
def test_envelope(W_shape, Z_shape, dtype, err):
    with pytest.raises(err):
        tec.eta_contract(torch.zeros(W_shape, dtype=dtype),
                         torch.zeros(Z_shape))
