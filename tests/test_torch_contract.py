"""Port parity for the two contraction kernels' plain twins and the mask
generator: the same numpy inputs go through ``tame.ops.masked_contract`` /
``tame.ops.dual_contract`` (JAX, Pallas in interpret mode, as the JAX
package's own tests run them) and their ``tame_torch`` counterparts.

Tolerances: atol 1e-5, the JAX tests' own bound for these kernels
(``tests/test_inference.py``); both sides sum the same bf16-rounded
products in float32, in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.ops import dual_contract as jdc
from tame.ops import masked_contract as jmc
from tame_torch.models import random_dyad_mask
from tame_torch.ops import dual_contract as tdc
from tame_torch.ops import masked_contract as tmc

torch.set_num_threads(1)

ATOL = 1e-5


def _mask(rng, n, T, keep=0.6):
    m = (rng.random((n, n, T)) < keep).astype(np.float32)
    return m * (1.0 - np.eye(n, dtype=np.float32))[:, :, None]


class TestMaskedContract:
    @pytest.mark.parametrize("n,T,K,nb", [(20, 3, 5, 4), (24, 2, 11, 1)])
    def test_twin_matches_jax_kernel(self, n, T, K, nb):
        rng = np.random.default_rng(n + K)
        mask = _mask(rng, n, T)
        Z = rng.normal(size=(n, T, K)).astype(np.float32)
        jpm = jmc.pack_mask(jnp.asarray(mask), nb)
        tpm = tmc.pack_mask(torch.from_numpy(mask), nb)
        bs = n // nb
        for k in range(nb):
            ref = jmc.packed_rows_contract(jpm[k], jnp.asarray(Z),
                                           interpret=True)[:bs]
            got = tmc.packed_rows_contract(tpm[k], torch.from_numpy(Z))[:bs]
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=0, atol=ATOL)

    def test_pack_layout_is_block_major(self):
        """Stripe k holds rows k*bs..(k+1)*bs-1 for every t, partners
        zero-padded to a multiple of 16, as int8."""
        rng = np.random.default_rng(3)
        n, T, nb = 20, 3, 4
        mask = _mask(rng, n, T)
        pm = tmc.pack_mask(torch.from_numpy(mask), nb)
        assert pm.dtype == torch.int8 and pm.shape == (nb, T, 5, 32)
        want = np.moveaxis(mask, -1, 0).reshape(T, nb, 5, n).swapaxes(0, 1)
        np.testing.assert_array_equal(pm[..., :n].numpy(), want)
        assert not pm[..., n:].any()
        # the JAX layout holds the same rows (its padding differs)
        jpm = np.asarray(jmc.pack_mask(jnp.asarray(mask), nb))
        np.testing.assert_array_equal(pm[..., :n].numpy(), jpm[:, :, :5, :n])

    def test_cpu_takes_the_twin_and_checks_shapes(self):
        pm = tmc.pack_mask(torch.ones(8, 8, 2), 2)
        before = tmc.packed_rows_contract_kernel.launches
        out = tmc.packed_rows_contract(pm[0], torch.ones(8, 2, 3))
        assert out.shape == (4, 2, 3)
        assert torch.equal(out, torch.full((4, 2, 3), 8.0))
        assert tmc.packed_rows_contract_kernel.launches == before
        with pytest.raises(ValueError, match="does not fit"):
            tmc.packed_rows_contract(pm[0], torch.ones(8, 3, 3))
        with pytest.raises(ValueError, match="must divide"):
            tmc.pack_mask(torch.ones(9, 9, 2), 2)


class TestDualContract:
    @pytest.mark.parametrize("T,n,m", [(3, 20, 4), (2, 13, 7)])
    def test_twin_matches_jax_kernel(self, T, n, m):
        """``tests/test_inference.py``'s dual-contract check, through both
        packages from one numpy input."""
        rng = np.random.default_rng(T * n + m)
        y0 = rng.normal(size=(T, n, n)).astype(np.float32)
        Z = rng.normal(size=(T, n, m)).astype(np.float32)
        jrow, jcol = jdc.dual_contract(jnp.asarray(y0), jnp.asarray(Z),
                                       interpret=True)
        row, col = tdc.dual_contract(torch.from_numpy(y0),
                                     torch.from_numpy(Z))
        np.testing.assert_allclose(row.numpy(), np.asarray(jrow), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(col.numpy(), np.asarray(jcol), rtol=0,
                                   atol=ATOL)

    def test_layout_and_dispatch(self):
        y0 = torch.randn(2, 13, 13)
        Wp = tdc.pad_data(y0)
        assert Wp.dtype == torch.bfloat16 and Wp.shape == (2, 13, 16)
        assert not Wp[..., 13:].any()
        assert torch.equal(Wp[..., :13], y0.to(torch.bfloat16))
        before = tdc.dual_contract_kernel.launches
        row, col = tdc.dual_contract_padded(Wp, torch.randn(2, 13, 3))
        assert row.shape == col.shape == (2, 13, 3)
        assert tdc.dual_contract_kernel.launches == before
        with pytest.raises(TypeError):
            tdc.dual_contract_padded(Wp.float(), torch.randn(2, 13, 3))


class TestRandomDyadMask:
    def test_invariants(self):
        g = torch.Generator().manual_seed(0)
        m = random_dyad_mask(g, 60, 5, 0.3)
        assert m.shape == (60, 60, 5) and m.dtype == torch.float32
        assert torch.equal(m, m.transpose(0, 1))
        assert (m[torch.arange(60), torch.arange(60)] == 0).all()
        assert set(m.unique().tolist()) <= {0.0, 1.0}
        share = m.sum() / (60 * 59 * 5)
        assert abs(share.item() - 0.7) < 0.02
        again = random_dyad_mask(torch.Generator().manual_seed(0), 60, 5,
                                 0.3)
        assert torch.equal(again, m)

    def test_matches_jax_distribution(self):
        """The two packages' streams differ; the observed share of the JAX
        mask and the port's agree within sampling error."""
        from tame.models import random_dyad_mask as jax_mask

        jm = np.asarray(jax_mask(jax.random.PRNGKey(0), 40, 6, 0.45))
        tm = random_dyad_mask(torch.Generator().manual_seed(0), 40, 6,
                              0.45).numpy()
        off = 40 * 39 * 6
        assert abs(jm.sum() / off - tm.sum() / off) < 0.03
