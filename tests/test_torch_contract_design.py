"""The schedules of K6 ``dual_contract`` and K5 ``masked_contract``, modelled
in numpy from the index arithmetic of ``tame_torch/csrc`` and held against
the twins, JAX's Pallas kernels (interpret mode) and each other; and the
Python mirrors of the two kernels' launch layouts against the 227 KB a
block may use.

K6's sums may take any order: its model is held exactly on integer data,
whose sums every order gives exactly, and within float32 rounding on
normal data.  K5's must not: the masked fits stop where a relative ELBO gain
first stays under their tolerance, so its redesign keeps each output's
arithmetic.  The K5 tests derive, from each design's copy and fragment
addressing, which partner reaches which k position of which accumulator
step, run both through one emulated ``mma.sync`` step and require the
outputs to be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.ops import dual_contract as jdc
from tame_torch.ops import dual_contract as tdc
from tame_torch.ops import masked_contract as tmc

torch.set_num_threads(1)

ATOL = 1e-5


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


# --------------------------------------------------------------------- K6


def k6_model(W: np.ndarray, Z: np.ndarray):
    """K6's walk of one launch per slice: per time step a cluster of
    ``CLUSTER`` ranks, rank c owning row tiles c R .. c R + R - 1; per
    128-column chunk each rank's tiles in order (row sums kept across the
    chunks, column partials over the stripe), then the chunk's columns
    summed over the ranks in rank order."""
    T, n, _ = W.shape
    m = Z.shape[-1]
    Wb, Zb = _bf16(W), _bf16(Z)
    row = np.zeros((T, n, m), np.float32)
    col = np.zeros((T, n, m), np.float32)
    R = -(-(-(-n // tdc.ROW_TILE)) // tdc.CLUSTER)   # tiles per rank
    for k0, width in tdc.slices(m):
        zs = Zb[..., k0:k0 + width]
        for t in range(T):
            racc = np.zeros((tdc.CLUSTER, R * tdc.ROW_TILE, width),
                            np.float32)
            for j0 in range(0, n, tdc.CHUNK):
                cols = slice(j0, min(j0 + tdc.CHUNK, n))
                partial = np.zeros((tdc.CLUSTER, cols.stop - j0, width),
                                   np.float32)
                for c in range(tdc.CLUSTER):
                    for rt in range(R):
                        i0 = (c * R + rt) * tdc.ROW_TILE
                        rows = slice(min(i0, n), min(i0 + tdc.ROW_TILE, n))
                        tile = Wb[t, rows, cols]
                        r0 = i0 - c * R * tdc.ROW_TILE
                        racc[c, r0:r0 + tile.shape[0]] += tile @ zs[t, cols]
                        partial[c] += tile.T @ zs[t, rows]
                total = partial[0].copy()
                for c in range(1, tdc.CLUSTER):   # rank order
                    total += partial[c]
                col[t, cols, k0:k0 + width] = total
            for c in range(tdc.CLUSTER):
                i0 = c * R * tdc.ROW_TILE
                rows = slice(min(i0, n), min(i0 + R * tdc.ROW_TILE, n))
                row[t, rows, k0:k0 + width] = racc[c, :rows.stop - rows.start]
    return row, col


@pytest.mark.parametrize("data", ["integer", "normal"])
@pytest.mark.parametrize("m", [1, 4, 13, 16, 40])
@pytest.mark.parametrize("n", [20, 37, 300])
def test_k6_tile_walk_matches_twin_and_jax(n, m, data):
    """On small integers every sum is exact in float32, so the walk must
    place every product exactly where the twin and JAX do: equality.  On
    normal data the three sum in other orders: atol 1e-5 up to n = 37 (the
    JAX tests' bound), growing with n past it (the twin and JAX differ by
    up to 2.7e-5 from each other at n = 300)."""
    rng = np.random.default_rng(n * 64 + m)
    T = 2
    if data == "integer":
        y0 = rng.integers(-2, 3, size=(T, n, n)).astype(np.float32)
        Z = rng.integers(-3, 4, size=(T, n, m)).astype(np.float32)
        atol = 0.0
    else:
        y0 = rng.normal(size=(T, n, n)).astype(np.float32)
        Z = rng.normal(size=(T, n, m)).astype(np.float32)
        atol = ATOL * max(1.0, n / 37)
    row, col = k6_model(y0, Z)
    trow, tcol = tdc.dual_contract(torch.from_numpy(y0), torch.from_numpy(Z))
    jrow, jcol = jdc.dual_contract(jnp.asarray(y0), jnp.asarray(Z),
                                   interpret=True)
    for got, ref in [(row, trow.numpy()), (col, tcol.numpy()),
                     (row, np.asarray(jrow)), (col, np.asarray(jcol))]:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("m,want", [(1, [(0, 1)]), (16, [(0, 16)]),
                                    (17, [(0, 16), (16, 1)]),
                                    (40, [(0, 16), (16, 16), (32, 8)])])
def test_k6_slices_cover_every_column_once(m, want):
    assert tdc.slices(m) == want
    assert tdc.launch_layout(3, 37, m)["slices"] == want


# --------------------------------------------------------------------- K5
#
# Each design is described by where the partner at k position kk of the
# accumulator step (chunk c, ks) of partner quarter q comes from, derived
# from its copy and fragment addressing, for the A (mask) and B (panel)
# operands separately; the two must agree for the mma to be the one the
# reference takes.


def parent_partner(q, c, ks, kk, operand):
    """The parent kernel: 8 warps (row half, quarter = warp / 2) over a
    staged 128-partner chunk, 32-bit words of partner pairs; A register
    h = 0..3 reads word kw + tq (+ 4 for h >= 2), B b0 / b1 word kw + tq
    / + 4, with kw = 16 quarter + 8 ks; the low half is the even
    partner."""
    tq, lo = (kk % 8) // 2, kk % 2
    kw = 16 * q + 8 * ks
    word = kw + tq + (4 if kk >= 8 else 0)   # same for A and B
    return 128 * c + 2 * word + lo


def cluster_partner(q, c, ks, kk, operand):
    """The redesign: cluster rank q copies partners 128 c + 32 q + 16 h ..
    + 15 (h = 0, 1) into bytes 16 h .. of a raw row; the conversion keeps
    the order (mask: word w of 4 bytes -> bf16 2w, 2w + 1; panel: pair pp
    -> bf16 2pp, 2pp + 1 of a column row); ldmatrix reads bf16 16 ks + 8
    (matrix / 2 for A, matrix % 2 for B) + 2 tq (+ 1) as k position kk."""
    # the int8 byte of a mask row and the bf16 of a panel column row alike
    offset = 16 * ks + 8 * (kk >= 8) + 2 * ((kk % 8) // 2) + kk % 2
    return 128 * c + 32 * q + offset


def emulated_mma(acc, a, b):
    """One m16n8k16 step, for every (row, column) at once: the 16
    products added to the float32 accumulator in k order.  Any fixed
    function serves: both designs call this one."""
    for kk in range(16):
        acc = (acc + a[:, kk, None] * b[None, kk, :]).astype(np.float32)
    return acc


def k5_model(M, Z, partner_of):
    """out[i, k] for one time step: four quarter accumulators, each fed
    the steps (c, ks) in order with the partners ``partner_of`` names,
    zero past n, then ((q0 + q1) + q2) + q3."""
    rows, n = M.shape[0], Z.shape[0]
    Mf = M.astype(np.float32)
    Zb = _bf16(Z)
    n_chunks = -(-n // 128)
    accs = []
    for q in range(4):
        acc = np.zeros((rows, Z.shape[1]), np.float32)
        for c in range(n_chunks):
            for ks in range(2):
                pa = [partner_of(q, c, ks, kk, "A") for kk in range(16)]
                pb = [partner_of(q, c, ks, kk, "B") for kk in range(16)]
                assert pa == pb
                a = np.stack([Mf[:, p] if p < n else np.zeros(rows,
                                                              np.float32)
                              for p in pa], 1)
                b = np.stack([Zb[p] if p < n else np.zeros(Z.shape[1],
                                                           np.float32)
                              for p in pb], 0)
                acc = emulated_mma(acc, a, b)
        accs.append(acc)
    return ((accs[0] + accs[1]) + accs[2]) + accs[3]


@pytest.mark.parametrize("n,rows,K", [(20, 5, 5), (37, 9, 3),
                                      (2000, 125, 57), (1936, 64, 11)])
def test_k5_partitions_are_bitwise_equal(n, rows, K):
    rng = np.random.default_rng(n + K)
    M = (rng.random((rows, n)) < 0.7).astype(np.int8)
    Z = rng.normal(size=(n, K)).astype(np.float32)
    parent = k5_model(M, Z, parent_partner)
    new = k5_model(M, Z, cluster_partner)
    assert np.array_equal(parent.view(np.uint32), new.view(np.uint32))
    # and both are the twin's function
    Mp = torch.zeros(1, rows, -(-n // 16) * 16, dtype=torch.int8)
    Mp[0, :, :n] = torch.from_numpy(M)
    twin = tmc.packed_rows_contract_twin(Mp, torch.from_numpy(Z)[:, None])
    np.testing.assert_allclose(new, twin[:, 0].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("partner_of", [parent_partner, cluster_partner])
def test_k5_quarter_chains_cover_each_partner_once(partner_of):
    seen = sorted(partner_of(q, c, ks, kk, "A") for q in range(4)
                  for c in range(3) for ks in range(2) for kk in range(16))
    assert seen == list(range(3 * 128))
    # within a quarter, the steps walk its partners in increasing order
    for q in range(4):
        chain = [partner_of(q, c, ks, kk, "A") for c in range(3)
                 for ks in range(2) for kk in range(16)]
        assert chain == sorted(chain)
        assert all(32 * q <= p % 128 < 32 * q + 32 for p in chain)


# ------------------------------------------------------------ layout rules


def test_k6_shared_memory_fits_at_every_admitted_n():
    """Every n the wrapper admits fits a block's 227 KB; the first it
    refuses does not; n = 2000 runs two blocks per SM at width 8 and 16."""
    for width in (8, 16):
        sizes = [tdc.smem_bytes(n, width) for n in range(1, 20001)]
        assert sizes == sorted(sizes)
        admitted = [n for n, s in zip(range(1, 20001), sizes)
                    if s <= tdc.MAX_SMEM_BYTES]
        n_max = admitted[-1]
        assert admitted == list(range(1, n_max + 1))
        m = width if width == 16 else 8
        tdc._check_launch(3, n_max, m)
        with pytest.raises(ValueError, match="shared memory"):
            tdc._check_launch(3, n_max + 1, m)
        assert 2 * (tdc.smem_bytes(2000, width) + 1024) <= 233472
    assert tdc.smem_bytes(2000, 8) == 81920
    assert tdc.smem_bytes(2000, 16) == 106496
    # m = 40 is three launches, each within the budget where the widest is
    assert max(tdc.launch_layout(50, 2000, 40)["smem_bytes"]) == 106496


@pytest.mark.parametrize("T,n,m", [(50, 2000, 8), (3, 37, 13), (1, 1, 1),
                                   (2, 10752, 40)])
def test_k6_launch_layout(T, n, m):
    lay = tdc.launch_layout(T, n, m)
    assert lay["grid"] == (tdc.CLUSTER, T) and lay["cluster"] == 8
    assert len(lay["slices"]) == -(-m // tdc.SLICE)
    assert all(s <= tdc.MAX_SMEM_BYTES for s in lay["smem_bytes"])
    with pytest.raises(ValueError, match="T <= 65535"):
        tdc._check_launch(65536, n, m)


@pytest.mark.parametrize("T,bs,K,grid", [(50, 125, 57, (4, 1, 50)),
                                         (50, 2000, 57, (4, 16, 50)),
                                         (3, 5, 5, (4, 1, 3)),
                                         (7, 300, 130, (4, 3, 21))])
def test_k5_launch_layout(T, bs, K, grid):
    lay = tmc.launch_layout(T, bs, K)
    assert lay["grid"] == grid and lay["cluster"] == tmc.QUARTERS == 4
    smem = lay["smem_bytes"]
    assert smem == 75264 <= tmc.MAX_SMEM_BYTES
    assert 3 * (smem + 1024) <= 233472            # three blocks per SM
    # the quarter sums (8 warps x 32 accumulators x 32 lanes) reuse the ring
    raw = tmc.STAGES * (tmc.ROW_TILE * tmc.MASK_PITCH
                        + 32 * tmc.PANEL_PITCH * 4)
    assert 8 * 32 * 32 * 4 <= raw


def test_k5_refuses_a_grid_it_cannot_launch():
    Mp = torch.zeros(65536, 1, 16, dtype=torch.int8)
    Z = torch.zeros(3, 65536, 1)
    with pytest.raises(ValueError, match="65535"):
        tmc.packed_rows_contract_kernel(Mp, Z)
