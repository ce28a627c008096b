// K5 masked_contract: one int8 mask row stripe @ a feature panel.
//
// Replaces tame/ops/masked_contract.py::_kernel (via packed_rows_contract),
// which pads the panel to a (T, n_pad, 128-lane) bf16 copy on every call and
// runs one MXU dot per (t, 256-row tile).  Here
//
//     out[i, t, k] = sum_j M[t, i, j] * bf16(Z[j, t, k])
//
// with M the (T, bs_pad, n_pad) int8 stripe of pack_mask, Z the caller's
// (n, T, K) float32 panel read in place (rounded to bf16 as it is staged, no
// padded copy) and out (bs_pad, T, K) float32, written in the layout the
// callers slice, so nothing is transposed afterwards.
//
// Bound: at one n=2000 block phase (bs=125, T=50, K=57) the kernel must move
// 12.5 MB of mask, 22.8 MB of panel and 1.4 MB of output (~11 us at
// 3.35 TB/s) for 1.4 GFLOP (~1.4 us on the bf16 tensor cores): it is bound
// by bytes.  The products run on the tensor cores (mma.sync m16n8k16, bf16
// in, float32 sums; int8 -> bf16 is exact), so the kernel's cost is moving
// bytes, and the design keeps many of them in flight: one block of 8 warps
// per (t, 32 mask rows, 64 panel columns); a loop over partners in chunks of
// 128 whose next chunk (16 B of mask and 32 panel values per thread) is
// loaded into registers while the current one is multiplied from shared
// memory; within a chunk warp w takes rows 16 (w % 2) .. + 15 and partners
// 32 (w / 2) .. + 31, and the four partner quarters are summed through
// shared memory at the end.  Shared rows are padded to 68 words, so the
// fragment reads are free of bank conflicts.  The panel is re-read by every
// row tile of a time step from L2 (22.8 MB at n=2000).  Ragged rows, columns
// and partners are masked in the kernel.
#include <cuda_bf16.h>

#include "kernels.h"

namespace {

constexpr int kRows = 32;             // mask rows per block
constexpr int kCols = 64;             // panel columns per block
constexpr int kChunk = 128;           // partners staged per round
constexpr int kThreads = 256;         // 8 warps: row half x partner quarter
constexpr int kPitch = kChunk / 2 + 4;  // 32-bit words per staged row
constexpr int kPanelLoads = kChunk / 2 * kCols / kThreads;  // pairs/thread

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
masked_contract_kernel(const int8_t* __restrict__ M,
                       const float* __restrict__ Z, float* __restrict__ out,
                       int T, int bs_pad, int n_pad, int n, int K) {
  // Ms: mask rows [kRows][kPitch] and Zs: panel columns [kCols][kPitch],
  // each word a (partner 2p, 2p + 1) pair of bf16; reused for the final
  // partner-quarter sums.
  __shared__ __align__(16) uint32_t smem[(kRows + kCols) * kPitch];
  uint32_t* Ms = smem;
  uint32_t* Zs = smem + kRows * kPitch;
  const int t = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.z * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int half = warp & 1, quarter = warp >> 1;
  const int8_t* Mt = M + static_cast<size_t>(t) * bs_pad * n_pad;

  // this thread's share of a chunk: 16 partners of one mask row, and
  // kPanelLoads (partner pair, column) panel entries
  const int m_row = tid >> 3, m_j = (tid & 7) * 16;
  const int p_col = tid % kCols, p_pair0 = tid / kCols;
  int4 m_reg;
  float z_reg[kPanelLoads][2];
  auto load_chunk = [&](int j0) {
    m_reg = make_int4(0, 0, 0, 0);
    const int row = row0 + m_row, j = j0 + m_j;
    if (row < bs_pad && j < n_pad)  // n_pad % 16 == 0: all 16 or none
      m_reg = *reinterpret_cast<const int4*>(
          Mt + static_cast<size_t>(row) * n_pad + j);
    const int k = col0 + p_col;
#pragma unroll
    for (int i = 0; i < kPanelLoads; ++i) {
      const int jp = j0 + 2 * (p_pair0 + i * (kThreads / kCols));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        z_reg[i][h] = (jp + h < n && k < K)
                          ? Z[(static_cast<size_t>(jp + h) * T + t) * K + k]
                          : 0.f;
    }
  };
  auto store_chunk = [&]() {
    const int8_t* b = reinterpret_cast<const int8_t*>(&m_reg);
    uint32_t w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      w[q] = pack_bf16(static_cast<float>(b[2 * q]),
                       static_cast<float>(b[2 * q + 1]));
    uint4* dst = reinterpret_cast<uint4*>(&Ms[m_row * kPitch + m_j / 2]);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
#pragma unroll
    for (int i = 0; i < kPanelLoads; ++i)
      Zs[p_col * kPitch + p_pair0 + i * (kThreads / kCols)] =
          pack_bf16(z_reg[i][0], z_reg[i][1]);
  };

  float acc[kCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  load_chunk(0);
  for (int j0 = 0; j0 < n; j0 += kChunk) {
    __syncthreads();  // the previous chunk's fragments are read
    store_chunk();
    __syncthreads();
    if (j0 + kChunk < n) load_chunk(j0 + kChunk);  // in flight meanwhile
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kw = quarter * 16 + ks * 8;  // word of partner 2 tq
      const uint32_t* ar = &Ms[(16 * half + g) * kPitch + kw + tq];
      const uint32_t a[4] = {ar[0], ar[8 * kPitch], ar[4],
                             ar[8 * kPitch + 4]};
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const uint32_t* br = &Zs[(8 * nt + g) * kPitch + kw + tq];
        mma_bf16(acc[nt], a, br[0], br[4]);
      }
    }
  }

  // sum the four partner quarters of each row half
  float* red = reinterpret_cast<float*>(smem);  // [3][2][32 values][32 lanes]
  __syncthreads();
  if (quarter > 0) {
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[(((quarter - 1) * 2 + half) * 32 + nt * 4 + q) * 32 + lane] =
            acc[nt][q];
  }
  __syncthreads();
  if (quarter > 0) return;
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = acc[nt][q];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        s += red[((p * 2 + half) * 32 + nt * 4 + q) * 32 + lane];
      const int row = row0 + 16 * half + g + (q >= 2 ? 8 : 0);
      const int k = col0 + 8 * nt + 2 * tq + (q & 1);
      if (row < bs_pad && k < K)
        out[(static_cast<size_t>(row) * T + t) * K + k] = s;
    }
  }
}

static_assert(3 * 2 * 32 * 32 <= (kRows + kCols) * kPitch,
              "the quarter sums must fit in the staging buffer");

}  // namespace

cudaError_t tame_masked_contract(const int8_t* M, const float* Z, float* out,
                                 int T, int bs_pad, int n_pad, int n, int K,
                                 cudaStream_t stream) {
  if (T == 0 || bs_pad == 0 || K == 0) return cudaSuccess;
  if (n_pad % 16 != 0 || n > n_pad) return cudaErrorInvalidValue;
  const dim3 grid(T, (bs_pad + kRows - 1) / kRows, (K + kCols - 1) / kCols);
  masked_contract_kernel<<<grid, kThreads, 0, stream>>>(M, Z, out, T, bs_pad,
                                                        n_pad, n, K);
  return cudaGetLastError();
}
