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
// by bytes, so the design keeps many of them in flight.
//
// The arithmetic is fixed, so that the masked fits, which stop where a
// relative ELBO gain first stays under their tolerance, see the same bits
// from every design: each output has four float32 accumulators, one per
// partner quarter q, and accumulator q takes, for every 128-partner chunk c
// in order, the mma.sync m16n8k16 steps over partners 128c + 32q + 16ks ..
// + 15 (ks = 0, 1), partner 128c + 32q + 16ks + kk at k position kk, rows
// and columns at their positions mod 16 and mod 8; the result is
// ((acc0 + acc1) + acc2) + acc3.  The schedule around it:
//
//   * a cluster of 4 blocks per (128-row tile, t, 64-column tile), block
//     rank q running quarter q of every chunk: 32 partners x 128 rows of
//     mask and 32 partners x 64 columns of panel per step, so a stripe at
//     bs=125 has 200 blocks and reads its panel once per time step;
//   * a ring of kStages raw steps filled by cp.async (16-byte copies of
//     the mask rows, 4-byte copies of the panel, whose rows of K floats are
//     not 16-byte aligned), kStages - 1 in flight while one is converted
//     once to bf16 (int8 exactly, by a float magic number; the panel
//     rounded to nearest) into one of two fragment tiles, and the other is
//     multiplied: one block barrier per step;
//   * fragment tiles read by ldmatrix: the mask rows and the panel columns
//     (transposed as they are converted) each 64 bytes of partners in an
//     80-byte row, so ldmatrix, the conversion's loads and its stores are
//     free of bank conflicts;
//   * the quarters' accumulators summed in rank order through distributed
//     shared memory, each rank writing a quarter of the tile.
//
// Ragged rows, columns and partners are masked in the kernel.
#include "contract_tiles.cuh"
#include "kernels.h"

namespace {

constexpr int kRows = 128;     // mask rows per block
constexpr int kCols = 64;      // panel columns per block
constexpr int kChunk = 128;    // partners per chunk, a quarter per rank
constexpr int kQuarters = 4;   // blocks per cluster
constexpr int kPart = kChunk / kQuarters;  // partners per block and step
constexpr int kStages = 3;     // raw steps in the ring
constexpr int kThreads = 256;  // 8 warps: 4 row quarters x 2 column halves
constexpr int kMT = kRows / 64;    // m16 tiles per warp
constexpr int kMaskPitch = 48;     // bytes per raw mask row
constexpr int kPanelPitch = 68;    // floats per raw panel row
constexpr int kMaskBytes = kRows * kMaskPitch;
constexpr int kRawBytes = kMaskBytes + kPart * kPanelPitch * 4;
constexpr int kFragPitch = 80;     // bytes per fragment-tile row
constexpr int kFragBytes = (kRows + kCols) * kFragPitch;
constexpr int kRegs = 16 * kMT;    // accumulators per lane

static_assert(8 * kRegs * 32 * 4 <= kStages * kRawBytes,
              "the quarter sums must fit in the ring");

size_t smem_bytes() { return kStages * kRawBytes + 2 * kFragBytes; }

// Four int8 values, exactly, as two bf16x2 words (bytes 0, 1 and 2, 3):
// 2^23 + (b + 128) is a float whose low byte is b ^ 0x80, and the integer
// is exact in bf16, so its upper half is its bf16.
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  const uint32_t y = w ^ 0x80808080u;
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __float_as_uint(
        __uint_as_float(__byte_perm(y, 0x4B000000u, 0x7440u | i)) -
        8388736.f);
  return make_uint2(__byte_perm(h[0], h[1], 0x7632),
                    __byte_perm(h[2], h[3], 0x7632));
}

__global__ void __cluster_dims__(kQuarters, 1, 1)
__launch_bounds__(kThreads, 3)
masked_contract_kernel(const int8_t* __restrict__ M,
                       const float* __restrict__ Z, float* __restrict__ out,
                       int T, int bs_pad, int n_pad, int n, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* frag = smem + kStages * kRawBytes;  // [2][rows + cols][80 B]
  const unsigned q = contract::cluster_rank();
  const int row0 = blockIdx.y * kRows;
  const int t = blockIdx.z % T, col0 = (blockIdx.z / T) * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // warp tile: rows 32 rq .. + 31, columns 32 chalf .. + 31
  const int rq = warp & 3, chalf = warp >> 2;
  const int n_chunks = (n + kChunk - 1) / kChunk;

  // this thread's copies: mask row tid / 2, half tid % 2; panel
  // column col0 + tid % 64 of partners tid / 64 + 4 i
  const int m_row = row0 + (tid >> 1);
  const int8_t* m_src =
      M + (static_cast<size_t>(t) * bs_pad + m_row) * n_pad + 16 * (tid & 1);
  const int z_col = col0 + (tid & 63);
  const size_t z_step = static_cast<size_t>(T) * K;  // one partner
  const float* z_src = Z + static_cast<size_t>(tid >> 6) * z_step +
                       static_cast<size_t>(t) * K + z_col;

  auto issue = [&](int c) {  // this rank's quarter of chunk c
    unsigned char* st = smem + (c % kStages) * kRawBytes;
    const int p0 = c * kChunk + static_cast<int>(q) * kPart;
    {
      const bool ok = m_row < bs_pad && p0 + 16 * (tid & 1) < n_pad;
      contract::cp_async_16(st + (tid >> 1) * kMaskPitch + 16 * (tid & 1),
                            ok ? m_src + p0 : M, ok);
    }
    float* zs = reinterpret_cast<float*>(st + kMaskBytes);
#pragma unroll
    for (int i = 0; i < kPart * kCols / kThreads; ++i) {
      const int p = (tid >> 6) + 4 * i;
      const bool ok = p0 + p < n && z_col < K;
      contract::cp_async_4(zs + p * kPanelPitch + (tid & 63),
                           ok ? z_src + (p0 + 4 * i) * z_step : Z, ok);
    }
  };
  auto convert = [&](int c) {  // raw step c -> fragment tile c % 2
    const unsigned char* st = smem + (c % kStages) * kRawBytes;
    unsigned char* fr = frag + (c & 1) * kFragBytes;
#pragma unroll
    for (int i = 0; i < kRows * 8 / kThreads; ++i) {  // mask: 8 words a row
      const int e = tid + i * kThreads, r = e >> 3, w = e & 7;
      *reinterpret_cast<uint2*>(fr + r * kFragPitch + 8 * w) =
          int8x4_to_bf16(
              *reinterpret_cast<const uint32_t*>(st + r * kMaskPitch + 4 * w));
    }
    // panel, transposed: word (column, partner pair); lanes take 8 columns
    // x 4 pairs, warps and steps the 8 x 4 such blocks
    const float* zs = reinterpret_cast<const float*>(st + kMaskBytes);
    uint32_t* fz = reinterpret_cast<uint32_t*>(fr + kRows * kFragPitch);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int blk = 4 * warp + i;
      const int col = 8 * (blk >> 2) + (lane & 7);
      const int pp = 4 * (blk & 3) + (lane >> 3);
      fz[col * (kFragPitch / 4) + pp] =
          contract::pack_bf16(zs[2 * pp * kPanelPitch + col],
                              zs[(2 * pp + 1) * kPanelPitch + col]);
    }
  };

  float acc[kMT][4][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages; ++c) {
    if (c < n_chunks) issue(c);
    contract::cp_async_commit();
  }
  contract::cp_async_wait<kStages - 1>();
  __syncthreads();
  if (n_chunks > 0) convert(0);
  for (int c = 0; c < n_chunks; ++c) {
    contract::cp_async_wait<kStages - 2>();
    // raw step c + 1 landed for all; fragment tile c % 2 is written; tile
    // (c + 1) % 2 and raw slot c % kStages are consumed
    __syncthreads();
    if (c + kStages < n_chunks) issue(c + kStages);
    contract::cp_async_commit();
    if (c + 1 < n_chunks) convert(c + 1);
    const unsigned char* fr = frag + (c & 1) * kFragBytes;
    const unsigned char* fb = fr + kRows * kFragPitch;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // A: rows 32 rq + 16 mi .. + 15, partners 16 ks .. + 15
      uint32_t a[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        contract::ldmatrix_x4(
            a[mi], fr + (32 * rq + 16 * mi + (lane & 15)) * kFragPitch +
                       32 * ks + 16 * (lane >> 4));
      // B: columns 32 chalf + 16 np .. + 15, partners 16 ks .. + 15
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        const int qd = lane >> 3;
        contract::ldmatrix_x4(
            b, fb + (32 * chalf + 16 * np + 8 * (qd >> 1) + (lane & 7)) *
                        kFragPitch +
                   32 * ks + 16 * (qd & 1));
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          contract::mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          contract::mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  // the quarters' sums, in rank order, through distributed shared memory
  contract::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [warp][mi][nt][reg][lane]
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[(((warp * kMT + mi) * 4 + nt) * 4 + r) * 32 + lane] =
            acc[mi][nt][r];
  contract::cluster_sync();
  {
    // rank q sums warps 2q and 2q + 1; a thread one lane's (mi, nt) tiles
    const int w = 2 * static_cast<int>(q) + (tid >> 7);
    const int sub = (tid >> 5) & 3;
#pragma unroll
    for (int u = 0; u < kMT; ++u) {
      const int tile = sub * kMT + u, mi = tile >> 2, nt = tile & 3;
      const int row_base = row0 + 32 * (w & 3) + 16 * mi + g;
      const int k_base = col0 + 32 * (w >> 2) + 8 * nt + 2 * tq;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* p =
            red + (((w * kMT + mi) * 4 + nt) * 4 + r) * 32 + lane;
        float s = *contract::at_rank(p, 0);
#pragma unroll
        for (unsigned src = 1; src < kQuarters; ++src)
          s += *contract::at_rank(p, src);
        const int row = row_base + (r >= 2 ? 8 : 0), k = k_base + (r & 1);
        if (row < bs_pad && k < K)
          out[(static_cast<size_t>(row) * T + t) * K + k] = s;
      }
    }
  }
  contract::cluster_sync();  // the others have read this block's sums
}

}  // namespace

cudaError_t tame_masked_contract(const int8_t* M, const float* Z, float* out,
                                 int T, int bs_pad, int n_pad, int n, int K,
                                 cudaStream_t stream) {
  if (T == 0 || bs_pad == 0 || K == 0) return cudaSuccess;
  if (n_pad % 16 != 0 || n > n_pad) return cudaErrorInvalidValue;
  const int col_tiles = (K + kCols - 1) / kCols;
  if (static_cast<long long>(T) * col_tiles > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(kQuarters, (bs_pad + kRows - 1) / kRows, T * col_tiles);
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      masked_contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  masked_contract_kernel<<<grid, kThreads, smem, stream>>>(M, Z, out, T,
                                                           bs_pad, n_pad, n, K);
  return cudaGetLastError();
}
