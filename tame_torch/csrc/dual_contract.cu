// K6 dual_contract: one pass over bf16 (T, n, n) data for both W @ Z and
// W' @ Z.
//
// Replaces tame/ops/dual_contract.py::_dual_kernel (via
// dual_contract_padded).  The TPU kernel walks the row tiles of each time
// step in order and carries the column sums in its output block from one
// grid step to the next.  Hopper blocks run in no order, so here one block
// per (t, 128-row tile) computes
//
//     row[t, i, :]  = sum_j W[t, i, j] bf16(Z[t, j, :])       (its rows)
//     col[t, j, :] += sum_i W[t, i, j] bf16(Z[t, i, :])       (i in its rows)
//
// over the columns in chunks of 64, and adds its column partials into the
// zeroed float32 output with atomicAdd: n / 128 partial sums per entry, in
// an order that changes from run to run (the wrapper states the tolerance).
//
// Bound: at T=50, n=2000, m=8 the data is 400 MB of bf16 read once, a
// ~122 us memory bound at 3.35 TB/s; the 6.4 GFLOP of float32 FMAs need
// ~96 us at the card's 67 TFLOP/s, and the 12.8 M atomics go to L2.  The
// design reads W once with 16-byte loads (the layout of pad_data pads the
// columns to a multiple of 8), converts each tile to float in shared memory
// and keeps one row's or one column's m sums in registers per thread, so
// each FMA costs a broadcast float4 read of Z.  m is rounded up to 4, 8 or
// 16 at compile time.
#include <cuda_bf16.h>

#include "kernels.h"

namespace {

constexpr int kRowTile = 128;
constexpr int kChunk = 64;
constexpr int kThreads = 256;
constexpr int kWPitch = kChunk + 1;  // odd pitch: row-wise reads conflict-free

template <int MP>
struct DualSmem {
  float W[kRowTile * kWPitch];           // data tile, float
  float Zc[kChunk * MP];                 // Z rows of the chunk's columns
  float Zr[kRowTile * MP];               // Z rows of the tile's rows
  float red[4 * kChunk * MP];            // column partials of 4 row quarters
};

template <int MP>
__global__ void __launch_bounds__(kThreads)
dual_contract_kernel(const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ Z, float* __restrict__ row,
                     float* __restrict__ col, int n, int cols_pad, int m) {
  extern __shared__ __align__(16) float smem_raw[];
  DualSmem<MP>& s = *reinterpret_cast<DualSmem<MP>*>(smem_raw);
  const int t = blockIdx.x;
  const int row0 = blockIdx.y * kRowTile;
  const int tid = threadIdx.x;
  const __nv_bfloat16* Wt = W + static_cast<size_t>(t) * n * cols_pad;
  const float* Zt = Z + static_cast<size_t>(t) * n * m;

  for (int e = tid; e < kRowTile * MP; e += kThreads) {
    const int r = e / MP, k = e % MP, i = row0 + r;
    s.Zr[e] = (i < n && k < m)
                  ? __bfloat162float(__float2bfloat16_rn(
                        Zt[static_cast<size_t>(i) * m + k]))
                  : 0.f;
  }

  // Row product: thread owns row (tid % 128) over half (tid / 128) of each
  // chunk.  Column product: thread owns column (tid % 64) of the chunk over
  // a quarter (tid / 64) of the tile's rows.
  const int my_row = tid % kRowTile, jhalf = tid / kRowTile;
  const int my_col = tid % kChunk, rquart = tid / kChunk;
  float racc[MP];
#pragma unroll
  for (int k = 0; k < MP; ++k) racc[k] = 0.f;

  for (int j0 = 0; j0 < n; j0 += kChunk) {
    // data tile: 128 rows x 64 columns of bf16, 16-byte loads
    for (int v = tid; v < kRowTile * (kChunk / 8); v += kThreads) {
      const int r = v / (kChunk / 8), jj = (v % (kChunk / 8)) * 8;
      const int i = row0 + r, j = j0 + jj;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (i < n && j < cols_pad)  // cols_pad % 8 == 0: all 8 or none
        raw = *reinterpret_cast<const uint4*>(
            Wt + static_cast<size_t>(i) * cols_pad + j);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        s.W[r * kWPitch + jj + q] = __bfloat162float(h[q]);
    }
    for (int e = tid; e < kChunk * MP; e += kThreads) {
      const int jj = e / MP, k = e % MP, j = j0 + jj;
      s.Zc[e] = (j < n && k < m)
                    ? __bfloat162float(__float2bfloat16_rn(
                          Zt[static_cast<size_t>(j) * m + k]))
                    : 0.f;
    }
    __syncthreads();

    const float* wrow = &s.W[my_row * kWPitch];
#pragma unroll 4
    for (int jj = jhalf * (kChunk / 2); jj < (jhalf + 1) * (kChunk / 2);
         ++jj) {
      const float a = wrow[jj];
#pragma unroll
      for (int k = 0; k < MP; k += 4) {
        const float4 z = *reinterpret_cast<const float4*>(&s.Zc[jj * MP + k]);
        racc[k] = fmaf(a, z.x, racc[k]);
        racc[k + 1] = fmaf(a, z.y, racc[k + 1]);
        racc[k + 2] = fmaf(a, z.z, racc[k + 2]);
        racc[k + 3] = fmaf(a, z.w, racc[k + 3]);
      }
    }

    float cacc[MP];
#pragma unroll
    for (int k = 0; k < MP; ++k) cacc[k] = 0.f;
#pragma unroll 4
    for (int r = rquart * (kRowTile / 4); r < (rquart + 1) * (kRowTile / 4);
         ++r) {
      const float a = s.W[r * kWPitch + my_col];
#pragma unroll
      for (int k = 0; k < MP; k += 4) {
        const float4 z = *reinterpret_cast<const float4*>(&s.Zr[r * MP + k]);
        cacc[k] = fmaf(a, z.x, cacc[k]);
        cacc[k + 1] = fmaf(a, z.y, cacc[k + 1]);
        cacc[k + 2] = fmaf(a, z.z, cacc[k + 2]);
        cacc[k + 3] = fmaf(a, z.w, cacc[k + 3]);
      }
    }
#pragma unroll
    for (int k = 0; k < MP; k += 4)
      *reinterpret_cast<float4*>(&s.red[(rquart * kChunk + my_col) * MP + k]) =
          make_float4(cacc[k], cacc[k + 1], cacc[k + 2], cacc[k + 3]);
    __syncthreads();
    for (int e = tid; e < kChunk * MP; e += kThreads) {
      const int jj = e / MP, k = e % MP, j = j0 + jj;
      if (j < n && k < m) {
        const float sum = s.red[e] + s.red[kChunk * MP + e] +
                          s.red[2 * kChunk * MP + e] +
                          s.red[3 * kChunk * MP + e];
        atomicAdd(&col[(static_cast<size_t>(t) * n + j) * m + k], sum);
      }
    }
    __syncthreads();
  }

  // combine the two halves of each row: the upper half parks its sums in
  // the (now free) column-partial buffer
  if (jhalf == 1)
#pragma unroll
    for (int k = 0; k < MP; ++k) s.red[my_row * MP + k] = racc[k];
  __syncthreads();
  const int i = row0 + my_row;
  if (jhalf == 0 && i < n)
#pragma unroll
    for (int k = 0; k < MP; ++k)
      if (k < m)
        row[(static_cast<size_t>(t) * n + i) * m + k] =
            racc[k] + s.red[my_row * MP + k];
}

template <int MP>
cudaError_t launch(const __nv_bfloat16* W, const float* Z, float* row,
                   float* col, int T, int n, int cols_pad, int m,
                   cudaStream_t stream) {
  const size_t smem = sizeof(DualSmem<MP>);
  cudaError_t err = cudaFuncSetAttribute(
      dual_contract_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(T, (n + kRowTile - 1) / kRowTile);
  dual_contract_kernel<MP><<<grid, kThreads, smem, stream>>>(W, Z, row, col,
                                                            n, cols_pad, m);
  return cudaGetLastError();
}

}  // namespace

cudaError_t tame_dual_contract(const void* W, const float* Z, float* row,
                               float* col, int T, int n, int cols_pad, int m,
                               cudaStream_t stream) {
  if (T == 0 || n == 0 || m == 0) return cudaSuccess;
  if (cols_pad % 8 != 0 || cols_pad < n) return cudaErrorInvalidValue;
  const auto* Wb = static_cast<const __nv_bfloat16*>(W);
  if (m <= 4) return launch<4>(Wb, Z, row, col, T, n, cols_pad, m, stream);
  if (m <= 8) return launch<8>(Wb, Z, row, col, T, n, cols_pad, m, stream);
  if (m <= 16) return launch<16>(Wb, Z, row, col, T, n, cols_pad, m, stream);
  return cudaErrorInvalidValue;
}
