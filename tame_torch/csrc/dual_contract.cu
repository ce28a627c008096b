// K6 dual_contract: one pass over bf16 (T, n, n) data for both W @ Z and
// W' @ Z.
//
// Replaces tame/ops/dual_contract.py::_dual_kernel (via
// dual_contract_padded).  The TPU kernel walks the row tiles of each time
// step in order and carries the column sums in its output block from one
// grid step to the next.  Hopper blocks run in no order, so here a cluster
// of kCluster = 8 blocks shares one time step t, and block rank c owns a
// stripe of its 64-row tiles:
//
//     row[t, i, :] = sum_j W[t, i, j] bf16(Z[t, j, :])    (i in its rows)
//     col[t, j, :] = sum_c sum_{i in stripe c} W[t, i, j] bf16(Z[t, i, :])
//
// The columns are walked in chunks of 128.  For each chunk a block streams
// its row tiles (64 x 128 bf16, 16 KB) through a ring of kStages cp.async
// stages, and both products run on the tensor cores (mma.sync m16n8k16,
// bf16 in, float32 sums) from the same staged tile: the row product with
// the tile as A (ldmatrix), the column product with its transpose as A
// (ldmatrix.trans).  Z is rounded to bf16 once as it is staged.  The row
// sums live in shared memory across the chunks; a chunk's column partials
// stay in registers over the stripe, go to a double-buffered shared slot,
// and after a cluster barrier rank c sums columns 16c .. 16c + 15 of the
// chunk over the 8 ranks' slots in rank order through distributed shared
// memory.  No atomics: every output entry is written once, and a launch
// gives the same bits every time.  Split arrive / wait barriers let ranks
// drift by one chunk.
//
// Bound: at T=50, n=2000, m=8 the data is 400 MB of bf16 read once, a
// ~122 us memory bound at 3.35 TB/s; the 6.4 GFLOP run on the tensor cores
// (~6.5 us at 989 TFLOP/s).  Tiles are stored with their 16-byte units
// swizzled by the row (unit u of row r at u ^ (r % 8)), so ldmatrix and
// ldmatrix.trans read them without bank conflicts.  A launch takes up to
// 16 columns of Z (compile-time width 8 or 16); the binding's caller slices
// wider panels.
#include "contract_tiles.cuh"
#include "kernels.h"

namespace {

constexpr int kCluster = 8;   // blocks per time step
constexpr int kRows = 64;     // rows per tile
constexpr int kChunk = 128;   // columns per tile
constexpr int kStages = 3;    // ring depth
constexpr int kThreads = 256;
constexpr int kTileBytes = kRows * kChunk * 2;
constexpr int kSlice = kChunk / kCluster;  // columns each rank sums

static_assert(kThreads / 32 == 8, "warp roles assume 8 warps");

// bf16 elements per staged Z row: 48-byte rows keep ldmatrix.trans free of
// bank conflicts at width 16; 16-byte rows are free at width 8.
__host__ __device__ constexpr int z_pitch(int mp) { return mp == 16 ? 24 : 8; }

// Byte offset of 16-byte unit u of row r in a staged tile (swizzled).
__device__ __forceinline__ int swizzled(int r, int u) {
  return r * (kChunk * 2) + ((u ^ (r & 7)) * 16);
}

// Row tiles a rank owns.
int tiles_per_rank(int n) {
  return ((n + kRows - 1) / kRows + kCluster - 1) / kCluster;
}

size_t smem_bytes(int n, int mp) {
  const size_t rows = static_cast<size_t>(tiles_per_rank(n)) * kRows;
  const size_t zp = z_pitch(mp);
  return kStages * static_cast<size_t>(kTileBytes)  // W ring
         + 2 * kChunk * zp * 2                      // Z of two chunks
         + rows * zp * 2                            // Z of the stripe
         + 2 * kChunk * mp * 4                      // column partials
         + rows * 16 * 4;                           // row sums
}

template <int MP>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
dual_contract_kernel(const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ Z, float* __restrict__ row,
                     float* __restrict__ col, int n, int cols_pad, int ldz,
                     int k0, int width, int rt_per_rank) {
  constexpr int NT = MP / 8;          // n8 tiles of the panel
  constexpr int RP = 2 / NT;          // row-sum parts (k halves at MP = 8)
  constexpr int ZP = z_pitch(MP);
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = rt_per_rank * kRows;
  unsigned char* ring = smem;
  __nv_bfloat16* Zc = reinterpret_cast<__nv_bfloat16*>(
      ring + kStages * kTileBytes);                     // [2][kChunk][ZP]
  __nv_bfloat16* Zr = Zc + 2 * kChunk * ZP;             // [rows][ZP]
  float* colp = reinterpret_cast<float*>(Zr + rows * ZP);  // [2][kChunk][MP]
  float* racc = colp + 2 * kChunk * MP;                 // [RP][rows][MP]

  const int t = blockIdx.y;
  const unsigned rank = contract::cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = static_cast<int>(rank) * rows;  // first row of the stripe
  const int n_tiles = min(rt_per_rank, max(0, (n - row0 + kRows - 1) / kRows));
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const __nv_bfloat16* Wt = W + static_cast<size_t>(t) * n * cols_pad;
  const float* Zt = Z + static_cast<size_t>(t) * n * ldz + k0;

  auto z_at = [&](int i, int k) {  // bf16-rounded Z[t, i, k0 + k], 0 outside
    return __float2bfloat16_rn(
        (i < n && k < width) ? Zt[static_cast<size_t>(i) * ldz + k] : 0.f);
  };
  auto stage_zc = [&](int chunk) {
    __nv_bfloat16* dst = Zc + (chunk & 1) * kChunk * ZP;
    for (int e = tid; e < kChunk * MP; e += kThreads)
      dst[(e / MP) * ZP + e % MP] = z_at(chunk * kChunk + e / MP, e % MP);
  };
  auto issue_tile = [&](int s) {  // tile s = (chunk s / n_tiles, s % n_tiles)
    unsigned char* dst = ring + (s % kStages) * kTileBytes;
    const int j0 = (s / n_tiles) * kChunk;
    const int i0 = row0 + (s % n_tiles) * kRows;
#pragma unroll
    for (int v = tid; v < kRows * (kChunk / 8); v += kThreads) {
      const int r = v / (kChunk / 8), u = v % (kChunk / 8);
      const int i = i0 + r, j = j0 + 8 * u;
      const bool ok = i < n && j < cols_pad;  // cols_pad % 8 == 0
      contract::cp_async_16(
          dst + swizzled(r, u),
          ok ? Wt + static_cast<size_t>(i) * cols_pad + j : Wt, ok);
    }
  };

  // columns 16 rank .. + 15 of a chunk: the ranks' partials in rank order
  auto sum_chunk = [&](int chunk) {
    const float* slot = colp + (chunk & 1) * kChunk * MP;
    if (tid < kSlice * MP) {
      const int jj = static_cast<int>(rank) * kSlice + tid / MP;
      const int k = tid % MP, j = chunk * kChunk + jj;
      float sum = *contract::at_rank(slot + jj * MP + k, 0);
#pragma unroll
      for (unsigned q = 1; q < kCluster; ++q)
        sum += *contract::at_rank(slot + jj * MP + k, q);
      if (j < n && k < width)
        col[(static_cast<size_t>(t) * n + j) * ldz + k0 + k] = sum;
    }
  };

  for (int e = tid; e < RP * rows * MP; e += kThreads) racc[e] = 0.f;
  for (int e = tid; e < rows * MP; e += kThreads)
    Zr[(e / MP) * ZP + e % MP] = z_at(row0 + e / MP, e % MP);
  const int n_steps = n_chunks * n_tiles;
  if (n_tiles > 0) stage_zc(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue_tile(s);
    contract::cp_async_commit();
  }

  // warp roles: row product on row m-tile (warp % 4), n-tile or k half
  // (warp / 4); column product on column m-tile `warp` of the chunk
  const int mt = warp & 3, rsel = warp >> 2;
  const int rnt = NT == 2 ? rsel : 0, rpart = NT == 2 ? 0 : rsel;
  const int ks0 = NT == 2 ? 0 : 4 * rsel, nks = NT == 2 ? 8 : 4;
  float cacc[NT][4];

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      cacc[nt][0] = cacc[nt][1] = cacc[nt][2] = cacc[nt][3] = 0.f;
    for (int rt = 0; rt < n_tiles; ++rt) {
      const int s = chunk * n_tiles + rt;
      contract::cp_async_wait<kStages - 2>();
      __syncthreads();  // tile s landed for all; tile s - 1 is consumed
      if (s + kStages - 1 < n_steps) issue_tile(s + kStages - 1);
      contract::cp_async_commit();
      if (rt == 0 && chunk + 1 < n_chunks) stage_zc(chunk + 1);
      const unsigned char* tile = ring + (s % kStages) * kTileBytes;
      const __nv_bfloat16* zc = Zc + (chunk & 1) * kChunk * ZP;

      // row product: rows 16 mt .. of the tile against the chunk's Z
      {
        float* ra = racc + (rpart * rows + rt * kRows + 16 * mt + g) * MP +
                    8 * rnt + 2 * tq;
        float c[4] = {ra[0], ra[1], ra[8 * MP], ra[8 * MP + 1]};
        const int r = 16 * mt + (lane & 15);
        for (int ks = ks0; ks < ks0 + nks; ++ks) {
          uint32_t a[4], b[2];
          const int u = 2 * ks + (lane >> 4);
          contract::ldmatrix_x4(a, tile + swizzled(r, u));
          contract::ldmatrix_x2_trans(
              b, zc + (16 * ks + (lane & 15)) * ZP + 8 * rnt);
          contract::mma_bf16(c, a, b[0], b[1]);
        }
        ra[0] = c[0];
        ra[1] = c[1];
        ra[8 * MP] = c[2];
        ra[8 * MP + 1] = c[3];
      }
      // column product: columns 16 warp .. of the chunk, the tile's rows
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        uint32_t a[4];
        const int q = lane >> 3;
        const int r = 16 * ks + (q >> 1) * 8 + (lane & 7);
        const int u = 2 * warp + (q & 1);
        contract::ldmatrix_x4_trans(a, tile + swizzled(r, u));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b[2];
          contract::ldmatrix_x2_trans(
              b, Zr + (rt * kRows + 16 * ks + (lane & 15)) * ZP + 8 * nt);
          contract::mma_bf16(cacc[nt], a, b[0], b[1]);
        }
      }
    }

    // sum the previous chunk over the cluster, then publish this one
    if (chunk > 0) {
      contract::cluster_wait();
      sum_chunk(chunk - 1);
    }
    float* mine = colp + (chunk & 1) * kChunk * MP;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = mine + (16 * warp + g) * MP + 8 * nt + 2 * tq;
      p[0] = cacc[nt][0];
      p[1] = cacc[nt][1];
      p[8 * MP] = cacc[nt][2];
      p[8 * MP + 1] = cacc[nt][3];
    }
    contract::cluster_arrive();
  }

  // the last chunk, then keep this block's slots alive until all have read
  contract::cluster_wait();
  sum_chunk(n_chunks - 1);
  contract::cluster_sync();

  for (int e = tid; e < rows * MP; e += kThreads) {
    const int i = row0 + e / MP, k = e % MP;
    if (i < n && k < width) {
      float sum = racc[e];
      if (RP == 2) sum += racc[rows * MP + e];
      row[(static_cast<size_t>(t) * n + i) * ldz + k0 + k] = sum;
    }
  }
}

template <int MP>
cudaError_t launch(const __nv_bfloat16* W, const float* Z, float* row,
                   float* col, int T, int n, int cols_pad, int ldz, int k0,
                   int width, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, MP);
  cudaError_t err = cudaFuncSetAttribute(
      dual_contract_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(kCluster, T);
  dual_contract_kernel<MP><<<grid, kThreads, smem, stream>>>(
      W, Z, row, col, n, cols_pad, ldz, k0, width, tiles_per_rank(n));
  return cudaGetLastError();
}

}  // namespace

size_t tame_dual_contract_smem_bytes(int n, int width) {
  if (n <= 0 || width <= 0 || width > 16) return 0;
  return smem_bytes(n, width <= 8 ? 8 : 16);
}

cudaError_t tame_dual_contract(const void* W, const float* Z, float* row,
                               float* col, int T, int n, int cols_pad, int m,
                               int k0, cudaStream_t stream) {
  if (T == 0 || n == 0 || m == 0) return cudaSuccess;
  if (cols_pad % 8 != 0 || cols_pad < n || k0 < 0 || k0 >= m)
    return cudaErrorInvalidValue;
  const int width = m - k0 < 16 ? m - k0 : 16;
  if (tame_dual_contract_smem_bytes(n, width) > 232448)
    return cudaErrorInvalidValue;
  const auto* Wb = static_cast<const __nv_bfloat16*>(W);
  if (width <= 8)
    return launch<8>(Wb, Z, row, col, T, n, cols_pad, m, k0, width, stream);
  return launch<16>(Wb, Z, row, col, T, n, cols_pad, m, k0, width, stream);
}
