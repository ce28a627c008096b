// K7 eta_contract: the eta contraction of time-major dyad weights,
//
//     out[i, t, k] = sum_j W[t, i, j] * z(Z[j, t, k]),   0 <= i < m,
//
// W (T, m, n) float32 or bf16 with its partners at unit stride and its rows
// and time steps at any stride, so a stripe of rows of the (T, n, n)
// weights is read in place; Z the caller's (n, T, R) float32 panel at any
// strides (the state's U or V columns, the diagnostics' [V | U] halves),
// read in place; z the bf16 rounding for bf16 weights (the JAX package's
// preferred_element_type=float32 products) and the identity for float32
// ones; out (m, T, R) float32, the caller's layout, float32 sums.
//
// Replaces scripts/layout_probe3.py::_eta_kernel, which pads Z to a
// (T, N, 128) bf16 copy on every call to fill the MXU's lanes and runs one
// MXU dot per (t, 200-row tile).  The engines' block steps call it on a
// stripe of bs rows of W0 and of W1 per phase, the Jacobi step and the
// stats diagnostics on the whole matrix.
//
// Bound: a 125-row stripe at n = 2000, T = 50, R = 4 moves 25 MB of bf16
// weights (50 MB in float32), 1.6 MB of panel and 0.1 MB of sums for
// 0.1 G multiply-adds (about 2 flops per byte of bf16 weights), so it is
// bound by bytes: 8.0 us (15.4 us in float32) at 3.35 TB/s; the float32
// FMAs on the CUDA cores need 1.5 us, so no tensor cores are needed.  The
// design streams W once with 16-byte loads and keeps Z out of device
// memory after one staging per block:
//
//   * one block per (t, run of row tiles, group of RP = 4 or 8 columns);
//     a tile is 4 x warps rows, warp w owning rows 4w .. 4w + 3 and walking
//     them together, so each lane keeps 2 x 4 16-byte loads in flight and
//     each staged Z value it reads serves four rows.  8 warps (4 where 8
//     would leave SMs without a block, 1 for stripes of at most 4 rows); a
//     block walks as many tiles as leave eight blocks per SM (a 125-row
//     stripe at T = 50: one tile of 32 rows, 200 blocks; the whole
//     n = 2000 matrix at R = 4: 2 tiles, 1,600 blocks; at R = 16, 5 tiles
//     of 2 groups, 1,300 blocks), so Z[t] is staged once for all of them;
//   * wider panels (the stats diagnostics' 4r = 16 columns, 92 at r = 23)
//     go in groups of 8 columns, the groups of a run in neighbouring
//     blocks: 8 columns keep a thread's sums and loads within 128
//     registers (two blocks per SM) where 16 took 200 and the block's
//     staged panel 128 KB, one block per SM (0.39 ms at R = 16 on an H100,
//     against 0.34 ms in two groups);
//   * Z[t] is staged in dynamic shared memory as float (rounded for bf16
//     weights), up to 96 KB (all n = 2000 partners of 8 columns), 16
//     loads in flight per thread; a 16-byte load holds V = 8 bf16 or 4
//     float32 partners, and partner V g + q sits at slot q G + g, its
//     columns 4c .. 4c + 3 in the c-th plane of 16-byte slots, so the 32
//     lanes of a warp, which read partners V lane + q, read consecutive 16
//     bytes: no bank conflict at any width;
//   * each lane accumulates 4 x RP float32 sums in registers over its
//     partners; a warp reduces them with shuffles at the end of a tile and
//     lane 0 writes its rows' (t, columns) entries.
//
// A row's and a column's arithmetic does not depend on the tiling or the
// grouping, so a stripe's sums are bit for bit those of the same rows of
// the whole matrix.
//
// A row of W starts on a 16-byte boundary only when the row and time
// strides and n are multiples of V and W is 16-byte aligned; otherwise the
// kernel reads W one element at a time, lanes on neighbouring partners.
// Ragged rows, partners and columns are masked.  Up to 92 columns (4r at
// r = 23, the widest state K1 and K2 take: d = 48).
#include <cuda_bf16.h>

#include <algorithm>

#include "kernels.h"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxStageBytes = 96 * 1024;  // staged Z of one block
constexpr int kStageBatch = 16;  // panel loads a thread keeps in flight

template <typename WT>
struct Weights;

template <>
struct Weights<float> {
  static constexpr int kVec = 4;  // partners per 16-byte load
  __device__ static float at(const uint4& v, int q) {
    return __uint_as_float(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w);
  }
  __device__ static float one(float w) { return w; }
  __device__ static float panel(float z) { return z; }
};

template <>
struct Weights<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // Element q of eight bf16 values, as float (a bf16 is the upper half of
  // the float with the same value).
  __device__ static float at(const uint4& v, int q) {
    const uint32_t word = q < 2 ? v.x : q < 4 ? v.y : q < 6 ? v.z : v.w;
    return __uint_as_float(q % 2 ? word & 0xffff0000u : word << 16);
  }
  __device__ static float one(__nv_bfloat16 w) { return __bfloat162float(w); }
  __device__ static float panel(float z) {
    return __bfloat162float(__float2bfloat16_rn(z));
  }
};

struct Args {
  const void* W;
  long long w_t, w_i;  // strides of W's time steps and rows (elements)
  const float* Z;
  long long z_j, z_t, z_k;  // strides of Z's partners, time steps, columns
  float* out;
  int T, m, n, R;
  int chunk;   // partners staged at once, a multiple of the vector width
  int sub;     // row tiles a block walks, one after the other
  int tiles;   // row-tile runs per time step
  int groups;  // blocks per run: column groups of RP
};

template <typename WT, int RP, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
eta_contract_kernel(const Args a) {
  using Wt = Weights<WT>;
  constexpr int V = Wt::kVec;
  extern __shared__ __align__(16) float zs[];
  const int warps = blockDim.x / 32, rows = warps * kRowsPerWarp;
  // column group fastest: a run's groups read the same rows at about the
  // same time
  const int k0 = blockIdx.x % a.groups * RP;
  const int run = blockIdx.x / a.groups;
  const int t = run / a.tiles, tile = run % a.tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.chunk / V;  // V-partner groups of a staging round
  const bool once = a.n <= a.chunk;  // Z[t] staged once for every tile
  const WT* W = static_cast<const WT*>(a.W) + t * a.w_t;
  const float* Z = a.Z + t * a.z_t + k0 * a.z_k;
  const int R = min(RP, a.R - k0);  // this block's columns
  const int first = tile * a.sub * rows;

  for (int s = 0; s < a.sub; ++s) {
    const int base = first + s * rows;
    if (base >= a.m) break;  // the same for the whole block
    const int row0 = base + warp * kRowsPerWarp;

    float acc[kRowsPerWarp][RP];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int k = 0; k < RP; ++k) acc[rr][k] = 0.f;

    for (int j0 = 0; j0 < a.n; j0 += a.chunk) {
      const int cn = min(a.chunk, a.n - j0);
      if (!once || s == 0) {
        __syncthreads();  // the previous round's readers are done
        // kStageBatch loads in flight before their stores: the panel's
        // rows are scattered (a stride of T (2 + 2r) floats in the means)
        for (int e0 = threadIdx.x; e0 < cn * RP;
             e0 += kStageBatch * blockDim.x) {
          float v[kStageBatch];
#pragma unroll
          for (int b = 0; b < kStageBatch; ++b) {
            const int e = e0 + b * blockDim.x, jl = e / RP, k = e % RP;
            v[b] = e < cn * RP && k < R
                       ? __ldg(Z + (j0 + jl) * a.z_j + k * a.z_k)
                       : 0.f;
          }
#pragma unroll
          for (int b = 0; b < kStageBatch; ++b) {
            const int e = e0 + b * blockDim.x, jl = e / RP, k = e % RP;
            const int slot = VEC ? (jl % V) * G + jl / V : jl;
            if (e < cn * RP)
              zs[((k / 4) * a.chunk + slot) * 4 + k % 4] = Wt::panel(v[b]);
          }
        }
        __syncthreads();
      }

      if (VEC) {
        // cn % V == 0 here (n % V == 0 and chunk % V == 0): whole groups.
#pragma unroll 2
        for (int jl = lane * V; jl < cn; jl += 32 * V) {
          uint4 raw[kRowsPerWarp];
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            const int i = row0 + rr;
            raw[rr] = i < a.m ? __ldg(reinterpret_cast<const uint4*>(
                                    W + i * a.w_i + j0 + jl))
                              : make_uint4(0, 0, 0, 0);
          }
          const int g = jl / V;
#pragma unroll
          for (int q = 0; q < V; ++q) {
            float z[RP];
#pragma unroll
            for (int k = 0; k < RP; k += 4) {
              const float4 v = *reinterpret_cast<const float4*>(
                  &zs[((k / 4) * a.chunk + q * G + g) * 4]);
              z[k] = v.x;
              z[k + 1] = v.y;
              z[k + 2] = v.z;
              z[k + 3] = v.w;
            }
#pragma unroll
            for (int rr = 0; rr < kRowsPerWarp; ++rr) {
              const float w = Wt::at(raw[rr], q);
#pragma unroll
              for (int k = 0; k < RP; ++k)
                acc[rr][k] = fmaf(w, z[k], acc[rr][k]);
            }
          }
        }
      } else {
        for (int jl = lane; jl < cn; jl += 32) {
          float w[kRowsPerWarp];
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            const int i = row0 + rr;
            w[rr] = i < a.m ? Wt::one(W[i * a.w_i + j0 + jl]) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < RP; ++k) {
            const float z = zs[((k / 4) * a.chunk + jl) * 4 + k % 4];
#pragma unroll
            for (int rr = 0; rr < kRowsPerWarp; ++rr)
              acc[rr][k] = fmaf(w[rr], z, acc[rr][k]);
          }
        }
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        float v = acc[rr][k];
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[rr][k] = v;
      }
    if (lane == 0) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int i = row0 + rr;
        if (i >= a.m) continue;
        float* o = a.out + (static_cast<long long>(i) * a.T + t) * a.R + k0;
#pragma unroll
        for (int k = 0; k < RP; ++k)
          if (k < R) o[k] = acc[rr][k];
      }
    }
  }
}

template <typename WT, int RP, bool VEC>
cudaError_t launch_one(const Args& a, int warps, cudaStream_t stream) {
  auto* kernel = eta_contract_kernel<WT, RP, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
  if (attr != cudaSuccess) return attr;
  const size_t smem = static_cast<size_t>(a.chunk) * RP * sizeof(float);
  kernel<<<static_cast<unsigned>(a.tiles) * a.T * a.groups, warps * 32,
           smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename WT, int RP>
cudaError_t launch(Args a, int sms, cudaStream_t stream) {
  constexpr int V = Weights<WT>::kVec;
  const int cap = kMaxStageBytes / (RP * static_cast<int>(sizeof(float)))
                  / V * V;
  a.chunk = min((a.n + V - 1) / V * V, cap);
  a.groups = (a.R + RP - 1) / RP;
  int warps = a.m <= kRowsPerWarp ? 1 : 8;
  const long long tiles8 = (a.m + 8 * kRowsPerWarp - 1) / (8 * kRowsPerWarp);
  if (warps == 8 && tiles8 * a.T < sms) warps = 4;
  // Row tiles a block walks with Z[t] staged once: as many as leave eight
  // blocks per SM (one where Z[t] is staged again for each tile).
  const int rows = warps * kRowsPerWarp;
  const long long tiles = (a.m + rows - 1) / rows;
  a.sub = a.n <= a.chunk
              ? static_cast<int>(std::max(
                    1LL, std::min(tiles, tiles * a.T * a.groups / (8LL * sms))))
              : 1;
  a.tiles = static_cast<int>((tiles + a.sub - 1) / a.sub);
  if (static_cast<long long>(a.tiles) * a.T * a.groups > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool vec = a.n % V == 0 && a.w_i % V == 0 && a.w_t % V == 0 &&
                   reinterpret_cast<uintptr_t>(a.W) % 16 == 0;
  return vec ? launch_one<WT, RP, true>(a, warps, stream)
             : launch_one<WT, RP, false>(a, warps, stream);
}

template <typename WT>
cudaError_t dispatch(const Args& a, int sms, cudaStream_t stream) {
  if (a.R >= 1 && a.R <= 4) return launch<WT, 4>(a, sms, stream);
  if (a.R > 4 && a.R <= 92) return launch<WT, 8>(a, sms, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t tame_eta_contract(const void* W, int w_bf16, long long w_t,
                              long long w_i, const float* Z, long long z_j,
                              long long z_t, long long z_k, float* out, int T,
                              int m, int n, int R, int sms,
                              cudaStream_t stream) {
  if (T == 0 || m == 0) return cudaSuccess;
  const Args a{W, w_t, w_i, Z, z_j, z_t, z_k, out, T, m, n, R, 0, 0, 0};
  return w_bf16 ? dispatch<__nv_bfloat16>(a, sms, stream)
                : dispatch<float>(a, sms, stream);
}
