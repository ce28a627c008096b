// K7 eta_contract: the eta contraction in the (t, i, j) weight layout,
//
//     out[t, i, r] = sum_j W[t, i, j] * bf16(Z[t, j, r]),
//
// W (T, N, N) bf16, Z (T, N, R) float32 read in place and rounded to bf16 as
// it is staged, out (T, N, R) float32 with float32 sums (the TPU kernel's
// jnp.dot(..., preferred_element_type=float32)).
//
// Replaces scripts/layout_probe3.py::_eta_kernel, which pads Z to a
// (T, N, 128) bf16 copy on every call to fill the MXU's lanes and runs one
// MXU dot per (t, 200-row tile).  R is not padded here beyond the
// compile-time width RP in {4, 8, 16} of the staged panel.
//
// Bound: at N = 2000, T = 50, R = 4 the kernel must read 400 MB of W for
// 0.8 G multiply-adds (about 2 flops per byte), so it is bound by bytes:
// (400 + 1.6 + 1.6) MB / 3.35 TB/s = 0.120 ms.  The float32 FMAs on the
// CUDA cores need ~0.024 ms, so no tensor cores are needed.  The design
// streams W once with 16-byte loads and keeps Z out of device memory after
// one staging per block:
//
//   * one block of 8 warps per (t, 32-row tile); warp w owns rows
//     4w .. 4w + 3 of the tile and walks them together, so each lane keeps
//     four 16-byte loads (8 partners of 4 rows) in flight and each staged
//     Z value it reads serves four rows;
//   * Z[t] is staged in shared memory as float (bf16-rounded values) in
//     chunks of 8192 / RP partners (32 KB); for the 16-byte path partner
//     8g + q sits at slot q * G + g, so the 32 lanes of a warp, which read
//     partners 8 lane + q, hit consecutive slots;
//   * each lane accumulates 4 x RP float32 sums in registers over its
//     partners; a warp reduces them with shuffles at the end.
//
// A row of W starts on a 16-byte boundary only when N % 8 == 0; otherwise
// (and for a W pointer that is not 16-byte aligned) the kernel reads W two
// bytes at a time, lanes on neighbouring partners.  Ragged rows and
// partners are masked.
#include <cuda_bf16.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 32
constexpr int kStageFloats = 8192;                    // 32 KB of staged Z

// Element q of eight bf16 values packed in a 16-byte load, as float (a
// bf16 is the upper half of the float with the same value).
__device__ __forceinline__ float bf16_at(const uint4& v, int q) {
  const uint32_t word = q < 2 ? v.x : q < 4 ? v.y : q < 6 ? v.z : v.w;
  return __uint_as_float(q % 2 ? word & 0xffff0000u : word << 16);
}

template <int RP, bool VEC>
__global__ void __launch_bounds__(kThreads)
eta_contract_kernel(const __nv_bfloat16* __restrict__ W,
                    const float* __restrict__ Z, float* __restrict__ out,
                    int N, int R, int tiles) {
  constexpr int kChunk = kStageFloats / RP;  // partners per staging round
  constexpr int G = kChunk / 8;              // 8-partner groups per round
  __shared__ __align__(16) float zs[kStageFloats];
  const int t = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = tile * kRowsPerBlock + warp * kRowsPerWarp;
  const __nv_bfloat16* Wt = W + static_cast<size_t>(t) * N * N;
  const float* Zt = Z + static_cast<size_t>(t) * N * R;

  float acc[kRowsPerWarp][RP];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int k = 0; k < RP; ++k) acc[rr][k] = 0.f;

  for (int j0 = 0; j0 < N; j0 += kChunk) {
    const int cn = min(kChunk, N - j0);
    __syncthreads();  // the previous round's readers are done
    for (int e = threadIdx.x; e < cn * RP; e += kThreads) {
      const int jl = e / RP, k = e % RP;
      const int slot = VEC ? (jl % 8) * G + jl / 8 : jl;
      zs[slot * RP + k] =
          k < R ? __bfloat162float(__float2bfloat16_rn(
                      Zt[static_cast<size_t>(j0 + jl) * R + k]))
                : 0.f;
    }
    __syncthreads();

    if (VEC) {
      // cn % 8 == 0 here (N % 8 == 0 and kChunk % 8 == 0): whole groups.
#pragma unroll 2
      for (int jl = lane * 8; jl < cn; jl += 32 * 8) {
        uint4 raw[kRowsPerWarp];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const int i = row0 + rr;
          raw[rr] = i < N ? __ldg(reinterpret_cast<const uint4*>(
                                Wt + static_cast<size_t>(i) * N + j0 + jl))
                          : make_uint4(0, 0, 0, 0);
        }
        const int g = jl / 8;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float z[RP];
#pragma unroll
          for (int k = 0; k < RP; k += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(&zs[(q * G + g) * RP + k]);
            z[k] = v.x;
            z[k + 1] = v.y;
            z[k + 2] = v.z;
            z[k + 3] = v.w;
          }
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            const float w = bf16_at(raw[rr], q);
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
          w[rr] = i < N ? __bfloat162float(
                              Wt[static_cast<size_t>(i) * N + j0 + jl])
                        : 0.f;
        }
#pragma unroll
        for (int k = 0; k < RP; ++k) {
          const float z = zs[jl * RP + k];
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
      if (i >= N) continue;
      float* o = out + (static_cast<size_t>(t) * N + i) * R;
#pragma unroll
      for (int k = 0; k < RP; ++k)
        if (k < R) o[k] = acc[rr][k];
    }
  }
}

template <int RP>
cudaError_t launch(const __nv_bfloat16* W, const float* Z, float* out, int T,
                   int N, int R, cudaStream_t stream) {
  const int tiles = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = static_cast<long long>(tiles) * T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  if (vec)
    eta_contract_kernel<RP, true><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(W, Z, out, N, R, tiles);
  else
    eta_contract_kernel<RP, false><<<static_cast<unsigned>(blocks), kThreads,
                                     0, stream>>>(W, Z, out, N, R, tiles);
  return cudaGetLastError();
}

}  // namespace

cudaError_t tame_eta_contract(const void* W, const float* Z, float* out, int T,
                              int N, int R, cudaStream_t stream) {
  if (T == 0 || N == 0) return cudaSuccess;
  const auto* Wb = static_cast<const __nv_bfloat16*>(W);
  if (R >= 1 && R <= 4) return launch<4>(Wb, Z, out, T, N, R, stream);
  if (R > 4 && R <= 8) return launch<8>(Wb, Z, out, T, N, R, stream);
  if (R > 8 && R <= 16) return launch<16>(Wb, Z, out, T, N, R, stream);
  return cudaErrorInvalidValue;
}
