// K1 spd_solve_inv and K2 logdet_spd: a group of lanes per small SPD
// system, one row of P per lane, a Cholesky factorization by shuffles in
// the JAX kernel's arithmetic order.
//
// Replace tame/ops/cholesky.py::_chol_solve_inv_kernel and ::_logdet_kernel,
// which lay the batch on the TPU's 128 lanes (one system per lane, every
// step of the d x d Cholesky a vector op across them) and pad the tail with
// identity systems.  The contract is theirs: mu = P^-1 eta and P^-1 (K1),
// log det P (K2), from the lower triangle of P; a system that is not
// positive definite comes out NaN, and only that system (the twin's
// _cholesky_nan).
//
// Bound: device-memory traffic.  K1 with the inverse reads d^2 + d and
// writes d^2 + d floats per system for about 2.3 d^3 flops, far below the
// card's flop/byte balance; K2 reads d^2 floats for d^3 / 3.  What a
// system's chains of d dependent steps cost is latency, hidden by the
// other systems of the SM.  The design:
//
//   * a group of G lanes per system, row i of P in registers of lane
//     i % G.  K1 with the inverse takes G = 4, 8, 16 or 32 by d (one row a
//     lane; rows k and k + 32 for 34 <= d <= 48), K2 and K1 without it
//     narrower groups with several rows a lane (spd_group says why).
//     Blocks have 256 threads (391 blocks at d = 10, B = 6,250 for K1), 64
//     where a lane's rows take more than 64 registers.  Every loop runs to
//     the column capacity DC, a compile-time constant (exact d up to 16,
//     then 24, 32, 48, K4's rule), so it unrolls; past d nothing is read,
//     no step is taken and nothing is written;
//   * lane k reads the entries of its rows up to the diagonal, d
//     contiguous floats a row, in 8- or 16-byte loads, so a warp reads
//     32 / G neighbouring systems as one span.  The upper triangle is never
//     read;
//   * the factorization is right-looking: at step k every lane takes the
//     pivot from its lane by one shuffle, the reciprocal of its root, and
//     scales its own L_ik; then, for each j > k, L_jk is shuffled from
//     lane j and every row updates its entry j by one FMA.  Each entry
//     sees the same operations in the same order as in the JAX kernel's
//     (and the one-thread CUDA kernel's) left-looking loop, with IEEE
//     roots, reciprocals and logs, so L, the pivots and log det P are
//     those kernels' bits.  That matters beyond the kernel: in the masked
//     bf16 fits a change of an ulp in K1 or K2 moves the iteration at which
//     the tolerance-and-patience rule stops (measured on the card: a
//     Gauss-Jordan sweep in the same groups stopped the einsum and packed
//     masked fits at 87 and 200 iterations, where these bits stop them at
//     164 and 161);
//   * K2 sums the log pivots in step order and one lane writes it.  Up to
//     d = 12 it runs the same Cholesky on one thread per system instead
//     (logdet_thread_kernel says why): the same bits;
//   * K1 then solves by columns: lane c takes the columns c, c + G, ... of
//     [I | eta] and runs the JAX kernel's forward and backward
//     substitution on each, every L entry shuffled from the lane that holds
//     its row, so each column of P^-1 and mu is computed as there.  Lane c
//     stores column c of P^-1, so the lanes of a group write each row of
//     P^-1 as one contiguous span.  Without the inverse every lane solves
//     eta alone, by the same operations, so mu is the same bits.  1 / L_kk
//     sits in the diagonal slot of row k once its step is done, and is
//     shuffled from there;
//   * a pivot that is not positive becomes NaN, which turns every entry of
//     that system NaN and leaves the others alone;
//   * the ragged tail is a bounds check on the system index: a group past
//     B leaves whole, and the shuffles name only the warp's live lanes.
//     Groups never cooperate across warps, so there is no barrier.
#include "chol.cuh"  // kMaxRuntimeD
#include "kernels.h"

#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Column capacity of d: exact up to 16, then 24, 32, 48.
__host__ __device__ constexpr int spd_capacity(int d) {
  return d <= 16 ? d : (d <= 24 ? 24 : (d <= 32 ? 32 : 48));
}
// Lanes per system at capacity c.  K1 with the inverse: 4, 8, 16, then a
// whole warp, two rows per lane past 32.  Narrow (K1 without the inverse,
// and K2 past d = 12): 4 up to 16, then 8 and 16, several rows per lane.  Each
// shuffle costs the warp one issue for all its lanes, and the card issues
// one warp shuffle per cycle per SM: at large B that bounds the kernels
// that solve one column or none, so they take the narrower groups, which
// serve more systems per shuffle.  The inverse's d + 1 columns spread over
// the lanes of a wide group.
__host__ __device__ constexpr int spd_group(int c, bool narrow) {
  return narrow ? (c <= 16 ? 4 : (c <= 24 ? 8 : 16))
                : (c <= 4 ? 4 : (c <= 8 ? 8 : (c <= 16 ? 16 : 32)));
}
// Rows per lane, and threads per block: 256, or 64 where a lane's rows
// take more than 64 registers (so more blocks fit an SM's registers).
__host__ __device__ constexpr int spd_rows(int c, bool narrow) {
  return (c + spd_group(c, narrow) - 1) / spd_group(c, narrow);
}
__host__ __device__ constexpr int spd_threads(int c, bool narrow) {
  return spd_rows(c, narrow) * c > 64 ? 64 : 256;
}

inline bool spd_supported(int d) {
  return d >= 4 && d <= kMaxRuntimeD && d % 2 == 0;
}

// Compile-time shape of capacity DC, wide or NARROW (spd_group): G lanes
// per system, R rows per lane (row i in lane i % G, slot i / G), C columns
// of [I | eta] per lane, V floats per load, kSystems systems per block of
// kThreads.
template <int DC, bool NARROW>
struct Shape {
  static constexpr int G = spd_group(DC, NARROW);
  static constexpr int R = spd_rows(DC, NARROW);
  static constexpr int C = (DC + G) / G;
  static constexpr int V = (DC <= 16 && DC % 4 == 0) ? 4 : 2;
  static constexpr int kThreads = spd_threads(DC, NARROW);
  static constexpr int kSystems = kThreads / G;
};

// Row i of the d x d system at Pb, its entries up to the diagonal, into a
// (the rest zero) in V-float loads; rows i >= d stay zero.  A load that
// holds the diagonal may bring entries past it; they are never read.
template <int DC, int V>
__device__ __forceinline__ void load_lower_row(const float* __restrict__ Pb,
                                               int d, int i, float (&a)[DC]) {
#pragma unroll
  for (int j = 0; j < DC; ++j) a[j] = 0.f;
  if (i >= d) return;
  const float* row = Pb + static_cast<size_t>(i) * d;
#pragma unroll
  for (int c = 0; c < DC; c += V) {
    if (c <= i && c < d) {
      if (V == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + c));
        a[c] = v.x;
        a[c + 1] = v.y;
        a[c + 2] = v.z;
        a[c + 3] = v.w;
      } else {
        const float2 v = __ldg(reinterpret_cast<const float2*>(row + c));
        a[c] = v.x;
        a[c + 1] = v.y;
      }
    }
  }
}

__device__ __forceinline__ float positive_or_nan(float piv) {
  return piv > 0.f ? piv : __int_as_float(0x7fc00000);
}

// Right-looking Cholesky of the rows the group holds (row i in a[i / G] of
// lane i % G, read up to the diagonal): on exit a[r][m] holds L_im for
// m < i and 1 / L_ii on the diagonal (inv_of reads it); returns sum_m log
// L_mm^2.  Entries past the diagonal are written, never read.
template <int DC, int G, int R>
__device__ __forceinline__ float group_cholesky(float (&a)[R][DC], int k,
                                                int d, unsigned live) {
  float logdet = 0.f;
#pragma unroll
  for (int m = 0; m < DC; ++m) {
    if (DC > 16 && m >= d) continue;  // no step past d
    const float acc =
        positive_or_nan(__shfl_sync(live, a[m / G][m], m % G, G));
    logdet += logf(acc);
    const float inv = 1.f / sqrtf(acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = k + G * r;
      a[r][m] = i > m ? a[r][m] * inv : (i == m ? inv : a[r][m]);  // L_im
    }
#pragma unroll
    for (int j = m + 1; j < DC; ++j) {
      if (DC > 16 && j >= d) continue;
      const float ljm = __shfl_sync(live, a[j / G][m], j % G, G);
#pragma unroll
      for (int r = 0; r < R; ++r) a[r][j] = fmaf(-a[r][m], ljm, a[r][j]);
    }
  }
  return logdet;
}

// Entry (i, m) of the factored rows (L_im, or 1 / L_ii for m = i), shuffled
// from the lane that holds row i.
template <int DC, int G, int R>
__device__ __forceinline__ float entry(const float (&a)[R][DC], int i, int m,
                                       unsigned live) {
  return __shfl_sync(live, a[i / G][m], i % G, G);
}

template <int DC, bool WITH_INVERSE>
__global__ void __launch_bounds__(Shape<DC, !WITH_INVERSE>::kThreads)
spd_solve_inv_kernel(const float* __restrict__ P, const float* __restrict__ eta,
                     float* __restrict__ mu, float* __restrict__ cov, int B,
                     int d_rt) {
  using S = Shape<DC, !WITH_INVERSE>;
  constexpr int G = S::G, R = S::R, C = S::C;
  const int d = DC <= 16 ? DC : d_rt;  // a constant up to 16
  const int k = threadIdx.x % G;
  const size_t b = static_cast<size_t>(blockIdx.x) * S::kSystems +
                   threadIdx.x / G;
  const unsigned live = __ballot_sync(kFull, b < static_cast<size_t>(B));
  if (b >= static_cast<size_t>(B)) return;
  const float* Pb = P + b * d * d;
  float a[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r) load_lower_row<DC, S::V>(Pb, d, k + G * r, a[r]);
  group_cholesky<DC, G, R>(a, k, d, live);

  // The columns of [I | eta] this lane solves: slot s holds column
  // c = k + G s, e_c for c < d and eta for c = d.  Without the inverse
  // every lane solves eta alone (the warp issues it once either way), its
  // forward pass right-looking: row i's sum stays in its lane and y_i is
  // shuffled out once final, each sum taking its terms in the same order.
  constexpr int CS = WITH_INVERSE ? C : 1;
  float x[CS][DC];
  if (WITH_INVERSE) {
#pragma unroll
    for (int s = 0; s < CS; ++s) {
      const int c = k + G * s;
#pragma unroll
      for (int i = 0; i < DC; ++i)
        x[s][i] = c == d ? (i < d ? __ldg(eta + b * d + i) : 0.f)
                         : (i == c ? 1.f : 0.f);
    }
    // y = L^-1 x in the JAX kernel's order
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      if (DC > 16 && i >= d) continue;
#pragma unroll
      for (int m = 0; m < i; ++m) {
        const float lim = entry<DC, G, R>(a, i, m, live);
#pragma unroll
        for (int s = 0; s < CS; ++s) x[s][i] = fmaf(-lim, x[s][m], x[s][i]);
      }
      const float inv = entry<DC, G, R>(a, i, i, live);
#pragma unroll
      for (int s = 0; s < CS; ++s) x[s][i] *= inv;
    }
  } else {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = k + G * r;
      acc[r] = i < d ? __ldg(eta + b * d + i) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      if (DC > 16 && i >= d) continue;
      x[0][i] = __shfl_sync(live, acc[i / G] * a[i / G][i], i % G, G);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (k + G * r > i) acc[r] = fmaf(-a[r][i], x[0][i], acc[r]);
    }
  }
  // x = L^-T y in the JAX kernel's order
#pragma unroll
  for (int i = DC - 1; i >= 0; --i) {
    if (DC > 16 && i >= d) continue;
#pragma unroll
    for (int m = i + 1; m < DC; ++m) {
      if (DC > 16 && m >= d) continue;
      const float lmi = entry<DC, G, R>(a, m, i, live);
#pragma unroll
      for (int s = 0; s < CS; ++s) x[s][i] = fmaf(-lmi, x[s][m], x[s][i]);
    }
    const float inv = entry<DC, G, R>(a, i, i, live);
#pragma unroll
    for (int s = 0; s < CS; ++s) x[s][i] *= inv;
  }
#pragma unroll
  for (int s = 0; s < CS; ++s) {
    const int c = WITH_INVERSE ? k + G * s : d;
    if (c == d && (WITH_INVERSE || k == 0)) {
#pragma unroll
      for (int i = 0; i < DC; ++i)
        if (i < d) mu[b * d + i] = x[s][i];
    } else if (WITH_INVERSE && c < d) {
#pragma unroll
      for (int i = 0; i < DC; ++i)
        if (i < d) cov[(b * d + i) * d + c] = x[s][i];
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(Shape<DC, true>::kThreads)
logdet_spd_kernel(const float* __restrict__ P, float* __restrict__ out, int B,
                  int d_rt) {
  using S = Shape<DC, true>;
  constexpr int G = S::G, R = S::R;
  const int d = DC <= 16 ? DC : d_rt;
  const int k = threadIdx.x % G;
  const size_t b = static_cast<size_t>(blockIdx.x) * S::kSystems +
                   threadIdx.x / G;
  const unsigned live = __ballot_sync(kFull, b < static_cast<size_t>(B));
  if (b >= static_cast<size_t>(B)) return;
  float a[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r)
    load_lower_row<DC, S::V>(P + b * d * d, d, k + G * r, a[r]);
  const float logdet = group_cholesky<DC, G, R>(a, k, d, live);
  if (k == 0) out[b] = logdet;
}

// K2 for d <= kThreadLogdetMaxD: one thread per system, the reference
// order itself (left-looking, the lower triangle loaded first), so the
// same bits as the group's.  At the entropy's B = n T it has work enough
// for every lane, and it issues each step's root, reciprocal and log once
// for 32 systems where a group of G lanes issues them for 32 / G; on the
// card the group took longer than this kernel at d = 10, B = 100,000.
constexpr int kThreadLogdetMaxD = 12;
constexpr int kThreadLogdetThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreadLogdetThreads)
logdet_thread_kernel(const float* __restrict__ P, float* __restrict__ out,
                     int B) {
  const size_t b = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= static_cast<size_t>(B)) return;
  const float* Pb = P + b * D * D;
  float A[D][D];  // the lower triangle, all loads issued first
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) A[i][j] = Pb[i * D + j];
  float logdet = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float acc = A[k][k];
#pragma unroll
    for (int m = 0; m < k; ++m) acc = fmaf(-A[k][m], A[k][m], acc);
    acc = positive_or_nan(acc);
    logdet += logf(acc);
    const float inv = 1.f / sqrtf(acc);
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      float a2 = A[i][k];
#pragma unroll
      for (int m = 0; m < k; ++m) a2 = fmaf(-A[i][m], A[k][m], a2);
      A[i][k] = a2 * inv;
    }
  }
  out[b] = logdet;
}

inline int blocks_for(int B, int systems) {
  return static_cast<int>((static_cast<long long>(B) + systems - 1) / systems);
}

template <int DC>
cudaError_t launch_solve(const float* P, const float* eta, float* mu,
                         float* cov, int B, int d, cudaStream_t stream) {
  using W = Shape<DC, false>;
  using N = Shape<DC, true>;
  if (cov != nullptr)
    spd_solve_inv_kernel<DC, true>
        <<<blocks_for(B, W::kSystems), W::kThreads, 0, stream>>>(
            P, eta, mu, cov, B, d);
  else
    spd_solve_inv_kernel<DC, false>
        <<<blocks_for(B, N::kSystems), N::kThreads, 0, stream>>>(
            P, eta, mu, nullptr, B, d);
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch_logdet(const float* P, float* out, int B, int d,
                          cudaStream_t stream) {
  if constexpr (DC <= kThreadLogdetMaxD)
    logdet_thread_kernel<DC><<<blocks_for(B, kThreadLogdetThreads),
                               kThreadLogdetThreads, 0, stream>>>(P, out, B);
  else
    logdet_spd_kernel<DC><<<blocks_for(B, Shape<DC, true>::kSystems),
                            Shape<DC, true>::kThreads, 0, stream>>>(P, out, B,
                                                                    d);
  return cudaGetLastError();
}

// The capacities instantiated.
#define TAME_FOR_EACH_SPD_DC(X) \
  X(4) X(6) X(8) X(10) X(12) X(14) X(16) X(24) X(32) X(48)

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

SpdGeometry tame_spd_geometry(int d, bool narrow) {
  if (!spd_supported(d)) return {0, 0, 0};
  const int c = spd_capacity(d), g = spd_group(c, narrow);
  return {c, g, spd_threads(c, narrow) / g};
}

cudaError_t tame_spd_solve_inv(const float* P, const float* eta, float* mu,
                               float* cov, int B, int d, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (!spd_supported(d)) return cudaErrorInvalidValue;
  if (!aligned16(P)) return cudaErrorMisalignedAddress;
  switch (spd_capacity(d)) {
#define TAME_CASE(DC) \
  case DC:            \
    return launch_solve<DC>(P, eta, mu, cov, B, d, stream);
    TAME_FOR_EACH_SPD_DC(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t tame_logdet_spd(const float* P, float* out, int B, int d,
                            cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (!spd_supported(d)) return cudaErrorInvalidValue;
  if (!aligned16(P)) return cudaErrorMisalignedAddress;
  switch (spd_capacity(d)) {
#define TAME_CASE(DC) \
  case DC:            \
    return launch_logdet<DC>(P, out, B, d, stream);
    TAME_FOR_EACH_SPD_DC(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
