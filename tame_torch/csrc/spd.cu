// K1 spd_solve_inv and K2 logdet_spd: one thread per small SPD system.
//
// Replace tame/ops/cholesky.py::_chol_solve_inv_kernel and ::_logdet_kernel,
// which lay the batch on the TPU's 128 lanes and pad the tail with identity
// systems.  Here each thread owns one system: it reads the lower triangle
// of its P, factors it in registers (chol.cuh), and writes mu (and P^-1 one
// column per solve, or log det P).  The ragged tail is a bounds check.
//
// Bound: device-memory traffic (~d^3 flops per (d^2 + d) floats read).
// Reading a row-major (B, d, d) batch with one system per thread is
// uncoalesced — neighbouring threads read addresses d^2 floats apart — and
// is accepted in this first version; L1/L2 serve the sector reuse.
//
// d in {4, ..., 12} runs the unrolled template<int D> kernels (factor in
// registers).  Every other even d up to kMaxRuntimeD (the JAX kernels take
// any d; an r = 6 model has d = 14) runs the runtime-d kernels: still one
// thread per system, the factor as a packed lower triangle in dynamic
// shared memory (d (d + 1) / 2 floats per thread, thread-interleaved so a
// warp's accesses are conflict-free), 32 threads per block, so a block
// needs 128 (d (d + 1) / 2 + 2 d) bytes: 17 KB at d = 14, 163 KB at d = 48.
#include "chol.cuh"
#include "kernels.h"

namespace {

constexpr int kThreads = 128;
constexpr int kRtThreads = 32;  // systems per block of the runtime-d kernels

// Shared floats per system of the runtime-d kernels: the packed factor,
// 1 / L_kk and one work vector.
__host__ __device__ inline int rt_floats(int d) {
  return d * (d + 1) / 2 + 2 * d;
}

template <int D>
__device__ __forceinline__ void load_lower(const float* __restrict__ P,
                                           float (&A)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) A[i][j] = P[i * D + j];
}

template <int D, bool WITH_INVERSE>
__global__ void __launch_bounds__(kThreads)
spd_solve_inv_kernel(const float* __restrict__ P, const float* __restrict__ eta,
                     float* __restrict__ mu, float* __restrict__ cov, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float A[D][D], inv_diag[D], rhs[D], x[D];
  load_lower<D>(P + static_cast<size_t>(b) * D * D, A);
  chol_factor<D>(A, inv_diag);
#pragma unroll
  for (int i = 0; i < D; ++i) rhs[i] = eta[static_cast<size_t>(b) * D + i];
  chol_solve<D>(A, inv_diag, rhs, x);
#pragma unroll
  for (int i = 0; i < D; ++i) mu[static_cast<size_t>(b) * D + i] = x[i];
  if (WITH_INVERSE) {
    float* out = cov + static_cast<size_t>(b) * D * D;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      chol_inverse_column<D>(A, inv_diag, j, x);
#pragma unroll
      for (int i = 0; i < D; ++i) out[i * D + j] = x[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
logdet_spd_kernel(const float* __restrict__ P, float* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float A[D][D], inv_diag[D];
  load_lower<D>(P + static_cast<size_t>(b) * D * D, A);
  out[b] = chol_factor<D>(A, inv_diag);
}

// Runtime-d K1: thread t of the block owns system blockIdx.x * 32 + t.
__global__ void __launch_bounds__(kRtThreads)
spd_solve_inv_rt_kernel(const float* __restrict__ P,
                        const float* __restrict__ eta, float* __restrict__ mu,
                        float* __restrict__ cov, int B, int d) {
  extern __shared__ float smem_rt[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kRtThreads + tid;
  if (b >= B) return;  // no barrier below: threads never cooperate
  const int tri = d * (d + 1) / 2;
  const PackedLower A{smem_rt + tid, kRtThreads};
  const StridedVec inv_diag{smem_rt + tri * kRtThreads + tid, kRtThreads};
  const StridedVec x{smem_rt + (tri + d) * kRtThreads + tid, kRtThreads};
  const float* Pb = P + static_cast<size_t>(b) * d * d;
  for (int i = 0; i < d; ++i)
    for (int j = 0; j <= i; ++j) A(i, j) = Pb[i * d + j];
  chol_factor_rt(A, inv_diag, d);
  for (int i = 0; i < d; ++i) x[i] = eta[static_cast<size_t>(b) * d + i];
  chol_solve_rt(A, inv_diag, x, d);
  for (int i = 0; i < d; ++i) mu[static_cast<size_t>(b) * d + i] = x[i];
  if (cov != nullptr) {
    float* out = cov + static_cast<size_t>(b) * d * d;
    for (int j = 0; j < d; ++j) {
      chol_inverse_column_rt(A, inv_diag, j, x, d);
      for (int i = 0; i < d; ++i) out[i * d + j] = x[i];
    }
  }
}

// Runtime-d K2.
__global__ void __launch_bounds__(kRtThreads)
logdet_spd_rt_kernel(const float* __restrict__ P, float* __restrict__ out,
                     int B, int d) {
  extern __shared__ float smem_rt[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kRtThreads + tid;
  if (b >= B) return;
  const int tri = d * (d + 1) / 2;
  const PackedLower A{smem_rt + tid, kRtThreads};
  const StridedVec inv_diag{smem_rt + tri * kRtThreads + tid, kRtThreads};
  const float* Pb = P + static_cast<size_t>(b) * d * d;
  for (int i = 0; i < d; ++i)
    for (int j = 0; j <= i; ++j) A(i, j) = Pb[i * d + j];
  out[b] = chol_factor_rt(A, inv_diag, d);
}

// Launches a runtime-d kernel with its dynamic shared memory (opted in past
// 48 KB).
template <class Kernel, class... Args>
cudaError_t launch_rt(Kernel kernel, int B, int d, cudaStream_t stream,
                      Args... args) {
  const size_t smem = sizeof(float) * rt_floats(d) * kRtThreads;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(B + kRtThreads - 1) / kRtThreads, kRtThreads, smem, stream>>>(
      args...);
  return cudaGetLastError();
}

}  // namespace

cudaError_t tame_spd_solve_inv(const float* P, const float* eta, float* mu,
                               float* cov, int B, int d, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (tame_runtime_d(d))
    return launch_rt(spd_solve_inv_rt_kernel, B, d, stream, P, eta, mu, cov,
                     B, d);
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  switch (d) {
#define TAME_CASE(DD)                                                      \
  case DD:                                                                 \
    if (cov != nullptr)                                                    \
      spd_solve_inv_kernel<DD, true><<<grid, block, 0, stream>>>(P, eta, mu, \
                                                                 cov, B);  \
    else                                                                   \
      spd_solve_inv_kernel<DD, false><<<grid, block, 0, stream>>>(         \
          P, eta, mu, nullptr, B);                                         \
    break;
    TAME_FOR_EACH_D(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t tame_logdet_spd(const float* P, float* out, int B, int d,
                            cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (tame_runtime_d(d))
    return launch_rt(logdet_spd_rt_kernel, B, d, stream, P, out, B, d);
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  switch (d) {
#define TAME_CASE(DD)                                                      \
  case DD:                                                                 \
    logdet_spd_kernel<DD><<<grid, block, 0, stream>>>(P, out, B);          \
    break;
    TAME_FOR_EACH_D(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
