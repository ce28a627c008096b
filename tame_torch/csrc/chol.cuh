// Cholesky of one small SPD system held by one thread.
//
// The device-side copy of the d x d factorization that the JAX package
// writes in Pallas for K1-K3 (tame/ops/cholesky.py _chol_solve_inv_kernel
// and _logdet_kernel, tame/ops/fused_fit.py _plane_chol_solve and
// _plane_logdet); K4 inverts by a warp-wide Gauss-Jordan sweep instead.  With
// D a template constant every loop unrolls, so the factor lives in
// registers.  Arithmetic order follows the JAX kernels step for step.
//
// The JAX kernels unroll at trace time for any d.  Unrolled CUDA code grows
// as d^3, so the sizes r = 1..5 are instantiated and every other even d up
// to kMaxRuntimeD runs the runtime-d copy below (same arithmetic order,
// loops not unrolled, the factor in shared memory through an accessor).
#pragma once

#include <math.h>

// Instantiated sizes: d = 2 + 2r for r = 1..5.
#define TAME_FOR_EACH_D(X) X(4) X(6) X(8) X(10) X(12)

// Largest d of the runtime-d variants (K1, K2) and of K4; even d only.
constexpr int kMaxRuntimeD = 48;

__host__ __device__ inline bool tame_unrolled_d(int d) {
#define TAME_IS_D(DD) d == DD ||
  return TAME_FOR_EACH_D(TAME_IS_D) false;
#undef TAME_IS_D
}

__host__ __device__ inline bool tame_runtime_d(int d) {
  return d >= 4 && d <= kMaxRuntimeD && d % 2 == 0 && !tame_unrolled_d(d);
}

// In place: on entry the lower triangle of A holds P, on exit it holds the
// lower factor L (P = L L').  The upper triangle is never read.  Returns
// log det P = sum_k log(L_kk^2); a non-SPD system gives NaN.
template <int D>
__device__ __forceinline__ float chol_factor(float (&A)[D][D],
                                             float (&inv_diag)[D]) {
  float logdet = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float acc = A[k][k];
#pragma unroll
    for (int m = 0; m < k; ++m) acc -= A[k][m] * A[k][m];
    logdet += logf(acc);
    const float lkk = sqrtf(acc);
    A[k][k] = lkk;
    inv_diag[k] = 1.f / lkk;
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      float a2 = A[i][k];
#pragma unroll
      for (int m = 0; m < k; ++m) a2 -= A[i][m] * A[k][m];
      A[i][k] = a2 * inv_diag[k];
    }
  }
  return logdet;
}

// x = (L L')^-1 rhs by forward then backward substitution.
template <int D>
__device__ __forceinline__ void chol_solve(const float (&L)[D][D],
                                           const float (&inv_diag)[D],
                                           const float (&rhs)[D],
                                           float (&x)[D]) {
  float y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = rhs[i];
#pragma unroll
    for (int m = 0; m < i; ++m) acc -= L[i][m] * y[m];
    y[i] = acc * inv_diag[i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int m = i + 1; m < D; ++m) acc -= L[m][i] * x[m];
    x[i] = acc * inv_diag[i];
  }
}

// Column j of P^-1 (the solve against the unit vector e_j).
template <int D>
__device__ __forceinline__ void chol_inverse_column(const float (&L)[D][D],
                                                    const float (&inv_diag)[D],
                                                    int j, float (&col)[D]) {
  float e[D];
#pragma unroll
  for (int i = 0; i < D; ++i) e[i] = (i == j) ? 1.f : 0.f;
  chol_solve<D>(L, inv_diag, e, col);
}

// ---- runtime d ------------------------------------------------------------
// Accessors into shared memory.  PackedLower keeps one thread's lower
// triangle, element (i, j <= i) at p[(i (i + 1) / 2 + j) * stride]: with the
// stride equal to the threads of a block, neighbouring threads hit
// neighbouring banks.  StridedVec is a vector with a stride.
struct PackedLower {
  float* p;
  int stride;
  __device__ float& operator()(int i, int j) const {
    return p[(i * (i + 1) / 2 + j) * stride];
  }
};

struct StridedVec {
  float* p;
  int stride;
  __device__ float& operator[](int i) const { return p[i * stride]; }
};

// chol_factor<D> for a runtime d: in place on the lower triangle of A.
template <class Mat, class Vec>
__device__ float chol_factor_rt(const Mat& A, const Vec& inv_diag, int d) {
  float logdet = 0.f;
  for (int k = 0; k < d; ++k) {
    float acc = A(k, k);
    for (int m = 0; m < k; ++m) acc -= A(k, m) * A(k, m);
    logdet += logf(acc);
    const float lkk = sqrtf(acc);
    A(k, k) = lkk;
    inv_diag[k] = 1.f / lkk;
    for (int i = k + 1; i < d; ++i) {
      float a2 = A(i, k);
      for (int m = 0; m < k; ++m) a2 -= A(i, m) * A(k, m);
      A(i, k) = a2 * inv_diag[k];
    }
  }
  return logdet;
}

// chol_solve<D> for a runtime d, in place: x holds the right-hand side on
// entry and (L L')^-1 rhs on exit (the forward pass overwrites x[i] with
// y[i] after its last read, the backward pass y[i] with x[i]).
template <class Mat, class Vec, class XVec>
__device__ void chol_solve_rt(const Mat& L, const Vec& inv_diag, const XVec& x,
                              int d) {
  for (int i = 0; i < d; ++i) {
    float acc = x[i];
    for (int m = 0; m < i; ++m) acc -= L(i, m) * x[m];
    x[i] = acc * inv_diag[i];
  }
  for (int i = d - 1; i >= 0; --i) {
    float acc = x[i];
    for (int m = i + 1; m < d; ++m) acc -= L(m, i) * x[m];
    x[i] = acc * inv_diag[i];
  }
}

// Column j of P^-1 for a runtime d, written into col.
template <class Mat, class Vec, class XVec>
__device__ void chol_inverse_column_rt(const Mat& L, const Vec& inv_diag,
                                       int j, const XVec& col, int d) {
  for (int i = 0; i < d; ++i) col[i] = (i == j) ? 1.f : 0.f;
  chol_solve_rt(L, inv_diag, col, d);
}
