// Unrolled Cholesky of one small SPD system held by one thread.
//
// The single device-side copy of the d x d factorization that the JAX
// package writes five times in Pallas (tame/ops/cholesky.py
// _chol_solve_inv_kernel and _logdet_kernel, tame/ops/fused_fit.py
// _plane_chol_solve and _plane_logdet, tame/ops/fused_smoother.py).  With
// D a template constant every loop unrolls, so the factor lives in
// registers.  Arithmetic order follows the JAX kernels step for step.
#pragma once

#include <math.h>

// Instantiated sizes: d = 2 + 2r for r = 1..5.
#define TAME_FOR_EACH_D(X) X(4) X(6) X(8) X(10) X(12)

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
