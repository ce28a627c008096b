// K4's kernel and launcher templates, shared by the compilation units
// that instantiate them: fused_smoother.cu (every column capacity but the
// widest) and fused_smoother_48.cu (DC = 48, whose unrolled loops are the
// slowest to compile; apart, it compiles beside the rest).  The design is
// described in fused_smoother.cu.
#pragma once

#include "chol.cuh"
#include "kernels.h"

namespace {

constexpr int kMaxWarps = 4;             // nodes per block
constexpr int kSmSpread = 132;           // SMs of an H100 SXM
constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB per block on sm_90
constexpr unsigned kFull = 0xffffffffu;

// Column capacity of d: exact up to 16, then 24, 32, 48.
__host__ __device__ constexpr int smoother_capacity(int d) {
  return d <= 16 ? d : (d <= 24 ? 24 : (d <= 32 ? 32 : 48));
}
// Row pitch at capacity c: the least p >= c with p % 8 == 4.
__host__ __device__ constexpr int smoother_pitch(int c) {
  return (c + 3) / 8 * 8 + 4;
}
// A vector's floats at capacity c: c rounded up to 4.
__host__ __device__ constexpr int smoother_vec(int c) { return (c + 3) / 4 * 4; }

// Floats of one block at capacity c: O and O' (c x pitch each), then per
// warp four c x pitch matrices (A, G', the two input buffers) and five
// vectors (c_t, mu, rhs, the two vector buffers).
__host__ __device__ constexpr int smoother_mat_floats(int c) {
  return c * smoother_pitch(c);
}
__host__ __device__ constexpr int smoother_warp_floats(int c) {
  return 4 * smoother_mat_floats(c) + 5 * smoother_vec(c);
}
__host__ __device__ inline size_t smoother_smem(int d, int warps) {
  const int c = smoother_capacity(d);
  return sizeof(float) *
         (2 * smoother_mat_floats(c) + warps * smoother_warp_floats(c));
}

// Nodes per block: one per block while n <= 132 (each node on its own SM),
// then up to four, as shared memory allows.
inline int smoother_warps(int n, int d) {
  int w = (n + kSmSpread - 1) / kSmSpread;
  w = w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
  while (w > 1 && smoother_smem(d, w) > kMaxSmemBytes) --w;
  return w;
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Fetch the dense d x d block src into the top-left of a slab matrix of
// pitch P, and a d-vector, two floats a copy (d is even), coalesced.
__device__ __forceinline__ void fetch_mat(float* dst, const float* src, int d,
                                          int P, int lane) {
  for (int e = 2 * lane; e < d * d; e += 64)
    cp_async8(dst + (e / d) * P + e % d, src + e);
}
__device__ __forceinline__ void fetch_vec(float* dst, const float* src, int d,
                                          int lane) {
  for (int e = 2 * lane; e < d; e += 64) cp_async8(dst + e, src + e);
}

// Store the lane's row (its first d entries) to dst, two floats at a time
// (d is even, so every row starts 8-byte aligned).
template <int DC>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[DC],
                                          int d, float sign) {
#pragma unroll
  for (int j = 0; j < DC; j += 2)
    if (j < d)
      *reinterpret_cast<float2*>(dst + j) = make_float2(sign * v[j],
                                                        sign * v[j + 1]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// out[r][j] += sum_k a[r][k] B[k][j]: a is the lane's own rows in
// registers, B's rows are read as 16-byte broadcasts.
template <int DC, int R>
__device__ __forceinline__ void row_product_add(const float (&a)[R][DC],
                                                const float* B,
                                                float (&out)[R][DC]) {
  constexpr int P = smoother_pitch(DC);
#pragma unroll
  for (int k = 0; k < DC; ++k)
#pragma unroll
    for (int q = 0; q < DC; q += 4) {
      const float4 bv = ld4(B + k * P + q);
      const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q + u < DC) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            out[r][q + u] = fmaf(a[r][k], bq[u], out[r][q + u]);
        }
    }
}

template <int DC, int R>
__device__ __forceinline__ void row_product(const float (&a)[R][DC],
                                            const float* B,
                                            float (&out)[R][DC]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < DC; ++j) out[r][j] = 0.f;
  row_product_add<DC, R>(a, B, out);
}

// sum_k a[r][k] x[k] with x read in 16-byte broadcasts.
template <int DC, int R>
__device__ __forceinline__ float row_dot(const float (&a)[R][DC], int r,
                                         const float* x) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < DC; q += 4) {
    const float4 xv = ld4(x + q);
    const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (q + u < DC) acc = fmaf(a[r][q + u], xq[u], acc);
  }
  return acc;
}

// The lane's own rows of a slab matrix in 16-byte loads (zeros for a row
// past the capacity).
template <int DC, int R>
__device__ __forceinline__ void load_rows(const float* src, int lane,
                                          float (&a)[R][DC]) {
  constexpr int P = smoother_pitch(DC);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
#pragma unroll
    for (int q = 0; q < DC; q += 4) {
      const float4 v = i < DC ? ld4(src + i * P + q)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float vq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q + u < DC) a[r][q + u] = vq[u];
    }
  }
}

template <int DC, int R>
__device__ __forceinline__ void store_rows(float* dst, int lane,
                                           const float (&a)[R][DC]) {
  constexpr int P = smoother_pitch(DC);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (lane + 32 * r < DC) {
#pragma unroll
      for (int j = 0; j < DC; ++j) dst[(lane + 32 * r) * P + j] = a[r][j];
    }
}

// The transpose: column i of dst gets the lane's row i (for a fixed j the
// lanes write consecutive floats).
template <int DC, int R>
__device__ __forceinline__ void store_cols(float* dst, int lane,
                                           const float (&a)[R][DC]) {
  constexpr int P = smoother_pitch(DC);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (lane + 32 * r < DC) {
#pragma unroll
      for (int j = 0; j < DC; ++j) dst[j * P + lane + 32 * r] = a[r][j];
    }
}

// In-place Gauss-Jordan inverse of the SPD matrix whose rows the lanes
// hold in a (row k in lane k % 32, slot k / 32); returns sum_k
// log(pivot_k).  A pivot that is not positive becomes NaN, which makes
// every entry NaN.
template <int DC, int R>
__device__ __forceinline__ float gauss_jordan(float (&a)[R][DC], int lane) {
  float logdet = 0.f;
#pragma unroll
  for (int k = 0; k < DC; ++k) {
    float pr[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) pr[j] = __shfl_sync(kFull, a[k / 32][j], k % 32);
    float piv = pr[k];
    if (!(piv > 0.f)) piv = __int_as_float(0x7fc00000);
    logdet += logf(piv);
    const float inv = __frcp_rn(piv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool pivot_row = lane + 32 * r == k;
      const float g = a[r][k] * inv;
#pragma unroll
      for (int j = 0; j < DC; ++j)
        a[r][j] = pivot_row ? pr[j] * inv : fmaf(-g, pr[j], a[r][j]);
      a[r][k] = pivot_row ? inv : -g;
    }
  }
  return logdet;
}

template <int DC>
__global__ void __launch_bounds__(32 * kMaxWarps)
fused_smoother_kernel(const float* __restrict__ Dm, const float* __restrict__ O,
                      const float* __restrict__ b, float* __restrict__ mean,
                      float* __restrict__ cov, float* __restrict__ cross,
                      float* __restrict__ logdet_out, int n, int T, int d) {
  constexpr int R = (DC + 31) / 32;
  constexpr int P = smoother_pitch(DC), mat = smoother_mat_floats(DC);
  constexpr int V = smoother_vec(DC);
  extern __shared__ __align__(16) float smem_k4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dd = d * d;
  float* sO = smem_k4;   // O, zero-padded
  float* sOt = sO + mat;  // O'
  for (int e = threadIdx.x; e < mat; e += blockDim.x) {
    const int i = e / P, j = e % P;
    sO[e] = (i < d && j < d) ? O[i * d + j] : 0.f;
    sOt[e] = (i < d && j < d) ? O[j * d + i] : 0.f;
  }
  float* A = sOt + mat + warp * smoother_warp_floats(DC);  // S_t^-1; Sig
  float* Gt = A + mat;         // G_t' (backward)
  float* buf = Gt + mat;       // two matrices: D_t or parked S_t^-1
  float* c = buf + 2 * mat;    // c_t
  float* mu = c + V;           // mu_{t+1}, then mu_t
  float* rhs = mu + V;         // c_t - O mu_{t+1}
  float* vbuf = rhs + V;       // two vectors: b_t or parked c_t
  // The slab starts at zero and the input buffers' padding at the
  // identity; the fetches fill only the top-left d x d block.
  for (int e = lane; e < smoother_warp_floats(DC); e += 32) A[e] = 0.f;
  __syncwarp();
  for (int i = d + lane; i < DC; i += 32) {
    buf[i * P + i] = 1.f;
    buf[mat + i * P + i] = 1.f;
  }
  __syncthreads();  // once, before any node's t loop

  const size_t node = static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (node >= static_cast<size_t>(n)) return;
  const float* Dn = Dm + node * T * dd;
  const float* bn = b + node * T * d;
  float* mn = mean + node * T * d;
  float* cn = cov + node * T * dd;
  float* xn = cross + node * (T - 1) * dd;
  float s[R][DC], m[R][DC];  // the lane's rows of the working matrices
  float logdet = 0.f;

  // ---- forward elimination: S_t^-1 -> cov[t], c_t -> mean[t] ----------
  fetch_mat(buf, Dn, d, P, lane);
  fetch_vec(vbuf, bn, d, lane);
  cp_async_commit();
  for (int t = 0; t < T; ++t) {
    const int sel = t & 1;
    if (t + 1 < T) {  // fetch step t + 1's inputs while step t computes
      fetch_mat(buf + (sel ^ 1) * mat, Dn + static_cast<size_t>(t + 1) * dd,
                d, P, lane);
      fetch_vec(vbuf + (sel ^ 1) * V, bn + static_cast<size_t>(t + 1) * d,
                d, lane);
    }
    cp_async_commit();
    cp_async_wait_one();  // step t's inputs have landed
    __syncwarp();
    const float* Dt = buf + sel * mat;
    const float* bt = vbuf + sel * V;
    float cv[R];
    load_rows<DC, R>(Dt, lane, s);
    if (t == 0) {  // S_0 = D_0, c_0 = b_0
#pragma unroll
      for (int r = 0; r < R; ++r)
        cv[r] = lane + 32 * r < DC ? bt[lane + 32 * r] : 0.f;
    } else {
      // M = O' S_{t-1}^-1;  c_t = b_t - M c_{t-1};  S_t = D_t - M O
      float ot[R][DC];
      load_rows<DC, R>(sOt, lane, ot);
      row_product<DC, R>(ot, A, m);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        cv[r] = i < DC ? bt[i] - row_dot<DC, R>(m, r, c) : 0.f;
#pragma unroll
        for (int j = 0; j < DC; ++j) s[r][j] = -s[r][j];
      }
      row_product_add<DC, R>(m, sO, s);  // M O - D_t, accumulated on -D_t
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < DC; ++j) s[r][j] = -s[r][j];
    }
    __syncwarp();  // every lane has read S_{t-1}^-1 and c_{t-1}
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i < DC) c[i] = cv[r];
      if (i < d) mn[static_cast<size_t>(t) * d + i] = cv[r];
    }
    logdet += gauss_jordan<DC, R>(s, lane);
    store_rows<DC, R>(A, lane, s);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + 32 * r < d)
        store_row<DC>(cn + static_cast<size_t>(t) * dd + (lane + 32 * r) * d,
                      s[r], d, 1.f);
  }

  // ---- backward substitution (overwrites mean/cov in reverse) ----------
  // t = T-1: mu = S^-1 c, Sig = S^-1 (in A and already in cov[T-1]).
  if (T >= 2) {  // the parked S_{T-2}^-1 and c_{T-2}
    fetch_mat(buf, cn + static_cast<size_t>(T - 2) * dd, d, P, lane);
    fetch_vec(vbuf, mn + static_cast<size_t>(T - 2) * d, d, lane);
  }
  cp_async_commit();
  __syncwarp();  // c_{T-1} is complete
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    const float v = row_dot<DC, R>(s, r, c);
    if (i < DC) mu[i] = v;
    if (i < d) mn[static_cast<size_t>(T - 1) * d + i] = v;
  }
  for (int t = T - 2; t >= 0; --t) {
    const int sel = (T - 2 - t) & 1;
    if (t >= 1) {  // fetch step t - 1's parked inputs
      fetch_mat(buf + (sel ^ 1) * mat, cn + static_cast<size_t>(t - 1) * dd,
                d, P, lane);
      fetch_vec(vbuf + (sel ^ 1) * V, mn + static_cast<size_t>(t - 1) * d,
                d, lane);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncwarp();  // S_t^-1, c_t, Sig_{t+1} and mu_{t+1} are in place
    const float* ct = vbuf + sel * V;
    load_rows<DC, R>(buf + sel * mat, lane, s);  // S_t^-1
    // rhs = c_t - O mu_{t+1};  G = S_t^-1 O, kept as G'
    {
      float o[R][DC];
      load_rows<DC, R>(sO, lane, o);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        const float v = row_dot<DC, R>(o, r, mu);
        if (i < DC) rhs[i] = ct[i] - v;
      }
    }
    row_product<DC, R>(s, sO, m);
    store_cols<DC, R>(Gt, lane, m);
    __syncwarp();  // rhs and G' are complete
    // mu_t = S_t^-1 rhs;  GS = G Sig_{t+1};  Sig_t = S_t^-1 + GS G'
    float mv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mv[r] = row_dot<DC, R>(s, r, rhs);
    float gs[R][DC];
    row_product<DC, R>(m, A, gs);
    row_product_add<DC, R>(gs, Gt, s);
    __syncwarp();  // every lane is done with Sig_{t+1}, mu_{t+1} and G'
    store_rows<DC, R>(A, lane, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i < DC) mu[i] = mv[r];
      if (i < d) {
        mn[static_cast<size_t>(t) * d + i] = mv[r];
        store_row<DC>(cn + static_cast<size_t>(t) * dd + i * d, s[r], d, 1.f);
        store_row<DC>(xn + static_cast<size_t>(t) * dd + i * d, gs[r], d,
                      -1.f);
      }
    }
  }
  if (lane == 0) logdet_out[node] = logdet;
}

// The column capacities instantiated in fused_smoother.cu; the widest, 48,
// is fused_smoother_48.cu's (tame_fused_smoother_dc48), so the two compile
// in parallel.
#define TAME_FOR_EACH_NARROW_DC(X) \
  X(4) X(6) X(8) X(10) X(12) X(14) X(16) X(24) X(32)

inline bool smoother_supported_d(int d) {
  return d >= 4 && d <= kMaxRuntimeD && d % 2 == 0;
}

template <int DC>
cudaError_t launch_smoother(const float* D, const float* O, const float* b,
                            float* mean, float* cov, float* cross,
                            float* logdet, int n, int T, int d,
                            cudaStream_t stream) {
  const int warps = smoother_warps(n, d);
  const size_t smem = smoother_smem(d, warps);
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_smoother_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + warps - 1) / warps;
  fused_smoother_kernel<DC><<<blocks, 32 * warps, smem, stream>>>(
      D, O, b, mean, cov, cross, logdet, n, T, d);
  return cudaGetLastError();
}

}  // namespace

// DC = 48, instantiated in fused_smoother_48.cu.
cudaError_t tame_fused_smoother_dc48(const float* D, const float* O,
                                     const float* b, float* mean, float* cov,
                                     float* cross, float* logdet, int n,
                                     int T, int d, cudaStream_t stream);
