// K3 fused_fit: the whole damped-CAVI fit in one thread block, a lane
// group per (node, time) factor.
//
// Replaces tame/ops/fused_fit.py::_fused_fit_kernel, which lays every
// per-factor scalar out as an (n, T) plane and runs each step of the d x d
// Cholesky as one vector op across all factors.  It computes what that
// kernel computes: block-Gauss-Seidel phases with fresh global statistics,
// the natural parameter (corrected or not) with AR(1) prior coupling, the
// solve and inverse under the diag/full/block policy, exact (n^2, T)
// residual diagnostics, the ELBO with trace correction and log-determinant
// entropy, and the tolerance/patience/divergence rule.
//
// Bound: neither bytes nor operations.  A fit is a chain of dependent
// phases on one SM (the demo's 15-block fit: 15 phases per iteration of
// only bs T = 10 factors each), so its time is the latency of each phase's
// critical path times the phases.  The design shortens that path:
//
//   * a group of G lanes per factor (G = 4 for d = 4, 8 for d = 6, 8, 16
//     for d = 10, 12) in a 512-thread block, so 128, 64 or 32 factors run
//     at once.  Lane k
//     owns row k of the factor's precision, in registers; the lanes k >= d
//     pad the group to its width and never write, and every loop runs over
//     the d real rows and columns, so the padding leaves the results
//     exact;
//   * the group builds its rows from the global partner moments, splits
//     the partner contraction over j across its lanes (a reduce-scatter by
//     xor shuffles at the group's width leaves row k's sum in lane k) and
//     inverts by a Gauss-Jordan sweep
//     without pivoting (the precision is SPD): d steps, each one shuffle of
//     the pivot row and one row update per lane.  No step of any factor's
//     solve, inverse or log-determinant runs on one thread.  The entropy's
//     log-determinant is the sum of the log pivots of the same sweep on the
//     covariance, by its forward elimination alone;
//   * the diag policy keeps the right-hand side in the sweep (mu = P^-1 e);
//     full/block transpose the raw inverse through the factor's own rows of
//     X_cov (which the damped write-back then overwrites), symmetrize, add
//     the jitter and take mu = Sigma e;
//   * every global statistic is one (t, moment) sum over nodes of a product
//     of two entries of z = [1, V, U, c, dd], split over up to 8 lanes (as
//     many as let a phase's sums run in one pass) and reduced by shuffles,
//     with no branch on the statistic's kind; the block-wide ELBO sums end
//     in one warp's shuffle reduction;
//   * the means live time-major ((t, node) rows), so a group's reads over
//     partners j step through neighbouring rows.  W0 = p y0 + q y1, W1 = q
//     y0 + p y1 and y0, constants of the fit, are formed from Y in the
//     prologue and staged in shared memory as (T, n, n) planes when they
//     fit beside the state (y0 with the odd pitch n | 1, so the
//     diagnostics' transposed reads are conflict-free); otherwise they go
//     to time-major planes in the caller's device scratch, with y0's
//     transpose beside them, where a group's lanes read neighbouring
//     addresses.  The state rows get the odd pitch d + 1 when that fits
//     too, which makes the row-per-lane reads conflict-free.  The shape
//     decides at launch (choose_layout, mirrored in ops/fused_fit.py);
//   * per iteration 2 num_blocks + 3 barriers: a phase is (write back the
//     previous block's means + statistics) | update; then the last block's
//     write-back, the diagnostics, and the stop flag.  The update writes
//     the damped covariance in place and the damped means to a scratch, so
//     every factor of a phase sees the pre-phase means, as on the TPU;
//   * R^-1, Sigma0, Q and Phi are read as they are: the prologue inverts
//     Sigma0 and Q with the same group sweep (their log-determinants are
//     its pivots) and forms Q^-1 Phi and Phi' Q^-1 Phi on chip, so the host
//     computes nothing before the launch (the TPU kernel's SMEM scalars).
//     The stopping rule runs on thread 0; once it fires the loop ends, the
//     state is frozen and the history slots past the stop keep the NaN the
//     prologue wrote.
#include "chol.cuh"  // TAME_FOR_EACH_D
#include "kernels.h"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kReduce = 6;  // sq, cross, tr(cov), prior0, priort, logdet
constexpr int kRedFloats = kWarps * kReduce;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmemFloats = 232448 / sizeof(float);  // 227 KB
constexpr float kLog2Pi = 1.8378770664093453f;

__host__ __device__ constexpr int group_width(int d) {
  return d <= 4 ? 4 : (d <= 8 ? 8 : 16);
}
// Moments per time step: every pair a <= b of the d - 1 partner features
// g = [1, V, U], then the d corrected-update offsets (c, 1), (dd, 1),
// (c, V_k), (dd, U_k).  They are summed once per pair and stored as the
// full symmetric (d - 1) x (d - 1) matrix, then the offsets.
__host__ __device__ constexpr int num_pairs(int d) {
  return (d - 1) * d / 2 + d;
}
__host__ __device__ constexpr int moment_floats(int d) {
  return (d - 1) * (d - 1) + d;
}

// Float offsets of one fit's shared memory.  pad gives the means, the
// covariance rows and the four prior matrices the odd pitch d + 1 (Phi
// itself is read through the read-only cache); staged holds W0, W1
// (T, n, n) and y0 (T, n, n | 1).  The reduction partials overlay the
// phase scratch and the statistics, which are dead when they are written.
struct Layout {
  int MP, NP;
  size_t xm, xc, pri, scr, st, red, flag, w0, w1, y0, total;
};

__host__ __device__ inline Layout make_layout(int n, int T, int d, int nb,
                                              int pad, int staged) {
  Layout L;
  const size_t nT = static_cast<size_t>(n) * T;
  const size_t bsT = static_cast<size_t>(n / nb) * T;
  L.MP = d + pad;
  L.NP = n | 1;
  L.xm = 0;
  L.xc = L.xm + nT * L.MP;
  L.pri = L.xc + nT * d * L.MP;
  L.scr = L.pri + 4 * static_cast<size_t>(d) * L.MP;
  L.st = L.scr + bsT * L.MP;
  const size_t uni = bsT * L.MP + static_cast<size_t>(T) * moment_floats(d);
  L.red = L.scr;
  L.flag = L.scr + (uni > kRedFloats ? uni : kRedFloats);
  L.w0 = L.flag + 1;
  L.w1 = L.w0 + (staged ? nT * n : 0);
  L.y0 = L.w1 + (staged ? nT * n : 0);
  L.total = L.y0 + (staged ? nT * L.NP : 0);
  return L;
}

// bit 0: data staged, bit 1: padded pitch; the first of (pad + staged,
// staged, pad, neither) that fits, -1 if none does.
int choose_layout(int n, int T, int d, int nb) {
  if (n < 1 || T < 1 || nb < 1 || n % nb != 0) return -1;
  const int modes[4] = {3, 1, 2, 0};
  for (int mode : modes)
    if (make_layout(n, T, d, nb, mode >> 1, mode & 1).total <= kMaxSmemFloats)
      return mode;
  return -1;
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (Granlund and
// Montgomery's round-up method), for the runtime divisors of the flat loops.
struct FastDiv {
  unsigned m;
  int s, d;
  __device__ explicit FastDiv(int d_) : d(d_) {
    s = 0;
    while ((1 << s) < d) ++s;
    m = static_cast<unsigned>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int x) const {
    const unsigned u = static_cast<unsigned>(x);
    return static_cast<int>((__umulhi(u, m) + u) >> s);
  }
};

template <int D>
__device__ __forceinline__ float pick(const float (&v)[D], int k) {
  float out = v[0];
#pragma unroll
  for (int c = 1; c < D; ++c) out = k == c ? v[c] : out;
  return out;
}

// Moment s of the table above as two indices into z = [1, V, U, c, dd].
template <int D>
__device__ __forceinline__ void moment_pair(int s, int& za, int& zb) {
  constexpr int S = D - 1, R = (D - 2) / 2, TRI = S * (S + 1) / 2;
  int a = 0;
#pragma unroll
  for (int m = 1; m < S; ++m) a += s >= m * S - m * (m - 1) / 2;
  const int b = s - (a * S - a * (a - 1) / 2) + a;
  const int e = s - TRI;
  const bool with_c = e == 0 || (e >= 2 && e < 2 + R);
  za = s < TRI ? a : (with_c ? D - 1 : D);
  zb = s < TRI ? b : (e < 2 ? 0 : e - 1);
}

// Entry z of [1, V, U, c, dd] of a mean row x as al x[ia] + be x[ib] + ga:
// V_k is x[2 + R + k], U_k is x[2 + k], c = p b + q a, dd = q b + p a.
struct ZCoef {
  int ia, ib;
  float al, be, ga;
};

template <int D>
__device__ __forceinline__ ZCoef zcoef(int z, float p, float q) {
  constexpr int R = (D - 2) / 2;
  const bool lin = z == D - 1 || z == D;
  ZCoef c;
  c.ia = lin || z == 0 ? 1 : (z <= R ? R + 1 + z : z + 1 - R);
  c.ib = 0;
  c.al = z == 0 ? 0.f : (z == D - 1 ? p : (z == D ? q : 1.f));
  c.be = z == D - 1 ? q : (z == D ? p : 0.f);
  c.ga = z == 0 ? 1.f : 0.f;
  return c;
}

__device__ __forceinline__ float zval(const float* x, const ZCoef& c) {
  return fmaf(c.al, x[c.ia], fmaf(c.be, x[c.ib], c.ga));
}

// In-place Gauss-Jordan sweep of the SPD matrix whose rows the group's
// lanes hold (row k in lane k of each G-lane segment), with one
// right-hand side.  A pivot that is not positive becomes NaN, which makes
// every entry NaN.
template <int D, int G>
__device__ __forceinline__ void gauss_jordan(float (&a)[D], float& rhs,
                                             int k) {
#pragma unroll
  for (int m = 0; m < D; ++m) {
    float pr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) pr[j] = __shfl_sync(kFull, a[j], m, G);
    const float prh = __shfl_sync(kFull, rhs, m, G);
    float piv = pr[m];
    if (!(piv > 0.f)) piv = __int_as_float(0x7fc00000);
    const float inv = __fdividef(1.f, piv);
    // Other rows: a - g pr.  The pivot row holds pr itself, so g = 0 and a
    // scale by 1 / pivot give pr / pivot with no select per entry.
    const bool pivot_row = k == m;
    const float g = pivot_row ? 0.f : a[m] * inv;
    const float sc = pivot_row ? inv : 1.f;
#pragma unroll
    for (int j = 0; j < D; ++j) a[j] = fmaf(-g, pr[j], a[j]) * sc;
    a[m] = pivot_row ? inv : -g;
    rhs = fmaf(-g, prh, rhs) * sc;
  }
}

// Reduce-scatter over a G-lane group by xor shuffles: lane k returns the
// group's sum of v[k] (recursive halving: at each level a lane keeps one
// half of its values, sends the other and adds what its partner sent).
template <int G>
__device__ __forceinline__ float reduce_scatter(float (&v)[G], int k) {
#pragma unroll
  for (int h = G / 2; h >= 1; h >>= 1) {
    const bool upper = k & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[h + i];
      const float keep = upper ? v[h + i] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, h, G);
    }
  }
  return v[0];
}

// sum_k log(pivot_k) of the same sweep, by forward elimination alone: the
// pivots of the sweep depend only on the trailing columns of the rows not
// yet pivoted, so those are all it updates (half the sweep's work).  The
// logs are the hardware's (3 ulp): the entropy sums them over n T factors.
template <int D, int G>
__device__ __forceinline__ float sweep_logdet(float (&a)[D]) {
  float logdet = 0.f;
#pragma unroll
  for (int m = 0; m < D; ++m) {
    float piv = __shfl_sync(kFull, a[m], m, G);
    if (!(piv > 0.f)) piv = __int_as_float(0x7fc00000);
    logdet += __logf(piv);
    const float g = a[m] * __fdividef(1.f, piv);
#pragma unroll
    for (int j = m + 1; j < D; ++j)
      a[j] = fmaf(-g, __shfl_sync(kFull, a[j], m, G), a[j]);
  }
  return logdet;
}

template <int D>
__global__ void __launch_bounds__(kThreads) fused_fit_kernel(FusedFitArgs a) {
  constexpr int R = (D - 2) / 2;
  constexpr int G = group_width(D);
  constexpr int kGroups = kThreads / G;
  constexpr int S = D - 1;  // partner features g = [1, V, U]
  constexpr int TRI = S * (S + 1) / 2;
  constexpr int NPAIR = num_pairs(D);
  constexpr int NS = moment_floats(D);
  extern __shared__ float smem[];
  const int n = a.n, T = a.T, nT = n * T, nb = a.num_blocks, bs = n / nb;
  const int nTn = nT * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = tid % G, gid = tid / G;
  const int kk = k < D ? k : D - 1;  // the lane's row, clamped for addresses
  const bool row = k < D;
  const Layout L = make_layout(n, T, D, nb, a.pad, a.staged);
  const int MP = L.MP;
  float* Xm = smem + L.xm;   // (T, n) rows of pitch MP
  float* Xc = smem + L.xc;   // (n T, D) rows of pitch MP
  float* pri = smem + L.pri;  // Sigma0^-1, Q^-1, Q^-1 Phi, Phi'Q^-1 Phi
  float* scr = smem + L.scr;  // (T, bs) damped new means of a phase
  float* st = smem + L.st;    // (T, NS) moments over all nodes
  float* red = smem + L.red;
  float* flag = smem + L.flag;
  float* y0s = smem + L.y0;   // (T, n) rows of pitch NP, when staged
  const float* S0i = pri;
  const float* Qi = pri + D * MP;
  const float* QP = pri + 2 * D * MP;
  const float* PtQP = pri + 3 * D * MP;
  const float* W0 = a.staged ? smem + L.w0 : a.gdata;
  const float* W1 = a.staged ? smem + L.w1 : a.gdata + nTn;
  const float* y0g = a.gdata + 2 * static_cast<size_t>(nTn);
  const float* y0Tg = a.gdata + 3 * static_cast<size_t>(nTn);
  float* eh = a.hist;
  float* mh = a.hist + a.hist_len;
  float* stats = a.hist + 2 * a.hist_len;
  const float p = a.rinv[0], q = a.rinv[1];

  // ---- prologue: state and data on chip, priors from Sigma0, Q, Phi -----
  for (int e = tid; e < 2 * a.hist_len; e += kThreads)
    eh[e] = __int_as_float(0x7fc00000);
  for (int e = tid; e < nT * D; e += kThreads) {
    const int i = e / (T * D), t = (e / D) % T, c = e % D;
    Xm[(t * n + i) * MP + c] = a.Xm0[e];
  }
  for (int e = tid; e < nT * D * D; e += kThreads)
    Xc[(e / D) * MP + e % D] = a.Xc0[e];
  for (int e = tid; e < nTn; e += kThreads) {
    const int t = e / (n * n), i = (e / n) % n, j = e % n;
    const float* y = a.Y + ((static_cast<size_t>(i) * n + j) * T + t) * 2;
    const float y0 = y[0], y1 = y[1];
    const float w0 = p * y0 + q * y1, w1 = q * y0 + p * y1;
    if (a.staged) {
      smem[L.w0 + e] = w0;
      smem[L.w1 + e] = w1;
      y0s[(t * n + i) * L.NP + j] = y0;
    } else {
      a.gdata[e] = w0;
      a.gdata[nTn + e] = w1;
      a.gdata[2 * static_cast<size_t>(nTn) + e] = y0;
      a.gdata[3 * static_cast<size_t>(nTn) + (t * n + j) * n + i] = y0;
    }
  }
  float ldS0 = 0.f, ldQ = 0.f;  // meaningful on thread 0
  if (warp == 0) {
    float s0[D], qi[D], acc[D], dummy = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      acc[c] = s0[c] = a.Sigma0[kk * D + c];
      qi[c] = a.Q[kk * D + c];
    }
    ldS0 = sweep_logdet<D, G>(acc);
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = qi[c];
    ldQ = sweep_logdet<D, G>(acc);
    gauss_jordan<D, G>(s0, dummy, k);
    gauss_jordan<D, G>(qi, dummy, k);
    if (gid == 0 && row)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        pri[kk * MP + c] = s0[c];
        pri[(D + kk) * MP + c] = qi[c];
      }
#pragma unroll
    for (int c = 0; c < D; ++c) {  // Q^-1 Phi
      float v = 0.f;
#pragma unroll
      for (int m = 0; m < D; ++m) v = fmaf(qi[m], a.Phi[m * D + c], v);
      acc[c] = v;
    }
    if (gid == 0 && row)
#pragma unroll
      for (int c = 0; c < D; ++c) pri[(2 * D + kk) * MP + c] = acc[c];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < D; ++c) {  // Phi' (Q^-1 Phi)
      float v = 0.f;
#pragma unroll
      for (int m = 0; m < D; ++m)
        v = fmaf(a.Phi[m * D + kk], QP[m * MP + c], v);
      acc[c] = v;
    }
    if (gid == 0 && row)
#pragma unroll
      for (int c = 0; c < D; ++c) pri[(3 * D + kk) * MP + c] = acc[c];
  }
  __syncthreads();
  // Sigma0^-1, Q^-1 and Phi'Q^-1 Phi as their lower triangles mirrored.
  for (int e = tid; e < 3 * D * D; e += kThreads) {
    const int m = e / (D * D), r = (e / D) % D, c = e % D;
    float* P = pri + (m == 2 ? 3 : m) * D * MP;
    if (r < c) P[r * MP + c] = P[c * MP + r];
  }
  float prev = a.carry_elbo;  // stopping-rule state, live on thread 0
  int pat = a.carry_pat, n_done = 0;
  bool conv = false, div = false;
  if (tid == 0) *flag = 1.f;
  __syncthreads();

  const float lr = a.lr, keep = 1.f - a.lr;
  const int np = a.corrected ? NPAIR : TRI;
  const FastDiv divT(T), divN(n), divNN(n * n), divNP(np), divBsD(bs * D);
  // Lanes per (t, moment) sum over nodes: the most (up to 8) with which
  // every sum of a phase runs in one pass of the block.
  int sl_log = 0;
  while (sl_log < 3 && (T * np) << (sl_log + 1) <= kThreads) ++sl_log;
  const int sl = 1 << sl_log;
  for (int it = 0; it < a.max_iter; ++it) {
    if (*flag == 0.f) break;  // uniform: written before a barrier

    for (int blk = 0; blk <= nb; ++blk) {
      // 1. Write back the previous block's damped means; statistics.  The
      // moments read the previous block's rows from the scratch, the
      // others from X_mean.
      const int pstart = (blk - 1) * bs, pbs = blk == 0 ? 0 : bs;
      for (int e = tid; e < pbs * T * D; e += kThreads) {
        const int t = divBsD.div(e), rem = e - t * bs * D;
        const int ii = rem / D, c = rem - ii * D;
        Xm[(t * n + pstart + ii) * MP + c] = scr[(t * bs + ii) * MP + c];
      }
      if (blk == nb) break;  // the last block is written back; diagnostics
      for (int base = 0; base < T * np * sl; base += kThreads) {
        const int item = (base + tid) >> sl_log, l = tid & (sl - 1);
        const bool act = item < T * np;
        const int t = act ? divNP.div(item) : 0, s = act ? item - t * np : 0;
        int za, zb;
        moment_pair<D>(s, za, zb);
        const ZCoef ca = zcoef<D>(za, p, q), cb = zcoef<D>(zb, p, q);
        float acc = 0.f;
        for (int j = l; j < n; j += sl) {
          const bool fresh = static_cast<unsigned>(j - pstart) <
                             static_cast<unsigned>(pbs);
          const float* x = fresh ? scr + (t * bs + j - pstart) * MP
                                 : Xm + (t * n + j) * MP;
          acc = fmaf(zval(x, ca), zval(x, cb), acc);
        }
        for (int off = sl >> 1; off > 0; off >>= 1)
          acc += __shfl_xor_sync(kFull, acc, off, sl);
        if (act && l == 0) {
          float* sm = st + t * NS;
          if (s < TRI) {
            sm[za * S + zb] = acc;
            sm[zb * S + za] = acc;
          } else {
            sm[S * S + s - TRI] = acc;
          }
        }
      }
      __syncthreads();

      // 2. Closed-form update of the block's factors, one group each.
      const int start = blk * bs;
      for (int f0 = 0; f0 < bs * T; f0 += kGroups) {
        if (f0 + warp * (32 / G) >= bs * T) break;  // the warp's groups idle
        const bool act = f0 + gid < bs * T;
        const int fb = act ? f0 + gid : bs * T - 1;
        const int ii = divT.div(fb), t = fb - ii * T, i = start + ii;
        const int f = i * T + t;
        const float* x = Xm + (t * n + i) * MP;
        float xi[D], gi[S];
#pragma unroll
        for (int c = 0; c < D; ++c) xi[c] = x[c];
        gi[0] = 1.f;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          gi[1 + m] = xi[2 + R + m];
          gi[1 + R + m] = xi[2 + m];
        }
        // Row kk of the precision: observation part from the moments minus
        // the node's own term, p within a kind (a and U rows pair with the
        // partners' forward features, b and V rows with the backward ones),
        // q across; plus the prior.
        const float* sm = st + t * NS;
        const int sk = kk < 2 ? 0 : kk - 1;
        const bool fk = kk == 0 || (kk >= 2 && kk < 2 + R);
        const float gk = pick<S>(gi, sk);
        const float at0 = t == 0 ? 1.f : 0.f, after0 = t > 0 ? 1.f : 0.f;
        const float before_last = t < T - 1 ? 1.f : 0.f;
        float A[D];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int sc = c < 2 ? 0 : c - 1;
          const bool fc = c == 0 || (c >= 2 && c < 2 + R);
          const float obs =
              (fk == fc ? p : q) * (sm[sk * S + sc] - gk * gi[sc]);
          const float pr =
              fmaf(before_last, PtQP[kk * MP + c],
                   fmaf(after0, Qi[kk * MP + c], at0 * S0i[kk * MP + c]));
          A[c] = obs + pr;
        }
        // Natural parameter: the partner contraction split over j across
        // the group's lanes, each lane's partial sums of every row (W0 and
        // W1's row sums, W0 V, W1 U; rows past d zero), then a
        // reduce-scatter that leaves row k's sum in lane k.
        float part[G];
#pragma unroll
        for (int r = 0; r < G; ++r) part[r] = 0.f;
        const float* w0 = W0 + static_cast<size_t>(t * n + i) * n;
        const float* w1 = W1 + static_cast<size_t>(t * n + i) * n;
#pragma unroll 4
        for (int j = k; j < n; j += G) {
          const float w0j = w0[j], w1j = w1[j];
          const float* xj = Xm + (t * n + j) * MP;
          part[0] += w0j;
          part[1] += w1j;
#pragma unroll
          for (int m = 0; m < R; ++m) {
            part[2 + m] = fmaf(w0j, xj[2 + R + m], part[2 + m]);
            part[2 + R + m] = fmaf(w1j, xj[2 + m], part[2 + R + m]);
          }
        }
        float e = reduce_scatter<G>(part, k);
        if (a.corrected) {
          const float ci = p * xi[1] + q * xi[0];
          const float di = q * xi[1] + p * xi[0];
          e -= sm[S * S + kk] - (fk ? ci : di) * (kk < 2 ? 1.f : gk);
        }
        // AR(1) coupling to the pre-update neighbours in time.
        const float* xp = Xm + ((t > 0 ? t - 1 : t) * n + i) * MP;
        const float* xn = Xm + ((t < T - 1 ? t + 1 : t) * n + i) * MP;
        float accp = 0.f, accn = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          accp += xp[j] * QP[kk * MP + j];
          accn += xn[j] * QP[j * MP + kk];
        }
        float pe = t > 0 ? accp : 0.f;
        pe = t < T - 1 ? pe + accn : pe;
        e += pe;

        // Solve under the covariance-structure policy (cavi._SOLVERS).
        const float pd = pick<D>(A, kk);
        float mu = e;
        gauss_jordan<D, G>(A, mu, k);
        float* crow = Xc + static_cast<size_t>(f * D + kk) * MP;
        float old[D], fin[D];
#pragma unroll
        for (int c = 0; c < D; ++c) old[c] = crow[c];
        if (a.structure == 0) {
#pragma unroll
          for (int c = 0; c < D; ++c) fin[c] = c == kk ? 1.f / (pd + 1e-8f) : 0.f;
        } else {
          // The raw inverse's transpose, through the factor's own rows.
          __syncwarp();
          if (act && row)
#pragma unroll
            for (int c = 0; c < D; ++c) crow[c] = A[c];
          __syncwarp();
#pragma unroll
          for (int c = 0; c < D; ++c)
            fin[c] = Xc[static_cast<size_t>(f * D + c) * MP + kk];
          __syncwarp();
          mu = 0.f;
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const bool cross = (kk < 2) != (c < 2);
            float v = (a.structure == 2 && cross) ? 0.f
                                                  : 0.5f * (A[c] + fin[c]);
            if (c == kk) v += 1e-6f;
            fin[c] = v;
            mu = fmaf(v, __shfl_sync(kFull, e, c, G), mu);
          }
        }
        if (act && row) {
#pragma unroll
          for (int c = 0; c < D; ++c) crow[c] = lr * fin[c] + keep * old[c];
          scr[(t * bs + ii) * MP + kk] = lr * mu + keep * pick<D>(xi, kk);
        }
      }
      __syncthreads();
    }
    __syncthreads();  // the last block's means are in X_mean

    // 3. Exact diagnostics: dyadic residuals over (t, i, j), j fastest.
    float v[kReduce] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int e = tid; e < nTn; e += kThreads) {
      const int t = divNN.div(e), rem = e - t * n * n;
      const int i = divN.div(rem), j = rem - i * n;
      const float* xi = Xm + (t * n + i) * MP;
      const float* xj = Xm + (t * n + j) * MP;
      float uij = 0.f, uji = 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        uij += xi[2 + m] * xj[2 + R + m];
        uji += xj[2 + m] * xi[2 + R + m];
      }
      const float y = a.staged ? y0s[(t * n + i) * L.NP + j] : y0g[e];
      const float yT = a.staged ? y0s[(t * n + j) * L.NP + i] : y0Tg[e];
      const float r0 = y - ((xi[0] + xj[1]) + uij);
      const float r1 = yT - ((xj[0] + xi[1]) + uji);
      v[0] = i != j ? fmaf(r0, r0, v[0]) : v[0];
      v[1] = i != j ? fmaf(r0, r1, v[1]) : v[1];
    }
    // Per-factor ELBO terms, one group each: lane kk adds row kk's share.
    for (int f0 = 0; f0 < nT; f0 += kGroups) {
      if (f0 + warp * (32 / G) >= nT) break;  // the warp's groups idle
      const bool act = f0 + gid < nT;
      const int f = act ? f0 + gid : nT - 1;
      const int i = divT.div(f), t = f - i * T;
      const float* x = Xm + (t * n + i) * MP;
      const float* xp = Xm + ((t > 0 ? t - 1 : t) * n + i) * MP;
      const float* C = Xc + static_cast<size_t>(f) * D * MP;
      float xv[D], Ck[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        xv[c] = x[c];
        Ck[c] = C[kk * MP + c];
      }
      const float xk = pick<D>(xv, kk);
      float res = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) res += xp[j] * __ldg(a.Phi + kk * D + j);
      res = xk - res;
      const float* Pm = t == 0 ? S0i : Qi;
      float quad = 0.f, trace = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float rc = __shfl_sync(kFull, res, c, G);
        quad += Pm[kk * MP + c] * (t == 0 ? xv[c] : rc);
        trace += Pm[kk * MP + c] * C[c * MP + kk];
      }
      quad *= t == 0 ? xk : res;
      const float tr = pick<D>(Ck, kk);
      const float ld = sweep_logdet<D, G>(Ck);
      if (act && row) {
        v[2] += tr;
        if (t == 0)
          v[3] += quad + trace;
        else
          v[4] += quad + trace;
        if (k == 0) v[5] += ld;
      }
    }
    // Block sums: each warp's shuffles, then one warp over the partials.
#pragma unroll
    for (int m = 0; m < kReduce; ++m)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[m] += __shfl_xor_sync(kFull, v[m], off);
    if (lane == 0)
#pragma unroll
      for (int m = 0; m < kReduce; ++m) red[warp * kReduce + m] = v[m];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int m = 0; m < kReduce; ++m) {
        v[m] = lane < kWarps ? red[lane * kReduce + m] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v[m] += __shfl_xor_sync(kFull, v[m], off);
      }
    }
    if (tid == 0) {
      const float sq = v[0], cross = v[1];
      const float n_dyads = static_cast<float>(n * (n - 1) / 2 * T);
      const float det_rinv = a.rinv[0] * a.rinv[3] - a.rinv[1] * a.rinv[2];
      const float logdet_R = -logf(fabsf(det_rinv));
      float log_lik =
          -0.5f * ((p * sq + q * cross) + n_dyads * (logdet_R + 2.f * kLog2Pi));
      if (a.structure != 0) {
        const float tr_rinv = a.rinv[0] + a.rinv[3];
        const float corr = 0.1f * tr_rinv / static_cast<float>(D) *
                           (static_cast<float>(n - 1) * v[2]);
        log_lik -= 0.5f * corr;
      }
      const float prior0 = -0.5f * (v[3] + n * (ldS0 + D * kLog2Pi));
      const float priort = -0.5f * (v[4] + n * (T - 1) * (ldQ + D * kLog2Pi));
      const float entropy = 0.5f * (v[5] + nT * D * (1.f + kLog2Pi));
      const float elbo = log_lik + prior0 + priort + entropy;
      const float mse = 2.f * sq / static_cast<float>(n * (n - 1) * T);
      eh[it] = elbo;
      mh[it] = mse;
      // Tolerance x patience rule (cavi._fit_cavi_impl): a finite previous
      // ELBO is the "have a previous evaluation" signal.
      const float rel = fabsf(elbo - prev) / (fabsf(prev) + 1e-8f);
      const bool small = isfinite(prev) && rel < a.tol;
      pat = small ? pat + 1 : 0;
      conv = pat >= a.patience;
      div = !isfinite(elbo);
      prev = elbo;
      ++n_done;
      *flag = (conv || div) ? 0.f : 1.f;
    }
    __syncthreads();
  }

  for (int e = tid; e < nT * D; e += kThreads) {
    const int i = e / (T * D), t = (e / D) % T, c = e % D;
    a.Xm[e] = Xm[(t * n + i) * MP + c];
  }
  for (int e = tid; e < nT * D * D; e += kThreads)
    a.Xc[e] = Xc[(e / D) * MP + e % D];
  if (tid == 0) {
    stats[0] = static_cast<float>(n_done);
    stats[1] = conv ? 1.f : 0.f;
    stats[2] = div ? 1.f : 0.f;
    stats[3] = static_cast<float>(pat);
    stats[4] = prev;
  }
}

template <int D>
cudaError_t launch(FusedFitArgs a, int mode, cudaStream_t stream) {
  a.pad = mode >> 1;
  a.staged = mode & 1;
  const size_t smem =
      make_layout(a.n, a.T, D, a.num_blocks, a.pad, a.staged).total *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fit_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_fit_kernel<D><<<1, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

int tame_fused_fit_layout(int n, int T, int d, int num_blocks) {
  return choose_layout(n, T, d, num_blocks);
}

size_t tame_fused_fit_smem_bytes(int n, int T, int d, int num_blocks) {
  const int mode = choose_layout(n, T, d, num_blocks);
  if (mode < 0) return 0;
  return make_layout(n, T, d, num_blocks, mode >> 1, mode & 1).total *
         sizeof(float);
}

cudaError_t tame_fused_fit(const FusedFitArgs& a, int d, cudaStream_t stream) {
  const int mode = choose_layout(a.n, a.T, d, a.num_blocks);
  if (mode < 0) return cudaErrorInvalidValue;
  if (!(mode & 1) && a.gdata == nullptr) return cudaErrorInvalidValue;
  switch (d) {
#define TAME_CASE(DD) \
  case DD:            \
    return launch<DD>(a, mode, stream);
    TAME_FOR_EACH_D(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
