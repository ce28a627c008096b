// K4 fused_smoother: the batched block-tridiagonal forward-backward
// smoother, one warp per node trajectory.
//
// Replaces tame/ops/fused_smoother.py::_smoother_kernel, which puts 128
// nodes on the TPU's lanes and walks T with every d x d entry a vector
// plane.  On the card each node is a chain of T dependent forward steps
// and T - 1 backward steps; the bytes, (3 d^2 + 2 d) * 4 B per node-step,
// are far below what the memory system streams in that time, so the
// latency of the chain is the bound.  The design shortens the chain:
//
//   * one warp per node: lane i owns row i of every d x d matrix (rows i
//     and i + 32 for 32 < d <= 48); several nodes share a block when n is
//     large (smoother_warps), one node per block when n is about the
//     number of SMs, so the nodes spread over the most SMs;
//   * every loop runs to the column capacity DC, a compile-time constant
//     (exact d up to 16, then 24, 32, 48), so it unrolls and the loads
//     of a product issue together instead of one latency per k; for
//     d < DC the matrices are padded (O and b with zeros, D with the
//     identity), which leaves the d x d blocks and logdet unchanged;
//   * the matrices other lanes read live in a per-warp slab of shared
//     memory, read in 16-byte loads: another row's four entries are one
//     broadcast load, the lane's own row four entries a load.  The row
//     pitch P is the least multiple of 4 >= DC with P / 4 odd (not the odd
//     pitch a scalar layout would take, which breaks 16-byte alignment):
//     the 8 lanes of each quarter-warp phase of an own-row load then hit
//     8 different 16-byte bank groups, so those loads are conflict-free
//     too.  G_t is kept transposed so that GS G' also reads rows.  O and
//     O' are shared by the block's warps;
//   * each product computes the lane's output row with its accumulators
//     in registers (float32 FMAs on the CUDA cores: TF32 would keep three
//     digits, and the work is d^3 per step);
//   * S_t^-1 comes from an in-place Gauss-Jordan sweep without pivoting
//     (S_t is SPD) on the rows in registers: d pivot steps, each one
//     shuffle of the pivot row from its lane and one row update per lane,
//     with no step on a single thread.  The
//     pivots are Cholesky's L_kk^2, so logdet += sum_k log(pivot_k); a
//     pivot that is <= 0 or NaN becomes NaN, which makes that node's
//     outputs NaN (the twin's _cholesky_nan) and leaves the others alone;
//   * the next step's inputs are fetched ahead with cp.async into a second
//     buffer: D_{t+1} and b_{t+1} in the forward pass, the parked S_{t-1}^-1
//     and c_{t-1} in the backward pass, so no step waits on device memory;
//   * the t loop holds no __syncthreads, only __syncwarp.
//
// Memory trick kept from the TPU kernel: the forward pass writes S_t^-1
// into `cov` and c_t into `mean`; the backward pass reads them back and
// overwrites them in reverse order, so there is no device scratch.
//
// One kernel covers every even d from 4 to kMaxRuntimeD (48), templated on
// the column capacity DC >= d; the templates are in fused_smoother.cuh.
#include "fused_smoother.cuh"

size_t tame_fused_smoother_smem_bytes(int d, int warps) {
  if (!smoother_supported_d(d) || warps < 1 || warps > kMaxWarps) return 0;
  return smoother_smem(d, warps);
}

int tame_fused_smoother_warps(int n, int d) {
  return smoother_supported_d(d) ? smoother_warps(n, d) : 0;
}

cudaError_t tame_fused_smoother(const float* D, const float* O, const float* b,
                                float* mean, float* cov, float* cross,
                                float* logdet, int n, int T, int d,
                                cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (T < 1 || !smoother_supported_d(d)) return cudaErrorInvalidValue;
  switch (smoother_capacity(d)) {
#define TAME_CASE(DC)                                                       \
  case DC:                                                                  \
    return launch_smoother<DC>(D, O, b, mean, cov, cross, logdet, n, T, d, \
                               stream);
    TAME_FOR_EACH_NARROW_DC(TAME_CASE)
#undef TAME_CASE
    case 48:
      return tame_fused_smoother_dc48(D, O, b, mean, cov, cross, logdet, n, T,
                                      d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
