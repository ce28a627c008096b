// K4 at column capacity 48 (even d from 34 to 48), in a compilation unit
// of its own so that its build runs beside fused_smoother.cu's.
#include "fused_smoother.cuh"

cudaError_t tame_fused_smoother_dc48(const float* D, const float* O,
                                     const float* b, float* mean, float* cov,
                                     float* cross, float* logdet, int n,
                                     int T, int d, cudaStream_t stream) {
  return launch_smoother<48>(D, O, b, mean, cov, cross, logdet, n, T, d,
                             stream);
}
