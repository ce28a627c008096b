// PyTorch binding of the port's CUDA kernels: the only file that includes
// torch/extension.h.  Checks each tensor, launches on PyTorch's current
// stream and raises on any CUDA error the launcher reports.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <algorithm>
#include <limits>
#include <tuple>

#include "kernels.h"

namespace {

constexpr size_t kMaxSmemBytes = 232448;  // 227 KB per block on sm_90

void check(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void check_launch(cudaError_t err, const char* what) {
  TORCH_CHECK(err == cudaSuccess, what, " failed: ", cudaGetErrorString(err));
}

std::tuple<torch::Tensor, torch::Tensor> spd_solve_inv(torch::Tensor P,
                                                       torch::Tensor eta,
                                                       bool with_inverse) {
  check(P, "P");
  check(eta, "eta");
  TORCH_CHECK(P.dim() == 3 && P.size(1) == P.size(2), "P must be (B, d, d)");
  TORCH_CHECK(eta.dim() == 2 && eta.size(0) == P.size(0) &&
                  eta.size(1) == P.size(1),
              "eta must be (B, d)");
  TORCH_CHECK(P.size(0) <= std::numeric_limits<int>::max(), "batch too large");
  const c10::cuda::CUDAGuard guard(P.device());
  const int B = static_cast<int>(P.size(0)), d = static_cast<int>(P.size(1));
  auto mu = torch::empty({B, d}, P.options());
  torch::Tensor cov;
  if (with_inverse) cov = torch::empty({B, d, d}, P.options());
  check_launch(
      tame_spd_solve_inv(P.data_ptr<float>(), eta.data_ptr<float>(),
                         mu.data_ptr<float>(),
                         with_inverse ? cov.data_ptr<float>() : nullptr, B, d,
                         at::cuda::getCurrentCUDAStream()),
      "spd_solve_inv");
  return {mu, cov};
}

torch::Tensor logdet_spd(torch::Tensor P) {
  check(P, "P");
  TORCH_CHECK(P.dim() == 3 && P.size(1) == P.size(2), "P must be (B, d, d)");
  TORCH_CHECK(P.size(0) <= std::numeric_limits<int>::max(), "batch too large");
  const c10::cuda::CUDAGuard guard(P.device());
  const int B = static_cast<int>(P.size(0)), d = static_cast<int>(P.size(1));
  auto out = torch::empty({B}, P.options());
  check_launch(tame_logdet_spd(P.data_ptr<float>(), out.data_ptr<float>(), B,
                               d, at::cuda::getCurrentCUDAStream()),
               "logdet_spd");
  return out;
}

std::tuple<int64_t, int64_t, int64_t> spd_geometry(int64_t d,
                                                   bool narrow) {
  const SpdGeometry g = tame_spd_geometry(static_cast<int>(d), narrow);
  return {g.capacity, g.group, g.systems};
}

std::tuple<int64_t, int64_t> fused_fit_layout(int64_t n, int64_t T,
                                              int64_t d, int64_t num_blocks) {
  const int n_ = static_cast<int>(n), T_ = static_cast<int>(T),
            d_ = static_cast<int>(d), nb = static_cast<int>(num_blocks);
  return {tame_fused_fit_layout(n_, T_, d_, nb),
          static_cast<int64_t>(tame_fused_fit_smem_bytes(n_, T_, d_, nb))};
}

void fused_fit(torch::Tensor Y, torch::Tensor rinv, torch::Tensor Sigma0,
               torch::Tensor Q, torch::Tensor Phi, torch::Tensor Xm0,
               torch::Tensor Xc0, torch::Tensor Xm, torch::Tensor Xc,
               torch::Tensor hist, torch::Tensor gdata, int64_t num_blocks,
               int64_t max_iter, int64_t carry_pat, int64_t patience,
               int64_t structure, bool corrected, double lr, double tol,
               double carry_elbo) {
  for (auto* t : {&Y, &rinv, &Sigma0, &Q, &Phi, &Xm0, &Xc0, &Xm, &Xc, &hist,
                  &gdata})
    check(*t, "fused_fit input");
  TORCH_CHECK(Xm0.dim() == 3, "X_mean must be (n, T, d)");
  const int n = static_cast<int>(Xm0.size(0)), T = static_cast<int>(Xm0.size(1)),
            d = static_cast<int>(Xm0.size(2));
  TORCH_CHECK(Y.dim() == 4 && Y.size(0) == n && Y.size(1) == n &&
                  Y.size(2) == T && Y.size(3) == 2,
              "Y must be (n, n, T, 2)");
  TORCH_CHECK(rinv.numel() == 4, "R_inv must be (2, 2)");
  TORCH_CHECK(Sigma0.numel() == d * d && Q.numel() == d * d &&
                  Phi.numel() == d * d,
              "Sigma0, Q, Phi must be (d, d)");
  TORCH_CHECK(Xc0.numel() == static_cast<int64_t>(n) * T * d * d &&
                  Xm.sizes() == Xm0.sizes() && Xc.sizes() == Xc0.sizes(),
              "X_cov must be (n, T, d, d)");
  TORCH_CHECK(num_blocks >= 1 && n % num_blocks == 0,
              "num_blocks must divide n");
  TORCH_CHECK(hist.numel() >= 2 * max_iter + 5 && hist.numel() % 2 == 1,
              "hist must hold two histories of at least max_iter slots and "
              "5 stats");
  TORCH_CHECK(structure >= 0 && structure <= 2, "bad structure code");
  const int mode = tame_fused_fit_layout(n, T, d, static_cast<int>(num_blocks));
  TORCH_CHECK(mode >= 0, "fused fit at n=", n, " T=", T, " d=", d,
              " needs more than the ", kMaxSmemBytes,
              " bytes of shared memory a block may use");
  TORCH_CHECK((mode & 1) || gdata.numel() >= 4 * static_cast<int64_t>(T) * n * n,
              "this shape reads its data from device memory: gdata must hold "
              "4 T n n floats");
  const c10::cuda::CUDAGuard guard(Y.device());
  FusedFitArgs a;
  a.Y = Y.data_ptr<float>();
  a.rinv = rinv.data_ptr<float>();
  a.Sigma0 = Sigma0.data_ptr<float>();
  a.Q = Q.data_ptr<float>();
  a.Phi = Phi.data_ptr<float>();
  a.Xm0 = Xm0.data_ptr<float>();
  a.Xc0 = Xc0.data_ptr<float>();
  a.Xm = Xm.data_ptr<float>();
  a.Xc = Xc.data_ptr<float>();
  a.hist = hist.data_ptr<float>();
  a.gdata = gdata.numel() ? gdata.data_ptr<float>() : nullptr;
  a.n = n;
  a.T = T;
  a.num_blocks = static_cast<int>(num_blocks);
  a.max_iter = static_cast<int>(max_iter);
  a.hist_len = static_cast<int>((hist.numel() - 5) / 2);
  a.carry_pat = static_cast<int>(carry_pat);
  a.patience = static_cast<int>(patience);
  a.structure = static_cast<int>(structure);
  a.corrected = corrected ? 1 : 0;
  a.pad = a.staged = 0;
  a.lr = static_cast<float>(lr);
  a.tol = static_cast<float>(tol);
  a.carry_elbo = static_cast<float>(carry_elbo);
  check_launch(tame_fused_fit(a, d, at::cuda::getCurrentCUDAStream()),
               "fused_fit");
}

std::tuple<torch::Tensor, torch::Tensor, torch::Tensor, torch::Tensor>
fused_smoother(torch::Tensor D, torch::Tensor O, torch::Tensor b) {
  check(D, "D");
  check(O, "O");
  check(b, "b");
  TORCH_CHECK(D.dim() == 4 && D.size(2) == D.size(3),
              "D must be (n, T, d, d)");
  TORCH_CHECK(D.size(0) <= std::numeric_limits<int>::max(),
              "batch too large");
  const int n = static_cast<int>(D.size(0)), T = static_cast<int>(D.size(1)),
            d = static_cast<int>(D.size(2));
  TORCH_CHECK(T >= 1, "the fused smoother needs T >= 1");
  TORCH_CHECK(O.dim() == 2 && O.size(0) == d && O.size(1) == d,
              "O must be (d, d)");
  TORCH_CHECK(b.dim() == 3 && b.size(0) == n && b.size(1) == T &&
                  b.size(2) == d,
              "b must be (n, T, d)");
  const c10::cuda::CUDAGuard guard(D.device());
  auto mean = torch::empty({n, T, d}, D.options());
  auto cov = torch::empty({n, T, d, d}, D.options());
  auto cross = torch::empty({n, T - 1, d, d}, D.options());
  auto logdet = torch::empty({n}, D.options());
  check_launch(tame_fused_smoother(D.data_ptr<float>(), O.data_ptr<float>(),
                                   b.data_ptr<float>(), mean.data_ptr<float>(),
                                   cov.data_ptr<float>(),
                                   cross.data_ptr<float>(),
                                   logdet.data_ptr<float>(), n, T, d,
                                   at::cuda::getCurrentCUDAStream()),
               "fused_smoother");
  return {mean, cov, cross, logdet};
}

int64_t fused_smoother_smem_bytes(int64_t d, int64_t warps) {
  return static_cast<int64_t>(tame_fused_smoother_smem_bytes(
      static_cast<int>(d), static_cast<int>(warps)));
}

int64_t fused_smoother_warps(int64_t n, int64_t d) {
  TORCH_CHECK(n <= std::numeric_limits<int>::max(), "batch too large");
  return tame_fused_smoother_warps(static_cast<int>(n), static_cast<int>(d));
}

torch::Tensor masked_contract(torch::Tensor M, torch::Tensor Z) {
  TORCH_CHECK(M.is_cuda() && M.scalar_type() == torch::kInt8 &&
                  M.is_contiguous() && M.dim() == 3,
              "M must be a contiguous (T, bs_pad, n_pad) int8 CUDA tensor");
  check(Z, "Z");
  TORCH_CHECK(Z.dim() == 3 && Z.size(1) == M.size(0), "Z must be (n, T, K)");
  TORCH_CHECK(M.numel() <= std::numeric_limits<int>::max() &&
                  Z.numel() <= std::numeric_limits<int>::max(),
              "inputs too large");
  const int T = static_cast<int>(M.size(0)),
            bs_pad = static_cast<int>(M.size(1)),
            n_pad = static_cast<int>(M.size(2)),
            n = static_cast<int>(Z.size(0)), K = static_cast<int>(Z.size(2));
  TORCH_CHECK(n <= n_pad && n_pad % 16 == 0,
              "n_pad must be a multiple of 16 and at least n");
  TORCH_CHECK(static_cast<int64_t>(T) * ((K + 63) / 64) <= 65535,
              "masked_contract takes T * ceil(K / 64) <= 65535");
  const c10::cuda::CUDAGuard guard(M.device());
  auto out = torch::empty({bs_pad, T, K}, Z.options());
  check_launch(tame_masked_contract(M.data_ptr<int8_t>(), Z.data_ptr<float>(),
                                    out.data_ptr<float>(), T, bs_pad, n_pad,
                                    n, K, at::cuda::getCurrentCUDAStream()),
               "masked_contract");
  return out;
}

void dual_contract(torch::Tensor W, torch::Tensor Z, torch::Tensor row,
                   torch::Tensor col, int64_t k0) {
  TORCH_CHECK(W.is_cuda() && W.scalar_type() == torch::kBFloat16 &&
                  W.is_contiguous() && W.dim() == 3,
              "W must be a contiguous (T, n, cols_pad) bf16 CUDA tensor");
  check(Z, "Z");
  check(row, "row");
  check(col, "col");
  TORCH_CHECK(Z.dim() == 3 && Z.size(0) == W.size(0) && Z.size(1) == W.size(1),
              "Z must be (T, n, m)");
  TORCH_CHECK(row.sizes() == Z.sizes() && col.sizes() == Z.sizes(),
              "row and col must be (T, n, m)");
  TORCH_CHECK(W.numel() <= std::numeric_limits<int>::max() &&
                  Z.numel() <= std::numeric_limits<int>::max(),
              "inputs too large");
  const int T = static_cast<int>(W.size(0)), n = static_cast<int>(W.size(1)),
            cols_pad = static_cast<int>(W.size(2)),
            m = static_cast<int>(Z.size(2));
  TORCH_CHECK(cols_pad >= n && cols_pad % 8 == 0,
              "cols_pad must be a multiple of 8 and at least n");
  TORCH_CHECK(T <= 65535, "dual_contract takes T <= 65535");
  TORCH_CHECK(k0 >= 0 && k0 < m, "k0 must index a column of Z");
  const int width = static_cast<int>(std::min<int64_t>(16, m - k0));
  TORCH_CHECK(tame_dual_contract_smem_bytes(n, width) <= kMaxSmemBytes,
              "dual_contract at n=", n, " needs more than the ", kMaxSmemBytes,
              " bytes of shared memory a block may use");
  const c10::cuda::CUDAGuard guard(W.device());
  check_launch(tame_dual_contract(W.data_ptr(), Z.data_ptr<float>(),
                                  row.data_ptr<float>(), col.data_ptr<float>(),
                                  T, n, cols_pad, m, static_cast<int>(k0),
                                  at::cuda::getCurrentCUDAStream()),
               "dual_contract");
}

int64_t dual_contract_smem_bytes(int64_t n, int64_t width) {
  TORCH_CHECK(n <= std::numeric_limits<int>::max(), "n too large");
  return static_cast<int64_t>(tame_dual_contract_smem_bytes(
      static_cast<int>(n), static_cast<int>(width)));
}

torch::Tensor eta_contract(torch::Tensor W, torch::Tensor Z) {
  TORCH_CHECK(W.is_cuda() && W.dim() == 3 &&
                  (W.scalar_type() == torch::kBFloat16 ||
                   W.scalar_type() == torch::kFloat32) &&
                  (W.stride(2) == 1 || W.size(2) <= 1),
              "W must be a (T, m, n) bf16 or float32 CUDA tensor with its "
              "partners at unit stride");
  TORCH_CHECK(Z.is_cuda() && Z.scalar_type() == torch::kFloat32 &&
                  Z.device() == W.device(),
              "Z must be a float32 tensor on W's device");
  TORCH_CHECK(Z.dim() == 3 && Z.size(0) == W.size(2) && Z.size(1) == W.size(0),
              "Z must be (n, T, R)");
  TORCH_CHECK(Z.size(2) >= 1 && Z.size(2) <= 92,
              "eta_contract is built for 1 <= R <= 92");
  TORCH_CHECK(W.size(0) <= std::numeric_limits<int>::max() &&
                  W.size(1) <= std::numeric_limits<int>::max() &&
                  W.size(2) <= std::numeric_limits<int>::max(),
              "W too large");
  const int T = static_cast<int>(W.size(0)), m = static_cast<int>(W.size(1)),
            n = static_cast<int>(W.size(2)), R = static_cast<int>(Z.size(2));
  const c10::cuda::CUDAGuard guard(W.device());
  auto out = torch::empty({m, T, R}, Z.options());
  check_launch(
      tame_eta_contract(W.data_ptr(), W.scalar_type() == torch::kBFloat16,
                        W.stride(0), W.stride(1), Z.data_ptr<float>(),
                        Z.stride(0), Z.stride(1), Z.stride(2),
                        out.data_ptr<float>(), T, m, n, R,
                        at::cuda::getCurrentDeviceProperties()
                            ->multiProcessorCount,
                        at::cuda::getCurrentCUDAStream()),
      "eta_contract");
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fused_smoother", &fused_smoother,
        "K4: batched block-tridiagonal forward-backward smoother");
  m.def("fused_smoother_smem_bytes", &fused_smoother_smem_bytes,
        "shared memory of one K4 block of `warps` nodes at state dimension d");
  m.def("fused_smoother_warps", &fused_smoother_warps,
        "nodes per K4 block for n trajectories at state dimension d");
  m.def("spd_solve_inv", &spd_solve_inv, "K1: batched SPD solve (+ inverse)");
  m.def("logdet_spd", &logdet_spd, "K2: batched SPD log-determinant");
  m.def("spd_geometry", &spd_geometry,
        "(capacity, lanes per system, systems per block) at d of K1 with "
        "the inverse (narrow false) or of K1 without it and K2 past d = 12");
  m.def("fused_fit", &fused_fit, "K3: whole CAVI fit in one thread block");
  m.def("fused_fit_layout", &fused_fit_layout,
        "(layout, shared-memory bytes) of a K3 fit at (n, T, d, num_blocks)");
  m.def("masked_contract", &masked_contract,
        "K5: int8 mask stripe @ bf16-rounded feature panel");
  m.def("dual_contract", &dual_contract,
        "K6: columns k0 .. k0 + 15 of W @ Z and W' @ Z into row and col, "
        "from one pass over bf16 data");
  m.def("dual_contract_smem_bytes", &dual_contract_smem_bytes,
        "shared memory of one K6 block at n for a slice of `width` columns");
  m.def("eta_contract", &eta_contract,
        "K7: out[i, t] = sum_j W[t, i, j] Z[j, t] over time-major bf16 or "
        "float32 weights (Z rounded to bf16 for bf16 weights), f32 sums");
}
