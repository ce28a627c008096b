// PyTorch binding of the port's CUDA kernels: the only file that includes
// torch/extension.h.  Checks each tensor, launches on PyTorch's current
// stream and raises on any CUDA error the launcher reports.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

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

int64_t fused_fit_smem_bytes(int64_t n, int64_t T, int64_t d,
                             int64_t num_blocks) {
  return static_cast<int64_t>(tame_fused_fit_smem_bytes(
      static_cast<int>(n), static_cast<int>(T), static_cast<int>(d),
      static_cast<int>(num_blocks)));
}

void fused_fit(torch::Tensor W0, torch::Tensor W1, torch::Tensor eta_a,
               torch::Tensor eta_b, torch::Tensor y0, torch::Tensor Xm0,
               torch::Tensor Xc0, torch::Tensor pri, torch::Tensor Xm,
               torch::Tensor Xc, torch::Tensor eh, torch::Tensor mh,
               torch::Tensor stats, int64_t num_blocks, int64_t max_iter,
               int64_t carry_pat, int64_t patience, int64_t structure,
               bool corrected, double lr, double tol, double p, double q,
               double tr_rinv, double logdet_R, double logdet_S0,
               double logdet_Q, double carry_elbo) {
  for (auto* t : {&W0, &W1, &eta_a, &eta_b, &y0, &Xm0, &Xc0, &pri, &Xm, &Xc,
                  &eh, &mh, &stats})
    check(*t, "fused_fit input");
  TORCH_CHECK(Xm0.dim() == 3, "X_mean must be (n, T, d)");
  const int n = static_cast<int>(Xm0.size(0)), T = static_cast<int>(Xm0.size(1)),
            d = static_cast<int>(Xm0.size(2));
  TORCH_CHECK(W0.dim() == 3 && W0.size(0) == n && W0.size(1) == n &&
                  W0.size(2) == T && W1.sizes() == W0.sizes() &&
                  y0.sizes() == W0.sizes(),
              "W0, W1, y0 must be (n, n, T)");
  TORCH_CHECK(eta_a.numel() == n * T && eta_b.numel() == n * T,
              "eta_a, eta_b must be (n, T)");
  TORCH_CHECK(Xc0.numel() == static_cast<int64_t>(n) * T * d * d &&
                  Xm.sizes() == Xm0.sizes() && Xc.sizes() == Xc0.sizes(),
              "X_cov must be (n, T, d, d)");
  TORCH_CHECK(pri.numel() == 5 * d * d, "pri must be (5, d, d)");
  TORCH_CHECK(num_blocks >= 1 && n % num_blocks == 0,
              "num_blocks must divide n");
  TORCH_CHECK(eh.numel() >= max_iter && mh.numel() >= max_iter,
              "history buffers shorter than max_iter");
  TORCH_CHECK(stats.numel() == 5, "stats must hold 5 values");
  TORCH_CHECK(structure >= 0 && structure <= 2, "bad structure code");
  const size_t smem = tame_fused_fit_smem_bytes(n, T, d, num_blocks);
  TORCH_CHECK(smem <= kMaxSmemBytes, "fused fit needs ", smem,
              " bytes of shared memory, more than the ", kMaxSmemBytes,
              " a block may use");
  const c10::cuda::CUDAGuard guard(W0.device());
  FusedFitArgs a;
  a.W0 = W0.data_ptr<float>();
  a.W1 = W1.data_ptr<float>();
  a.eta_a = eta_a.data_ptr<float>();
  a.eta_b = eta_b.data_ptr<float>();
  a.y0 = y0.data_ptr<float>();
  a.Xm0 = Xm0.data_ptr<float>();
  a.Xc0 = Xc0.data_ptr<float>();
  a.pri = pri.data_ptr<float>();
  a.Xm = Xm.data_ptr<float>();
  a.Xc = Xc.data_ptr<float>();
  a.eh = eh.data_ptr<float>();
  a.mh = mh.data_ptr<float>();
  a.stats = stats.data_ptr<float>();
  a.n = n;
  a.T = T;
  a.num_blocks = static_cast<int>(num_blocks);
  a.max_iter = static_cast<int>(max_iter);
  a.carry_pat = static_cast<int>(carry_pat);
  a.patience = static_cast<int>(patience);
  a.structure = static_cast<int>(structure);
  a.corrected = corrected ? 1 : 0;
  a.lr = static_cast<float>(lr);
  a.tol = static_cast<float>(tol);
  a.p = static_cast<float>(p);
  a.q = static_cast<float>(q);
  a.tr_rinv = static_cast<float>(tr_rinv);
  a.logdet_R = static_cast<float>(logdet_R);
  a.logdet_S0 = static_cast<float>(logdet_S0);
  a.logdet_Q = static_cast<float>(logdet_Q);
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

int64_t fused_smoother_smem_bytes(int64_t d) {
  return static_cast<int64_t>(
      tame_fused_smoother_smem_bytes(static_cast<int>(d)));
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
  const c10::cuda::CUDAGuard guard(M.device());
  auto out = torch::empty({bs_pad, T, K}, Z.options());
  check_launch(tame_masked_contract(M.data_ptr<int8_t>(), Z.data_ptr<float>(),
                                    out.data_ptr<float>(), T, bs_pad, n_pad,
                                    n, K, at::cuda::getCurrentCUDAStream()),
               "masked_contract");
  return out;
}

std::tuple<torch::Tensor, torch::Tensor> dual_contract(torch::Tensor W,
                                                       torch::Tensor Z) {
  TORCH_CHECK(W.is_cuda() && W.scalar_type() == torch::kBFloat16 &&
                  W.is_contiguous() && W.dim() == 3,
              "W must be a contiguous (T, n, cols_pad) bf16 CUDA tensor");
  check(Z, "Z");
  TORCH_CHECK(Z.dim() == 3 && Z.size(0) == W.size(0) && Z.size(1) == W.size(1),
              "Z must be (T, n, m)");
  TORCH_CHECK(W.numel() <= std::numeric_limits<int>::max(), "W too large");
  const int T = static_cast<int>(W.size(0)), n = static_cast<int>(W.size(1)),
            cols_pad = static_cast<int>(W.size(2)),
            m = static_cast<int>(Z.size(2));
  TORCH_CHECK(cols_pad >= n && cols_pad % 8 == 0,
              "cols_pad must be a multiple of 8 and at least n");
  TORCH_CHECK(m <= 16, "dual_contract is built for m <= 16");
  const c10::cuda::CUDAGuard guard(W.device());
  auto row = torch::empty({T, n, m}, Z.options());
  auto col = torch::zeros({T, n, m}, Z.options());
  check_launch(tame_dual_contract(W.data_ptr(), Z.data_ptr<float>(),
                                  row.data_ptr<float>(), col.data_ptr<float>(),
                                  T, n, cols_pad, m,
                                  at::cuda::getCurrentCUDAStream()),
               "dual_contract");
  return {row, col};
}

torch::Tensor eta_contract(torch::Tensor W, torch::Tensor Z) {
  TORCH_CHECK(W.is_cuda() && W.scalar_type() == torch::kBFloat16 &&
                  W.is_contiguous() && W.dim() == 3 && W.size(1) == W.size(2),
              "W must be a contiguous (T, N, N) bf16 CUDA tensor");
  check(Z, "Z");
  TORCH_CHECK(Z.dim() == 3 && Z.size(0) == W.size(0) && Z.size(1) == W.size(1),
              "Z must be (T, N, R)");
  TORCH_CHECK(Z.size(2) >= 1 && Z.size(2) <= 16,
              "eta_contract is built for 1 <= R <= 16");
  TORCH_CHECK(W.size(0) <= std::numeric_limits<int>::max() &&
                  W.size(1) <= std::numeric_limits<int>::max(),
              "W too large");
  const int T = static_cast<int>(W.size(0)), N = static_cast<int>(W.size(1)),
            R = static_cast<int>(Z.size(2));
  const c10::cuda::CUDAGuard guard(W.device());
  auto out = torch::empty({T, N, R}, Z.options());
  check_launch(tame_eta_contract(W.data_ptr(), Z.data_ptr<float>(),
                                 out.data_ptr<float>(), T, N, R,
                                 at::cuda::getCurrentCUDAStream()),
               "eta_contract");
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fused_smoother", &fused_smoother,
        "K4: batched block-tridiagonal forward-backward smoother");
  m.def("fused_smoother_smem_bytes", &fused_smoother_smem_bytes,
        "shared memory of one K4 block for state dimension d");
  m.def("spd_solve_inv", &spd_solve_inv, "K1: batched SPD solve (+ inverse)");
  m.def("logdet_spd", &logdet_spd, "K2: batched SPD log-determinant");
  m.def("fused_fit", &fused_fit, "K3: whole CAVI fit in one thread block");
  m.def("fused_fit_smem_bytes", &fused_fit_smem_bytes,
        "shared memory K3 needs for (n, T, d, num_blocks)");
  m.def("masked_contract", &masked_contract,
        "K5: int8 mask stripe @ bf16-rounded feature panel");
  m.def("dual_contract", &dual_contract,
        "K6: W @ Z and W' @ Z from one pass over bf16 data");
  m.def("eta_contract", &eta_contract,
        "K7: per-step W @ bf16(Z) over bf16 (T, N, N) weights, f32 sums");
}
