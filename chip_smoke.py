#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. build the port's CUDA kernels (K1 spd_solve_inv, K2 logdet_spd,
   K3 fused_fit, K4 fused_smoother) from ``tame_torch/csrc`` into
   ``build/tame_torch``;
2. compare each kernel with its plain PyTorch twin on the same CUDA
   inputs, at the shapes the main paths give it, and time both with CUDA
   events (median of several runs);
3. the demo drive: ``TemporalAMEModel(15, 10, 2, seed=42)`` data from a
   CPU generator (the same ``Y`` as the CPU tests) moved to the card, then
   the Naive, Good and Bad engines at lr=0.7 for 150 iterations, which
   run through K3;
4. a real-size Good-SMF fit at n=2000, T=50, r=4 (data generated on the
   card) through the default engine path — 16-block updates with exact
   diagnostics — which runs through K1 and K2;
5. a real-size smoothed fit at n=2000, T=50, r=4 from the warm init
   (``TemporalAMESmoothedVI``, 16-block updates), one K4 launch per block
   phase;
6. variational EM at n=2000, T=50, r=4 from a wrong start (the setting of
   ``scripts/em_scale_probe.py`` in exact float32), whose E-steps run
   through K4.

Each of phases 3-6 is a path of its own: the launch counters are zeroed
just before it and read just after, and each path must have launched its
kernels.  The second-to-last line is a JSON object describing each kernel
(``launches`` summed over the paths), the last is the device record.
Needs one CUDA card; without one it exits non-zero before printing any
result.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# (name, source, TPU kernel it replaces)
KERNELS = {
    "spd_solve_inv": ("tame_torch/csrc/spd.cu", "tame/ops/cholesky.py:32"),
    "logdet_spd": ("tame_torch/csrc/spd.cu", "tame/ops/cholesky.py:184"),
    "fused_fit": ("tame_torch/csrc/fused_fit.cu",
                  "tame/ops/fused_fit.py:165"),
    "fused_smoother": ("tame_torch/csrc/fused_smoother.cu",
                       "tame/ops/fused_smoother.py:111"),
}
REL_TOL = 1e-4     # kernel vs twin: different f32 operation order
STATE_ATOL = 1e-4  # K3 vs twin state after a fit (tame's fused-fit bound)
LOGDET_RTOL = 1e-5  # K4 logdet: a sum of T d logs, each exact to f32 rounding


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|); (0, 0) for two empty
    tensors of one shape."""
    require(got.shape == ref.shape, f"shape {got.shape} != {ref.shape}")
    if ref.numel() == 0:
        return 0.0, 0.0
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def spd_batch(B: int, d: int, gen: torch.Generator):
    A = torch.randn(B, d, d, device="cuda", generator=gen)
    P = A @ A.transpose(-1, -2) / d + torch.eye(d, device="cuda")
    return P, torch.randn(B, d, device="cuda", generator=gen)


def smoother_system(n: int, T: int, d: int, gen: torch.Generator):
    """The smoothed fit's systems at r = (d - 2) / 2: D_t = an SPD
    observation precision (A A'/d + I) + the prior precision, O =
    -(Q^-1 Phi)', b ~ N(0, 1)."""
    from tame_torch.config import ModelConfig
    from tame_torch.inference import cavi
    from tame_torch.models import build_params

    pri = cavi.precompute_priors(build_params(ModelConfig(
        n_nodes=n, n_time=T, latent_dim=(d - 2) // 2)).to("cuda"))
    A = torch.randn(n, T, d, d, device="cuda", generator=gen)
    D = (A @ A.transpose(-1, -2) / d + torch.eye(d, device="cuda")
         + cavi._prior_precision(pri, T)[None])
    return D, -pri.Qinv_Phi.T, torch.randn(n, T, d, device="cuda",
                                           generator=gen)


def phase_smoother_kernel(report: dict) -> None:
    from tame_torch.ops import _ext
    from tame_torch.ops import cholesky as ch
    from tame_torch.ops import fused_smoother as fs

    ext = _ext.load()
    require(all(ext.fused_smoother_smem_bytes(d)
                == fs.fused_smoother_smem_bytes(d) for d in ch.KERNEL_DIMS),
            "K4 shared-memory formula differs between Python and CUDA")
    gen = torch.Generator(device="cuda").manual_seed(1)
    entry = report["fused_smoother"]
    entry["max_abs_err"] = 0.0
    # (i) one block phase of the n=2000 smoothed fit (the reported
    # timing), (ii) one Jacobi sweep at n=2000, (iii) the smallest d with
    # T=2, (iv) T=1, where the backward pass is empty and cross_cov is
    # (n, 0, d, d).
    for n, T, d in [(125, 50, 10), (2000, 50, 10), (3, 2, 4), (3, 1, 4)]:
        D, O, b = smoother_system(n, T, d, gen)
        k = fs.fused_smoother_kernel(D, O, b)
        torch.cuda.synchronize()
        t = fs.fused_smoother_twin(D, O, b)
        errs = {name: rel_err(getattr(k, name), getattr(t, name))
                for name in ("mean", "cov", "cross_cov")}
        ld_rel = ((k.logdet - t.logdet).abs() / t.logdet.abs()).max().item()
        print(f"K4 n={n} T={T} d={d}: (max_abs_err, rel) {errs}, logdet "
              f"rel {ld_rel}")
        require(all(e[1] <= REL_TOL for e in errs.values())
                and ld_rel <= LOGDET_RTOL,
                f"K4 disagrees with its twin at n={n} T={T} d={d}")
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [e[0] for e in errs.values()])
        ms = cuda_ms(lambda: fs.fused_smoother_kernel(D, O, b))
        plain_ms = cuda_ms(lambda: fs.fused_smoother_twin(D, O, b), reps=5,
                           warmup=1)
        print(f"K4 n={n} T={T} d={d}: kernel {ms} ms, twin {plain_ms} ms")
        if "ms" not in entry:
            entry["ms"], entry["plain_ms"] = ms, plain_ms


def phase_kernels(report: dict) -> None:
    from tame_torch.inference import cavi
    from tame_torch.models import TemporalAMEModel
    from tame_torch.ops import _ext
    from tame_torch.ops import cholesky as ch
    from tame_torch.ops import fused_fit as ff

    gen = torch.Generator(device="cuda").manual_seed(0)
    # K1 at a block phase (B = 125 * 50) and a Jacobi sweep (n T) of the
    # n=2000 fit, plus a ragged batch at the demo's d.
    for d, B, timed in [(10, 6250, True), (10, 100000, False),
                        (6, 1001, False)]:
        P, eta = spd_batch(B, d, gen)
        mu, cov = ch.spd_solve_inv_kernel(P, eta)
        mu_t, cov_t = ch.spd_solve_inv_twin(P, eta)
        mu1 = ch.spd_solve_inv_kernel(P, eta, with_inverse=False)
        mu1_t = ch.spd_solve_inv_twin(P, eta, with_inverse=False)
        torch.cuda.synchronize()
        errs = [rel_err(mu, mu_t), rel_err(cov, cov_t), rel_err(mu1, mu1_t)]
        worst = max(e[0] for e in errs)
        print(f"K1 d={d} B={B}: max_abs_err mu/cov/mu-only = "
              f"{[e[0] for e in errs]} rel = {[e[1] for e in errs]}")
        require(all(e[1] <= REL_TOL for e in errs),
                f"K1 disagrees with its twin at d={d} B={B}")
        entry = report["spd_solve_inv"]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), worst)
        if timed:
            entry["ms"] = cuda_ms(lambda: ch.spd_solve_inv_kernel(P, eta))
            entry["plain_ms"] = cuda_ms(lambda: ch.spd_solve_inv_twin(P, eta))
            print(f"K1 d={d} B={B}: kernel {entry['ms']} ms, twin "
                  f"{entry['plain_ms']} ms")

    # K2 at the n=2000 entropy batch (n T = 100,000 factors, d = 10).
    P, _ = spd_batch(100000, 10, gen)
    ld, ld_t = ch.logdet_spd_kernel(P), ch.logdet_spd_twin(P)
    torch.cuda.synchronize()
    err, rel = rel_err(ld, ld_t)
    print(f"K2 d=10 B=100000: max_abs_err {err} rel {rel}")
    require(rel <= REL_TOL, "K2 disagrees with its twin")
    entry = report["logdet_spd"]
    entry["max_abs_err"] = err
    entry["ms"] = cuda_ms(lambda: ch.logdet_spd_kernel(P))
    entry["plain_ms"] = cuda_ms(lambda: ch.logdet_spd_twin(P))
    print(f"K2: kernel {entry['ms']} ms, twin {entry['plain_ms']} ms")

    # K3 at the demo configuration, block updates with 15 blocks.
    ext = _ext.load()
    require(ext.fused_fit_smem_bytes(15, 10, 6, 15)
            == ff.fused_fit_smem_bytes(15, 10, 6, 15),
            "K3 shared-memory formula differs between Python and CUDA")
    model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2, seed=7)
    Y = model.generate_data(device="cuda")
    p = model.params.to("cuda")
    entry = report["fused_fit"]
    entry["max_abs_err"] = 0.0
    for structure, corrected, lr, tol in [
            ("full", False, 0.7, 0.0), ("full", True, 0.7, 0.0),
            ("diag", False, 0.7, 0.0), ("block", False, 0.7, 0.0),
            ("full", False, 0.7, 1e-3)]:
        init = cavi.init_state(torch.Generator().manual_seed(3), 15, 10, 6,
                               structure, 0.1, 0.5, device="cuda")
        max_iter = 25 if tol == 0.0 else 150
        args = (Y, p.R_inv, p.Sigma0, p.Q, p.Phi, init.X_mean, init.X_cov,
                max_iter, lr, tol)
        kw = dict(r=2, buf_size=64 if max_iter <= 64 else 256,
                  structure=structure, corrected=corrected, num_blocks=15)
        k = ff.fused_fit_kernel(*args, **kw)
        t = ff.fused_fit_twin(*args, **kw)
        torch.cuda.synchronize()
        n = t.n_iter
        eh_k, eh_t = k.elbo_history[:n], t.elbo_history[:n]
        h_rel = ((eh_k - eh_t).abs() / eh_t.abs()).max().item()
        xm_err = (k.X_mean - t.X_mean).abs().max().item()
        xc_err = (k.X_cov - t.X_cov).abs().max().item()
        print(f"K3 {structure} corrected={corrected} tol={tol}: n_iter "
              f"{k.n_iter}/{t.n_iter} converged {k.converged}/{t.converged} "
              f"elbo rel {h_rel} X_mean {xm_err} X_cov {xc_err}")
        require(k.n_iter == t.n_iter and k.converged == t.converged
                and k.diverged == t.diverged, "K3 stop differs from twin")
        require(h_rel <= REL_TOL and xm_err <= STATE_ATOL
                and xc_err <= STATE_ATOL, "K3 disagrees with its twin")
        require(bool(torch.isnan(k.elbo_history[k.n_iter:]).all()),
                "K3 history past the stop is not NaN")
        if tol > 0.0:
            require(k.converged and k.n_iter < max_iter,
                    "K3 stopping-rule case did not stop early")
        entry["max_abs_err"] = max(entry["max_abs_err"], xm_err, xc_err)
        if (structure, corrected, tol) == ("full", False, 0.0):
            entry["ms"] = cuda_ms(lambda: ff.fused_fit_kernel(*args, **kw),
                                  reps=5, warmup=1)
            entry["plain_ms"] = cuda_ms(
                lambda: ff.fused_fit_twin(*args, **kw), reps=3, warmup=1)
            print(f"K3 25-iteration fit: kernel {entry['ms']} ms, twin "
                  f"{entry['plain_ms']} ms")


def phase_demo() -> None:
    from tame_torch import (TemporalAMEModel, TemporalAMENaiveMFVI,
                            TemporalAMEStructuredMFVI)

    model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2, seed=42)
    model.generate_data(generator=torch.Generator().manual_seed(42),
                        device="cuda")
    mse = {}
    for name, vi in [
            ("naive", TemporalAMENaiveMFVI(model, learning_rate=0.7)),
            ("good", TemporalAMEStructuredMFVI(model, factorization="good",
                                               learning_rate=0.7)),
            ("bad", TemporalAMEStructuredMFVI(model, factorization="bad",
                                              learning_rate=0.7))]:
        h = vi.fit(max_iter=150, verbose=False)
        mse[name] = (h["reconstruction_error"][-1], vi._diverged)
        print(f"demo {name}: {len(h['elbo'])} iterations, ELBO "
              f"{h['elbo'][-1]}, MSE {h['reconstruction_error'][-1]}, "
              f"diverged {vi._diverged}")
    (naive, _), (good, _), (bad, bad_div) = (mse["naive"], mse["good"],
                                             mse["bad"])
    require(naive < 0.5 and good < 0.5 and abs(naive - good) < 0.05,
            f"Naive and Good did not reach a low, equal MSE: {mse}")
    require(bad_div or (bad > 1.0 and bad > 3.0 * good),
            f"Bad SMF did not blow up: {mse}")


def phase_real_size() -> None:
    from tame_torch import TemporalAMEModel, TemporalAMEStructuredMFVI

    model = TemporalAMEModel(n_nodes=2000, n_time=50, latent_dim=4, seed=0)
    model.generate_data(generator=torch.Generator(device="cuda").manual_seed(0))
    vi = TemporalAMEStructuredMFVI(model, factorization="good",
                                   learning_rate=0.8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    h = vi.fit(max_iter=200, verbose=False)
    end.record()
    end.synchronize()
    n_iter = len(h["elbo"])
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2**30
    mse = h["reconstruction_error"]
    print(f"n=2000 T=50 r=4 Good SMF (16 blocks, exact diagnostics): "
          f"{n_iter} iterations, converged {vi._converged}, "
          f"{ms / n_iter} ms/iteration, {ms / 1000} s total, MSE "
          f"{mse[0]} -> {mse[-1]}, peak memory {peak} GiB")
    require(all(math.isfinite(v) for v in h["elbo"] + mse),
            "non-finite history at n=2000")
    # The first sweep already lands near the data; the fit then falls to
    # the noise floor 2 R[0, 0] = 0.2 of the per-dyad normalization.
    require(mse[-1] < 0.9 * mse[0] and mse[-1] < 0.25,
            "MSE did not fall to the noise floor at n=2000")


def phase_smoothed() -> int:
    """Returns the number of iterations run."""
    from tame_torch import TemporalAMEModel, TemporalAMESmoothedVI

    model = TemporalAMEModel(n_nodes=2000, n_time=50, latent_dim=4, seed=0)
    model.generate_data(
        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    vi = TemporalAMESmoothedVI(model, init_mode="warm", learning_rate=0.8)
    marks[1].record()
    h = vi.fit(max_iter=100, verbose=False)
    marks[2].record()
    marks[2].synchronize()
    n_iter = len(h["elbo"])
    init_ms, fit_ms = (marks[0].elapsed_time(marks[1]),
                       marks[1].elapsed_time(marks[2]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    mse = h["reconstruction_error"]
    print(f"n=2000 T=50 r=4 smoothed (warm init, 16 blocks, exact "
          f"diagnostics): warm init {init_ms} ms, {n_iter} iterations, "
          f"converged {vi._converged}, {fit_ms / n_iter} ms/iteration, "
          f"{fit_ms / 1000} s fit, MSE {mse[0]} -> {mse[-1]}, peak memory "
          f"{peak} GiB")
    require(all(math.isfinite(v) for v in h["elbo"] + mse),
            "non-finite smoothed history")
    # noise floor 2 R[0, 0] = 0.2, as in phase_real_size
    require(mse[-1] < 0.9 * mse[0] and mse[-1] < 0.25,
            "smoothed MSE did not fall to the noise floor")
    return n_iter


def phase_em() -> None:
    from tame_torch import fit_em
    from tame_torch.config import ModelConfig
    from tame_torch.models import build_params, sample

    truth = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0,
                        ar_coefficient=0.8, rho_dyadic=0.5)
    Y, _ = sample(build_params(truth),
                  torch.Generator(device="cuda").manual_seed(0), 2000, 50)
    start_cfg = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0,
                            ar_coefficient=0.3, rho_dyadic=0.0,
                            dyadic_variance=1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_em(Y, build_params(start_cfg).to("cuda"), n_em=3,
                 inner_max_iter=60)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = res.history
    n_em = len(h["elbo"])
    print(f"EM n=2000 T=50 r=4 from phi 0.3 / sigma2 1.0 / rho 0: {n_em} EM "
          f"iterations in {wall} s ({wall / n_em} s/EM iteration, host "
          f"clock); learned phi {h['phi'][-1]} (truth 0.8), sigma2 "
          f"{h['sigma2'][-1]} (0.1), rho {h['rho'][-1]} (0.5); ELBO "
          f"{h['elbo']}")
    require(n_em == 3 and all(math.isfinite(v) for vals in h.values()
                              for v in vals), "EM run not finite")
    require(bool((torch.linalg.eigvalsh(res.params.Q) > 0).all()
                 and (torch.linalg.eigvalsh(res.params.R) > 0).all()),
            "learned Q or R is not SPD")
    require(abs(h["phi"][-1] - 0.8) < 0.5 and abs(h["sigma2"][-1] - 0.1) < 0.9,
            "EM did not move phi and sigma2 toward the truth")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tame_torch  # noqa: F401  (sets TF32 off)
    from tame_torch.ops import _ext
    from tame_torch.ops import cholesky as ch
    from tame_torch.ops import fused_fit as ff
    from tame_torch.ops import fused_smoother as fs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print("card (nvidia-smi name, power.limit):")
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    _ext.load()
    print(f"build: {time.perf_counter() - t0:.1f} s (build/tame_torch)")

    report = {name: {} for name in KERNELS}
    phase_kernels(report)
    phase_smoother_kernel(report)

    wrappers = {"spd_solve_inv": ch.spd_solve_inv_kernel,
                "logdet_spd": ch.logdet_spd_kernel,
                "fused_fit": ff.fused_fit_kernel,
                "fused_smoother": fs.fused_smoother_kernel}

    def drive(path, *args):
        """Run one path with every launch counter zeroed just before it;
        returns (its result, the counts read just after)."""
        for w in wrappers.values():
            w.launches = 0
        out = path(*args)
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"launches, {path.__name__}: {counts}")
        return out, counts

    _, demo = drive(phase_demo)
    _, good = drive(phase_real_size)
    n_iter, smoothed = drive(phase_smoothed)
    _, em = drive(phase_em)
    require(demo["fused_fit"] >= 3, "demo drive did not run K3")
    require(good["fused_fit"] == 0, "the n=2000 fit ran K3")
    require(good["spd_solve_inv"] > 0 and good["logdet_spd"] > 0,
            "the n=2000 fit did not run K1 and K2")
    require(smoothed["fused_smoother"] == 16 * n_iter,
            "the smoothed fit did not launch K4 once per block phase")
    require(em["fused_smoother"] > 0, "the EM E-steps did not run K4")
    launches = {k: demo[k] + good[k] + smoothed[k] + em[k]
                for k in wrappers}

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **report[name])
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
