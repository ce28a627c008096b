#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. build the port's CUDA kernels (K1 spd_solve_inv, K2 logdet_spd,
   K3 fused_fit, K4 fused_smoother, K5 masked_contract, K6 dual_contract,
   K7 eta_contract) from ``tame_torch/csrc`` into ``build/tame_torch``;
2. compare each kernel with its plain PyTorch twin on the same CUDA
   inputs, at the shapes the main paths give it (K1, K2 and K4 also at
   d = 14, their runtime-d variants), and time both with CUDA events
   (median of several runs), beside the kernel's bound (bytes over
   3.35 TB/s or operations over the peak rate of their type, whichever is
   larger) and, where one PyTorch call computes the same function, that
   call's time;
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
   through K4;
7. the missing-data path at n=2000, T=50, r=4 with 30 % of the dyads
   hidden (the setting of ``scripts/masked_scale_probe.py``), through
   ``TemporalAMEStructuredMFVI(mask=..., mixed_precision=True,
   diag_mode="stats", learning_rate=0.8)``: (i) the same flags with no
   mask, (ii) masked through the bf16 einsum mask path, (iii) masked with
   ``TAME_PACKED_MASK=1``, through K5 (32 launches per iteration), each
   to its stop; then the three timed in turns over 40 iterations each;
8. the masked smoothed fit (warm init, the same mask and flags,
   ``TAME_PACKED_MASK=1``): K4 and K5 in every block phase;
9. masked variational EM (2 EM iterations of <= 30 inner ones);
10. the layout probe ``tame_torch.scripts.layout_probe3`` at N=2000,
    T=50, R=4, K=25: the eta contraction's four variants, through K7;
11. an r = 6 (d = 14) Good-SMF fit and smoothed fit at n=2000, T=50, 20
    iterations each, through the runtime-d K1/K2 and K4;
12. the benchmark ``tame_torch.scripts.bench`` with 32 demo fits and 2
    repeats (its n=2000 legs at full size), which prints its JSON line.

Each of phases 3-12 is a path of its own (phases 7 and 11 several): the
launch counters are zeroed just before it and read just after, and each
path must have launched its kernels.  K6 lies on no path: its
``launches`` are its comparison launches in phase 2.  The second-to-last
line is a JSON object describing each kernel (``launches`` summed over
the paths), the last is the device record.  Needs one CUDA card; without
one it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
    "masked_contract": ("tame_torch/csrc/masked_contract.cu",
                        "tame/ops/masked_contract.py:68"),
    "dual_contract": ("tame_torch/csrc/dual_contract.cu",
                      "tame/ops/dual_contract.py:45"),
    "eta_contract": ("tame_torch/csrc/eta_contract.cu",
                     "scripts/layout_probe3.py:84"),
}
REL_TOL = 1e-4     # kernel vs twin: different f32 operation order
STATE_ATOL = 1e-4  # K3 vs twin state after a fit (tame's fused-fit bound)
LOGDET_RTOL = 1e-5  # K4 logdet: a sum of T d logs, each exact to f32 rounding
# Packed (K5) vs bf16-einsum masked fit: final ELBOs of two converged fits
# whose bf16-rounded panels are summed in another order.
MASKED_ELBO_RTOL = 1e-3

# NVIDIA H100 SXM data sheet (dense): device memory 3.35 TB/s; float32 on
# the CUDA cores 67 TFLOP/s; bf16 on the tensor cores 989 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}


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


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their
    type."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


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
                == fs.fused_smoother_smem_bytes(d)
                for d in ch.UNROLLED_DIMS + (14, 16, ch.MAX_KERNEL_D)),
            "K4 shared-memory formula differs between Python and CUDA")
    gen = torch.Generator(device="cuda").manual_seed(1)
    entry = report["fused_smoother"]
    entry["max_abs_err"] = 0.0
    # (i) one block phase of the n=2000 smoothed fit (the reported
    # timing), (ii) one Jacobi sweep at n=2000, (iii) the smallest d with
    # T=2, (iv) T=1, where the backward pass is empty and cross_cov is
    # (n, 0, d, d), (v) one block phase of the r = 6 smoothed fit (the
    # runtime-d kernel).
    for n, T, d in [(125, 50, 10), (2000, 50, 10), (3, 2, 4), (3, 1, 4),
                    (125, 50, 14)]:
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
        # forward: two d x d products, a factor and an inverse per step;
        # backward: three products per step
        flops = n * T * d**3 * (4 + 1 / 3 + 2) + n * (T - 1) * 6 * d**3
        b_ = bound(nbytes(D, O, b, *k), flops, "f32")
        print(f"K4 n={n} T={T} d={d}: kernel {ms} ms, twin {plain_ms} ms, "
              f"bound {b_['bound_ms']} ms ({b_['bound_by']})")
        if "ms" not in entry:
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=None, **b_)


def fused_fit_flops(n: int, T: int, d: int, num_blocks: int,
                    n_iter: int) -> float:
    """Operations of a K3 fit of ``n_iter`` iterations (multiply-adds
    counted twice): per block phase the three partner Grams over all n
    nodes, the two W @ Z products of the block's rows and the block's
    solves with inverse; per iteration the exact diagnostics (dyadic means
    and residual sums) and the entropy's factors."""
    r = (d - 2) // 2
    bs = n // num_blocks
    phase = (3 * 2 * n * T * r * r + 2 * 2 * bs * n * T * r
             + 2 * bs * T * (d**3 / 3 + 2 * d**3 + 2 * d * d))
    diagnostics = n * n * T * (2 * r + 6) + 2 * n * T * d**3 / 3
    return n_iter * (num_blocks * phase + diagnostics)


def phase_kernels(report: dict) -> None:
    from tame_torch.inference import cavi
    from tame_torch.models import TemporalAMEModel
    from tame_torch.ops import _ext
    from tame_torch.ops import cholesky as ch
    from tame_torch.ops import fused_fit as ff

    gen = torch.Generator(device="cuda").manual_seed(0)
    # K1 at a block phase (B = 125 * 50) and a Jacobi sweep (n T) of the
    # n=2000 fit, a ragged batch at the demo's d, and the runtime-d kernel
    # at the r = 6 fit's block phase and a ragged batch.
    for d, B, timed in [(10, 6250, True), (10, 100000, False),
                        (6, 1001, False), (14, 6250, False),
                        (14, 1001, False)]:
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
        if d == 14 and B == 6250:
            print(f"K1 d=14 B=6250 (runtime d): kernel "
                  f"{cuda_ms(lambda: ch.spd_solve_inv_kernel(P, eta))} ms, "
                  f"twin {cuda_ms(lambda: ch.spd_solve_inv_twin(P, eta))} "
                  f"ms, bound " + str(bound(
                      nbytes(P, eta, mu, cov),
                      2 * B * (d**3 / 3 + 2 * d**3 + 2 * d * d), "f32")))
        if timed:
            entry["ms"] = cuda_ms(lambda: ch.spd_solve_inv_kernel(P, eta))
            entry["plain_ms"] = cuda_ms(lambda: ch.spd_solve_inv_twin(P, eta))
            # factor d^3/3, inverse 2 d^3, mean 2 d^2 multiply-adds x 2
            entry.update(library_ms=None, **bound(
                nbytes(P, eta, mu, cov),
                2 * B * (d**3 / 3 + 2 * d**3 + 2 * d * d), "f32"))
            print(f"K1 d={d} B={B}: kernel {entry['ms']} ms, twin "
                  f"{entry['plain_ms']} ms, bound {entry['bound_ms']} ms")

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
    entry["library_ms"] = cuda_ms(lambda: torch.logdet(P))
    entry.update(bound(nbytes(P, ld), 2 * 100000 * 10**3 / 3, "f32"))
    print(f"K2: kernel {entry['ms']} ms, twin {entry['plain_ms']} ms, "
          f"torch.logdet {entry['library_ms']} ms, bound "
          f"{entry['bound_ms']} ms")
    # the runtime-d K2 at a ragged batch and the r = 6 entropy batch
    # (n T = 100,000, d = 14), timed at the latter
    for B in (1001, 100000):
        P, _ = spd_batch(B, 14, gen)
        ld, ld_t = ch.logdet_spd_kernel(P), ch.logdet_spd_twin(P)
        torch.cuda.synchronize()
        err, rel = rel_err(ld, ld_t)
        require(rel <= REL_TOL, f"K2 disagrees with its twin at d=14 B={B}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        print(f"K2 d=14 B={B} (runtime d): max_abs_err {err} rel {rel}")
    print(f"K2 d=14 B=100000 (runtime d): kernel "
          f"{cuda_ms(lambda: ch.logdet_spd_kernel(P))} ms, twin "
          f"{cuda_ms(lambda: ch.logdet_spd_twin(P))} ms, torch.logdet "
          f"{cuda_ms(lambda: torch.logdet(P))} ms, bound "
          f"{bound(nbytes(P, ld), 2 * 100000 * 14**3 / 3, 'f32')}")

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
            entry.update(library_ms=None, **bound(
                nbytes(Y, init.X_mean, init.X_cov, k.X_mean, k.X_cov)
                + 3 * nbytes(Y[..., 0]),   # the kernel's W0, W1, y0
                fused_fit_flops(15, 10, 6, 15, k.n_iter), "f32"))
            print(f"K3 25-iteration fit: kernel {entry['ms']} ms, twin "
                  f"{entry['plain_ms']} ms, bound {entry['bound_ms']} ms")


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


def em_data():
    """EM truth (phi 0.8, rho 0.5, sigma2 0.1) sampled on the card, and
    the wrong start (phi 0.3, rho 0, sigma2 1.0) of
    ``scripts/em_scale_probe.py``."""
    from tame_torch.config import ModelConfig
    from tame_torch.models import build_params, sample

    truth = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0,
                        ar_coefficient=0.8, rho_dyadic=0.5)
    Y, _ = sample(build_params(truth),
                  torch.Generator(device="cuda").manual_seed(0), 2000, 50)
    start_cfg = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0,
                            ar_coefficient=0.3, rho_dyadic=0.0,
                            dyadic_variance=1.0)
    return Y, build_params(start_cfg).to("cuda")


def run_em(tag: str, n_em: int, masked: bool = False, **kw) -> None:
    """``fit_em`` from the wrong start (with 30 % of the dyads hidden when
    ``masked``); checks finite values, SPD Q and R and phi and sigma2
    moved toward the truth."""
    from tame_torch import fit_em

    Y, start = em_data()
    if masked:
        kw["mask"] = hidden_dyads(Y.shape[0], Y.shape[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_em(Y, start, n_em=n_em, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = res.history
    done = len(h["elbo"])
    print(f"{tag} n=2000 T=50 r=4 from phi 0.3 / sigma2 1.0 / rho 0: "
          f"{done} EM iterations in {wall} s ({wall / done} s/EM iteration, "
          f"host clock); learned phi {h['phi'][-1]} (truth 0.8), sigma2 "
          f"{h['sigma2'][-1]} (0.1), rho {h['rho'][-1]} (0.5); ELBO "
          f"{h['elbo']}")
    require(done == n_em and all(math.isfinite(v) for vals in h.values()
                                 for v in vals), f"{tag} run not finite")
    require(bool((torch.linalg.eigvalsh(res.params.Q) > 0).all()
                 and (torch.linalg.eigvalsh(res.params.R) > 0).all()),
            f"{tag}: learned Q or R is not SPD")
    require(abs(h["phi"][-1] - 0.8) < 0.5 and abs(h["sigma2"][-1] - 0.1) < 0.9,
            f"{tag} did not move phi and sigma2 toward the truth")


def phase_em() -> None:
    run_em("EM", 3, inner_max_iter=60)


def phase_masked_em() -> None:
    run_em("masked EM (30 % hidden, bf16 + stats)", 2, masked=True,
           inner_max_iter=30, mixed_precision=True, diag_mode="stats")


# ---------------------------------------------------------------------------
# The missing-data path (K5) and K6
# ---------------------------------------------------------------------------

MISSING_FRAC = 0.3  # scripts/masked_scale_probe.py


def hidden_dyads(n: int, T: int) -> torch.Tensor:
    """The masked phases' observation mask, drawn on the card: 30 % of
    the dyads hidden, symmetric, zero diagonal."""
    from tame_torch.models import random_dyad_mask

    return random_dyad_mask(torch.Generator(device="cuda").manual_seed(1),
                            n, T, MISSING_FRAC)


@contextlib.contextmanager
def packed_mask_env(on: bool):
    """``TAME_PACKED_MASK=1`` (masked contractions through K5) inside the
    block when ``on``, unset otherwise; the old value is restored."""
    old = os.environ.pop("TAME_PACKED_MASK", None)
    if on:
        os.environ["TAME_PACKED_MASK"] = "1"
    try:
        yield
    finally:
        os.environ.pop("TAME_PACKED_MASK", None)
        if old is not None:
            os.environ["TAME_PACKED_MASK"] = old


def phase_contract_kernels(report: dict) -> None:
    """K5 and K6 against their twins on CUDA inputs, timed beside the
    bf16 ``bmm`` that computes the same products."""
    from tame_torch.inference import cavi
    from tame_torch.models import random_dyad_mask
    from tame_torch.ops import dual_contract as dc
    from tame_torch.ops import masked_contract as mc

    gen = torch.Generator(device="cuda").manual_seed(2)
    n, T, r = 2000, 50, 4
    mask = hidden_dyads(n, T)
    U, V = (0.5 * torch.randn(n, T, r, device="cuda", generator=gen)
            for _ in range(2))
    panels = {57: cavi._masked_panel(U, V),          # precision panel
              56: torch.randn(n, T, 56, device="cuda", generator=gen)}
    small = random_dyad_mask(gen, 20, 3, MISSING_FRAC)
    # (label, stripes, panel): one n=2000 block phase (16 blocks, bs=125)
    # with the precision and the stats panel, the ragged n=20 case (every
    # stripe) and the full n=2000 mask as one stripe.
    blocks = mc.pack_mask(mask, 16)
    cases = [("n=2000 bs=125 K=57", [blocks[0]], panels[57]),
             ("n=2000 bs=125 K=56", [blocks[0]], panels[56]),
             ("n=20 T=3 K=5 nb=4", list(mc.pack_mask(small, 4)),
              torch.randn(20, 3, 5, device="cuda", generator=gen)),
             ("n=2000 one stripe K=57", [mc.pack_mask(mask, 1)[0]],
              panels[57])]
    del blocks
    entry = report["masked_contract"]
    entry["max_abs_err"] = 0.0
    for label, stripes, Z in cases:
        err = rel = 0.0
        for Mp in stripes:
            got = mc.packed_rows_contract_kernel(Mp, Z)
            torch.cuda.synchronize()
            e, rl = rel_err(got, mc.packed_rows_contract_twin(Mp, Z))
            require(rl <= REL_TOL, f"K5 disagrees with its twin at {label}")
            err, rel = max(err, e), max(rel, rl)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        Mp = stripes[0]
        ms = cuda_ms(lambda: mc.packed_rows_contract_kernel(Mp, Z))
        plain_ms = cuda_ms(lambda: mc.packed_rows_contract_twin(Mp, Z),
                           reps=5, warmup=1)
        # the library's one call on bf16 copies made beforehand (the
        # conversions are not timed)
        Mb = Mp[..., :Z.shape[0]].to(torch.bfloat16)
        Zb = Z.to(torch.bfloat16).transpose(0, 1).contiguous()
        lib_ms = cuda_ms(lambda: torch.bmm(Mb, Zb, out_dtype=torch.float32))
        out = torch.empty(Mp.shape[1], Z.shape[1], Z.shape[2],
                          device="cuda")
        b = bound(nbytes(Mp, Z, out),
                  2 * Mp.shape[0] * Mp.shape[1] * Z.shape[0] * Z.shape[2],
                  "bf16")
        print(f"K5 {label}: max_abs_err {err} rel {rel}; kernel {ms} ms, "
              f"twin {plain_ms} ms, bf16 bmm {lib_ms} ms, bound "
              f"{b['bound_ms']} ms ({b['bound_by']})")
        if "ms" not in entry:  # the path's shape: one block phase
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
        del Mb, Zb

    entry = report["dual_contract"]
    entry.update(max_abs_err=0.0, launches=0)
    for T_, n_, m in [(50, 2000, 8), (3, 20, 4)]:
        Wp = dc.pad_data(torch.randn(T_, n_, n_, device="cuda",
                                     generator=gen))
        Z = torch.randn(T_, n_, m, device="cuda", generator=gen)
        before = dc.dual_contract_kernel.launches
        row, col = dc.dual_contract_padded(Wp, Z)
        # K6 lies on no path: its launches are these comparison launches
        # (not the timing loops').
        entry["launches"] += dc.dual_contract_kernel.launches - before
        torch.cuda.synchronize()
        row_t, col_t = dc.dual_contract_twin(Wp, Z)
        errs = [rel_err(row, row_t), rel_err(col, col_t)]
        require(all(e[1] <= REL_TOL for e in errs),
                f"K6 disagrees with its twin at T={T_} n={n_} m={m}")
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [e[0] for e in errs])
        ms = cuda_ms(lambda: dc.dual_contract_kernel(Wp, Z))
        plain_ms = cuda_ms(lambda: dc.dual_contract_twin(Wp, Z), reps=5,
                           warmup=1)
        Wb = Wp[..., :n_]
        Zb = Z.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: (
            torch.bmm(Wb, Zb, out_dtype=torch.float32),
            torch.bmm(Wb.transpose(1, 2), Zb, out_dtype=torch.float32)))
        b = bound(nbytes(Wp, Z, row, col), 2 * 2 * T_ * n_ * n_ * m, "bf16")
        print(f"K6 T={T_} n={n_} m={m}: (max_abs_err, rel) row/col {errs}; "
              f"kernel {ms} ms, twin {plain_ms} ms, two bf16 bmm {lib_ms} "
              f"ms, bound {b['bound_ms']} ms ({b['bound_by']})")
        if "ms" not in entry:
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
    require(entry["launches"] == 2, "K6 did not launch")


def phase_eta_kernel(report: dict) -> None:
    """K7 against its twin at the probe's shape and two ragged ones, timed
    beside the bf16 ``bmm`` with float32 output on the same (contiguous)
    weights and a bf16 copy of the panel made beforehand."""
    from tame_torch.ops import eta_contract as ec

    gen = torch.Generator(device="cuda").manual_seed(3)
    entry = report["eta_contract"]
    entry["max_abs_err"] = 0.0
    for T, N, R in [(50, 2000, 4), (3, 37, 1), (3, 37, 16)]:
        W = torch.randn(T, N, N, device="cuda", generator=gen).to(
            torch.bfloat16)
        Z = torch.randn(T, N, R, device="cuda", generator=gen)
        got = ec.eta_contract_kernel(W, Z)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ec.eta_contract_twin(W, Z))
        print(f"K7 T={T} N={N} R={R}: max_abs_err {err} rel {rel}")
        require(rel <= REL_TOL,
                f"K7 disagrees with its twin at T={T} N={N} R={R}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        ms = cuda_ms(lambda: ec.eta_contract_kernel(W, Z))
        plain_ms = cuda_ms(lambda: ec.eta_contract_twin(W, Z), reps=5,
                           warmup=1)
        Zb = Z.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.bmm(W, Zb, out_dtype=torch.float32))
        b = bound(nbytes(W, Z, got), 2 * T * N * N * R, "bf16")
        print(f"K7 T={T} N={N} R={R}: kernel {ms} ms, twin {plain_ms} ms, "
              f"bf16 bmm {lib_ms} ms, bound {b['bound_ms']} ms "
              f"({b['bound_by']})")
        if "ms" not in entry:  # the probe's shape
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
        del W, Z, Zb, got


def phase_layout_probe() -> dict:
    from tame_torch.scripts import layout_probe3

    res = layout_probe3.main([])
    require(res["k7_launches"] > 0, "the layout probe did not run K7")
    return res


def high_rank_model():
    """n=2000, T=50, r=6 (d=14) data drawn on the card."""
    from tame_torch import TemporalAMEModel

    model = TemporalAMEModel(n_nodes=2000, n_time=50, latent_dim=6, seed=0)
    model.generate_data(
        generator=torch.Generator(device="cuda").manual_seed(6))
    return model


def check_history(label: str, h: dict, n_iter: int, ms: float) -> None:
    mse = h["reconstruction_error"]
    print(f"{label}: {len(h['elbo'])} iterations, {ms / len(h['elbo'])} "
          f"ms/iteration, ELBO {h['elbo'][0]} -> {h['elbo'][-1]}, MSE "
          f"{mse[0]} -> {mse[-1]}")
    require(len(h["elbo"]) == n_iter, f"{label} stopped early")
    require(all(math.isfinite(v) for v in h["elbo"] + mse),
            f"non-finite {label} history")
    require(mse[-1] < mse[0] and h["elbo"][-1] > h["elbo"][0],
            f"{label} did not improve its fit")


def phase_high_rank_good(model) -> int:
    """An r = 6 Good-SMF fit (16 blocks, exact diagnostics) of 20
    iterations through the runtime-d K1 and K2."""
    from tame_torch import TemporalAMEStructuredMFVI

    vi = TemporalAMEStructuredMFVI(model, factorization="good",
                                   learning_rate=0.8)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    h = vi.fit(max_iter=20, tolerance=0.0, verbose=False)
    end.record()
    end.synchronize()
    check_history("n=2000 T=50 r=6 Good SMF", h, 20, start.elapsed_time(end))
    return 20


def phase_high_rank_smoothed(model) -> int:
    """An r = 6 smoothed fit (warm init, 16 blocks) of 20 iterations
    through the runtime-d K4."""
    from tame_torch import TemporalAMESmoothedVI

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    vi = TemporalAMESmoothedVI(model, init_mode="warm", learning_rate=0.8)
    start.record()
    h = vi.fit(max_iter=20, tolerance=0.0, verbose=False)
    end.record()
    end.synchronize()
    check_history("n=2000 T=50 r=6 smoothed (warm init)", h, 20,
                  start.elapsed_time(end))
    return 20


def phase_bench() -> dict:
    from tame_torch.scripts import bench

    return bench.main(["--n-fits", "32", "--repeats", "2"])


def mse_split(Y: torch.Tensor, X_mean: torch.Tensor, mask: torch.Tensor):
    """(observed, held-out) reconstruction MSE of the fitted means over
    the dyads ``mask`` shows and the off-diagonal ones it hides."""
    from tame_torch.ops import dyad as dyad_ops

    n = Y.shape[0]
    r = (X_mean.shape[-1] - 2) // 2
    e2 = (Y[..., 0] - dyad_ops.dyadic_fwd_temporal(X_mean, r)) ** 2
    held = (dyad_ops.offdiag_mask(n, Y.dtype, Y.device)[:, :, None]
            * (1.0 - mask))
    return (((e2 * mask).sum() / mask.sum()).item(),
            ((e2 * held).sum() / held.sum()).item())


def masked_model():
    from tame_torch import TemporalAMEModel

    model = TemporalAMEModel(n_nodes=2000, n_time=50, latent_dim=4, seed=0)
    model.generate_data(
        generator=torch.Generator(device="cuda").manual_seed(0))
    return model, hidden_dyads(2000, 50)


def masked_fit(model, mask, fit_mask, packed: bool, max_iter: int = 200,
               tolerance: float = 1e-4) -> dict:
    """One production-flag Good-SMF fit (bf16 weights, stats diagnostics,
    lr 0.8, <= ``max_iter`` iterations) with ``fit_mask`` (None: dense);
    ``ms_per_iter`` is the ``fit()`` call (weights, mask layout and every
    iteration) over the iterations run."""
    from tame_torch import TemporalAMEStructuredMFVI

    with packed_mask_env(packed):
        vi = TemporalAMEStructuredMFVI(
            model, factorization="good", learning_rate=0.8,
            mixed_precision=True, diag_mode="stats", mask=fit_mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        h = vi.fit(max_iter=max_iter, tolerance=tolerance, verbose=False)
        end.record()
        end.synchronize()
    n_iter = len(h["elbo"])
    obs, held = mse_split(vi.Y, vi.X_mean, mask)
    out = dict(n_iter=n_iter, ms_per_iter=start.elapsed_time(end) / n_iter,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               elbo=h["elbo"][-1], mse_obs=obs, mse_held=held,
               converged=vi._converged)
    require(all(math.isfinite(v) for v in h["elbo"]
                + h["reconstruction_error"]), "non-finite masked history")
    return out


def phase_masked_smoothed(model, mask) -> int:
    """The masked smoothed fit through K4 and K5; returns its
    iterations."""
    from tame_torch import TemporalAMESmoothedVI

    with packed_mask_env(True):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vi = TemporalAMESmoothedVI(model, init_mode="warm",
                                   learning_rate=0.8, mask=mask,
                                   mixed_precision=True, diag_mode="stats")
        h = vi.fit(max_iter=100, verbose=False)
        end.record()
        end.synchronize()
    n_iter = len(h["elbo"])
    obs, held = mse_split(vi.Y, vi.X_mean, mask)
    print(f"masked smoothed n=2000 T=50 r=4 (30 % hidden, warm init, 16 "
          f"blocks, bf16 + stats, K5): {n_iter} iterations, converged "
          f"{vi._converged}, {start.elapsed_time(end) / n_iter} ms/iteration "
          f"(warm init included), MSE observed {obs} held-out {held}")
    require(all(math.isfinite(v) for v in h["elbo"]
                + h["reconstruction_error"]), "non-finite smoothed history")
    require(held < 2.0 * obs + 0.05, "masked smoothed fit does not "
            "recover the held-out dyads")
    return n_iter


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tame_torch  # noqa: F401  (sets TF32 off)
    from tame_torch.ops import _ext
    from tame_torch.ops import cholesky as ch
    from tame_torch.ops import eta_contract as ec
    from tame_torch.ops import fused_fit as ff
    from tame_torch.ops import fused_smoother as fs
    from tame_torch.ops import masked_contract as mc

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
    phase_contract_kernels(report)
    phase_eta_kernel(report)

    wrappers = {"spd_solve_inv": ch.spd_solve_inv_kernel,
                "logdet_spd": ch.logdet_spd_kernel,
                "fused_fit": ff.fused_fit_kernel,
                "fused_smoother": fs.fused_smoother_kernel,
                "masked_contract": mc.packed_rows_contract_kernel,
                "eta_contract": ec.eta_contract_kernel}
    paths = []

    def drive(label, path, *args):
        """Run one path with every launch counter zeroed just before it;
        returns (its result, the counts read just after)."""
        for w in wrappers.values():
            w.launches = 0
        out = path(*args)
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"launches, {label}: {counts}")
        paths.append(counts)
        return out, counts

    _, demo = drive("demo", phase_demo)
    _, good = drive("n=2000 Good SMF", phase_real_size)
    n_iter, smoothed = drive("n=2000 smoothed", phase_smoothed)
    _, em = drive("n=2000 EM", phase_em)
    require(demo["fused_fit"] >= 3, "demo drive did not run K3")
    require(good["fused_fit"] == 0, "the n=2000 fit ran K3")
    require(good["spd_solve_inv"] > 0 and good["logdet_spd"] > 0,
            "the n=2000 fit did not run K1 and K2")
    require(smoothed["fused_smoother"] == 16 * n_iter,
            "the smoothed fit did not launch K4 once per block phase")
    require(em["fused_smoother"] > 0, "the EM E-steps did not run K4")

    model, mask = masked_model()
    runs = {}
    configs = [("dense", None, False), ("masked einsum", mask, False),
               ("masked K5", mask, True)]
    for label, fit_mask, packed in configs:
        # warm-up (not a path): the first bf16 products pick their
        # cuBLAS kernels
        masked_fit(model, mask, fit_mask, packed, max_iter=2)
        runs[label], counts = drive(f"n=2000 {label}", masked_fit, model,
                                    mask, fit_mask, packed)
        res = runs[label]
        print(f"n=2000 T=50 r=4 {label} (bf16 weights, stats diagnostics, "
              f"16 blocks, lr 0.8): {res}")
        require(counts["spd_solve_inv"] > 0 and counts["logdet_spd"] > 0,
                f"the {label} fit did not run K1 and K2")
        # 16 block-phase stripes + 16 diagnostics stripes per iteration
        want = 32 * res["n_iter"] if packed else 0
        require(counts["masked_contract"] == want,
                f"the {label} fit launched K5 {counts['masked_contract']} "
                f"times, not {want}")
        if fit_mask is not None:
            require(res["mse_held"] < 2.0 * res["mse_obs"] + 0.05,
                    f"the {label} fit does not recover the held-out dyads")
    # ms/iteration in turns (dense, einsum, K5, K5, einsum, dense, twice),
    # 40 iterations each, for the spread of one configuration's runs
    turns = {label: [] for label, _, _ in configs}
    for label, fit_mask, packed in (configs + configs[::-1]) * 2:
        turns[label].append(masked_fit(model, mask, fit_mask, packed,
                                       max_iter=40, tolerance=0.0)
                            ["ms_per_iter"])
    dense = statistics.median(turns["dense"])
    print(f"ms/iteration in turns, 40 iterations each: {turns}; masked / "
          f"dense (medians): einsum "
          f"{statistics.median(turns['masked einsum']) / dense}, K5 "
          f"{statistics.median(turns['masked K5']) / dense}")
    e_ein, e_k5 = runs["masked einsum"]["elbo"], runs["masked K5"]["elbo"]
    require(abs(e_k5 - e_ein) <= MASKED_ELBO_RTOL * abs(e_ein),
            f"K5 and einsum masked fits end apart: {e_k5} vs {e_ein}")
    n_iter, msmoothed = drive("n=2000 masked smoothed",
                              phase_masked_smoothed, model, mask)
    require(msmoothed["fused_smoother"] == 16 * n_iter,
            "the masked smoothed fit did not launch K4 once per phase")
    # corrected updates: precision and offset stripes per phase, plus the
    # diagnostics stripes
    require(msmoothed["masked_contract"] == 48 * n_iter,
            "the masked smoothed fit did not launch K5 48 times per "
            "iteration")
    del model, mask
    _, mem = drive("n=2000 masked EM", phase_masked_em)
    require(mem["fused_smoother"] > 0, "the masked EM did not run K4")

    _, probe = drive("layout probe N=2000 T=50 R=4 K=25", phase_layout_probe)
    require(probe["eta_contract"] > 0, "the layout probe did not run K7")
    model = high_rank_model()
    n_iter, hgood = drive("n=2000 r=6 Good SMF", phase_high_rank_good, model)
    require(hgood["spd_solve_inv"] == 16 * n_iter
            and hgood["logdet_spd"] == n_iter and hgood["fused_fit"] == 0,
            "the r=6 Good-SMF fit did not run K1 per block phase and K2 per "
            "iteration")
    n_iter, hsmooth = drive("n=2000 r=6 smoothed", phase_high_rank_smoothed,
                            model)
    require(hsmooth["fused_smoother"] == 16 * n_iter,
            "the r=6 smoothed fit did not launch K4 once per block phase")
    del model
    _, bench = drive("bench (32 demo fits, 2 repeats)", phase_bench)
    # 32 fits in the warm-up run and in each of the 2 timed runs
    require(bench["fused_fit"] == 3 * 32, "the bench demo leg did not run "
            "one K3 launch per fit")
    require(bench["spd_solve_inv"] > 0 and bench["logdet_spd"] > 0
            and bench["fused_smoother"] > 0,
            "the bench n=2000 legs did not run K1, K2 and K4")
    launches = {k: sum(c[k] for c in paths) for k in wrappers}
    launches["dual_contract"] = report["dual_contract"].pop("launches")

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
