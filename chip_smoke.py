#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl-leg   # 2-4 cards: phases 39 and 41 alone

Phases (each raises on failure; the script exits 0 only if all pass):

1. build the port's CUDA kernels (K1 spd_solve_inv, K2 logdet_spd,
   K3 fused_fit, K4 fused_smoother, K5 masked_contract, K6 dual_contract,
   K7 eta_contract) from ``tame_torch/csrc`` into ``build/tame_torch``;
2. compare each kernel with its plain PyTorch twin on the same CUDA
   inputs, at the shapes the main paths give it (K1 and K2 also at
   d = 14, 34 and 48, ragged batches and two indefinite systems, which
   must come out NaN alone; K3 at the 15-block demo fit, every d
   it is built for, ``bench``'s 150-iteration Jacobi fit and n=100, T=10
   in 10 blocks, with its bare launch timed beside the wrapper; K4 also
   at d = 14, 32, 34 and 48 and with one indefinite node, which must come
   out NaN; K6 also at m = 40, in slices of 16 columns, and at a ragged
   n = 37, each with two launches on the same inputs that must give the
   same bits), and time both with CUDA events
   (median of several runs; K1, K2, K5 and K6 as launches replayed from
   one CUDA graph, their device time, K5's block stripes in rotation over
   the 16 stripes of the mask, and a sharded rank's 16 ragged stripes of
   63 or 62 rows, with one wrapper call between two events beside it),
   beside the kernel's bound (bytes over
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
   mask, (ii) masked through the bf16 einsum mask path (the card's route
   is K5 here: :func:`packed_mask_env` holds ``cavi.use_packed_mask`` to
   the einsum), (iii) masked with ``TAME_PACKED_MASK=1``, through K5 (32
   launches per iteration), each to its stop; then the three timed in
   turns over 40 iterations each;
8. the masked smoothed fit (warm init, the same mask and flags,
   ``TAME_PACKED_MASK=1``): K4 and K5 in every block phase;
9. masked variational EM (2 EM iterations of <= 30 inner ones);
10. the layout probe ``tame_torch.scripts.layout_probe3`` at N=2000,
    T=50, R=4, K=25: the eta contraction's four variants, through K7;
11. an r = 6 (d = 14) Good-SMF fit and smoothed fit at n=2000, T=50, 20
    iterations each, through K1/K2 and K4 at d = 14;
12. the benchmark ``tame_torch.scripts.bench`` with 32 demo fits and 2
    repeats (its n=2000 legs at full size), which prints its JSON line;
13. the seq sweep (``update_mode="seq"``) at the demo shape for the three
    structures, each held to the same fit on the CPU (the K1/K2 twins)
    at every iteration, with n T K1 launches of one system per iteration;
14. checkpointed fits that resume bit for bit: the demo's Good-SMF fit
    through K3 (one launch per segment), the n=2000 Good-SMF fit through
    K1/K2 and the n=2000 warm smoothed fit through K4, each first run
    twice in one shot (the two runs must agree bit for bit), then killed
    after a checkpoint and resumed by a fresh engine, which must give the
    one-shot fit's bits; the checkpoints must be in the native
    ``tamestore`` format;
15. the forecasts (``predict_forward_with_cov``, ``predict_dyads``) at
    H=5 from the n=2000 fit's state, against the same functions on a CPU
    copy of it;
16. the non-Gaussian mean-field engines at the JAX probes' setting,
    n=1000, T=20, r=2, data drawn on the card from ``ModelConfig(seed=0)``
    with ``family="bernoulli"`` / ``"poisson"``: ``TemporalAMEBernoulliVI``
    (lr 0.8) and ``TemporalAMEPoissonVI`` (lr 0.7) from a random init, 40
    iterations, one K1 launch (B = n T = 20,000, d = 6) and one K2 launch
    per iteration; the Bernoulli fit's predictor must then correlate
    >= 0.95 with the generating one; the Poisson fit, continued by the
    engine's default fit to its stop, must not diverge and reach 0.97;
17. both engines at n=2000, T=50, r=4 from the warm init, 20 iterations
    (K1 at d = 10, B = 100,000): finite, not diverged, the objective
    raised (a positive Poisson objective is reported: the weights' clamp
    binds on these data, ROADMAP C.7);
18. card against CPU at n=40, T=5, r=2 with 30 % of the dyads hidden: the
    Bernoulli, Poisson, smoothed Bernoulli and smoothed Poisson fits on
    the card and on a CPU copy from one init, 60 iterations: the same
    stop and rejected iterations, the objective within 1e-4 relative at
    every iteration, and the same stop again at tolerance 1e-5;
    the smoothed fits launch K4 once per iteration;
19. ``em_scale_probe --binary``: binary EM at n=1000, T=20, r=2 from phi
    0.3, one K4 launch per inner iteration, phi within 0.1 of 0.8;
20. the n=1000 Poisson fit checkpointed, killed and resumed bit for bit,
    as in phase 14;
21. the karate club's masked Poisson fit (20 % hidden) on the card and on
    a CPU copy from the CPU's warm init: the rates within 1e-4 of max,
    the held-out AUC printed beside the degree baseline's;
22. the time-parallel smoother (``tame_torch.ops.ptridiag``) against K4
    on the same systems: one north-star block phase (n=125, T=50, d=10),
    (64, 1024, 10) and (16, 2048, 10) at phi 0.97 with weak information;
    means and covariances within 5e-4, logdets within 1e-4 relative, both
    timed;
23. the n=2000, T=50, r=4 warm smoothed fit in 16 blocks, 10 iterations,
    with ``smoother="sequential"`` (K4, 16 launches per iteration) and
    ``"parallel"`` (no K4 launch): the ELBO within 1e-4 relative at every
    iteration, ms/iteration of both;
24. the joint log-density and its gradient (``log_joint`` over 4 states
    in one batched call) at n=40, T=5, r=2 on the card against the CPU:
    Gaussian, 30 % hidden with NaN coding, Poisson, Bernoulli, within
    1e-5 relative and finite;
25. NUTS at ``scripts/mcmc_bench.py``'s width (n=128, T=16, r=2, 64
    chains as one batch, depth 6), CAVI-preconditioned through K1/K2,
    warmup and draws cut to 600 + 100: log-density split-R-hat <= 1.1,
    mean accept in [0.6, 0.95], median dyad-mean effect size against the
    SMF fit < 0.3; ESS/s and host readbacks per transition printed; then
    HMC at the same width (16 leapfrog steps, 100 + 100): finite, mean
    accept >= 0.5;
26. tempered SMC at ``scripts/smc_bench.py``'s width (n=64, T=8, r=2, 256
    particles, buffer 600, 6 moves x 20 leapfrog, 30 stages per call),
    one replicate, preconditioned through K3: beta reaches 1 inside the
    buffer and the log-evidence lies above the exact ELBO less 3 nats;
27. random-walk moves at that shape with step scales 0.5 and 0.15, 10
    stages each: the mean acceptance printed (ROADMAP C.5);
28. the command line in this process (``tame_torch.cli.main``, its output
    captured): ``fit`` at n=2000, T=50, r=4 (Good SMF, 16-block updates,
    exact diagnostics, <= 150 iterations), 16 K1 and 1 K2 launches per
    iteration; the same fit through the engine alone, whose iterations,
    final ELBO and MSE must equal the CLI's at the printed precision; the
    two in turns (engine, CLI, CLI, engine) for the CLI's overhead and its
    wall-time split (data, init, fit, diagnostics, held-out metric);
29. ``fit --missing-frac 0.3`` at that shape: K1 and K2, held-out MSE
    < 2 x observed + 0.05;
30. ``fit --method smoothed --init warm`` at that shape: 16 K4 launches per
    iteration;
31. ``fit --checkpoint D --checkpoint-every 10 --max-iter 20``, then
    ``--resume --max-iter 40``, against a one-shot ``--max-iter 40``: the
    final checkpoints bit for bit equal and in the ``tamestore`` format;
32. ``fit --method binary`` / ``poisson`` at n=1000, T=20, r=2 with 20 %
    hidden: K1 and K2 only, the held-out accuracy / deviance finite;
33. ``learn`` at n=1000, T=20, r=2, 3 EM iterations: K4, phi moved from 0.3
    toward 0.8;
34. ``sample`` at the CLI's defaults (n=15, T=10, r=2): NUTS (draws cut to
    30 + 30), HMC (50 + 50) and SMC (256 particles), each preconditioned
    through K3 or K1: mean accept finite, SMC's beta reaches 1;
35. ``demo --lr 0.7 --max-iter 150`` (figures into a temporary directory
    where matplotlib is installed): one K3 launch per engine, Naive ~ Good
    << Bad;
36. ``three-way``, ``mult-strength``, ``sensitivity`` (the n_nodes sweep,
    and the missing_frac sweep 0, 0.1, 0.3, 0.5) and ``binary-compare``,
    each at its defaults with ``--no-save``: K3 for Naive, Good and Bad and
    K4 for the smoothed fit; one K3 launch per fit (6); one per replicate
    (30); K3 unmasked and K1 masked; K1, K2 and K4; seconds per fit;
37. the three-way results saved (``save_results``,
    ``generate_experiment_report``) into a temporary directory and loaded
    by a process that sees no card: numpy arrays and Python values only,
    torch not imported; ``three-way`` with its 8 figures there where
    matplotlib is installed, else one line saying they were not drawn;
38. ``python -m tame_torch.quick_test`` on the card: exit 0;
39. ``tame_torch.parallel`` on a one-rank NCCL mesh (``make_mesh()``, an
    in-memory store): the n=2000, T=50, r=4 Good-SMF block fit (16
    blocks, lr 0.8) sharded, beside the plain fit: the same stop, the ELBO
    history within 1e-6 relative, max |dX_mean| printed, 16 K1 and 1 K2
    launches per iteration each and K3 never; then the 100-iteration
    fixed-budget fit on that mesh and the one-rank warm smoothed fit (10
    iterations) as references, and the plain and one-rank fits timed in
    turns (30 iterations each); then, with 30 % of the dyads hidden
    (``hidden_dyads``) and the production flags (bf16 weights, stats
    diagnostics), the masked fit through the bf16 einsum mask and through
    K5 (``TAME_PACKED_MASK=1``), each to its stop, and the masked smoothed
    fit through K4 and K5 (10 iterations), each beside its plain fit and
    bit for bit (means, ELBO history, stop; 32 K5 launches per masked
    block iteration, 48 per masked smoothed iteration, K3 never); the
    masked fits' 30-iteration references; the plain seq sweep at the demo
    shape (30 iterations at most) and the masked Bernoulli and Poisson
    fits at n=1000, T=20, r=2 (20 iterations) as references;
40. two spawned ranks sharing the card (gloo, staged through host memory;
    the kernels built by this process, loaded by the ranks), each drawing
    the data on the card and keeping its rows: the same fit at the fixed
    budget (max |dX_mean| < 5e-4, ELBO within 1e-5 of phase 39's, 16 K1
    and 1 K2 launches per iteration per rank) and to the stop (the same
    iteration on both ranks), ms per iteration and the collectives of one
    iteration counted; then the masked einsum and K5 fits at 30
    iterations against phase 39's (the same bounds; 32 K5 launches per
    iteration per rank) and to the stop (one stop on every rank, printed
    beside the plain fit's), the collectives of one masked iteration; the
    seq sweep on both ranks (the plain fit's stop, ELBO within 1e-5; n T
    K1 launches per iteration on every rank), the masked Bernoulli and
    Poisson fits (5e-4 / 1e-5) and a Poisson fit killed at 8 of 16
    iterations and resumed from the sharded result's carry (the one-shot
    sharded fit's bits);
41. the same with NCCL and one rank per card (up to 4) where the machine
    has 2 cards or more; otherwise a line says it did not run;
42. in those worlds, the warm smoothed fit sharded over nodes: 16 K4
    launches per iteration per rank, ELBO within 1e-5 of phase 39's; and
    the masked smoothed fit through K4 and K5 (16 and 48 launches per
    iteration per rank), ELBO within 1e-5 of phase 39's;
43. in those worlds, the batch axis at ``tests/test_parallel.py``'s sizes:
    HMC 64 chains within 1e-5 of the unsharded run, SMC 64 particles and
    the evidence within 1e-4, NUTS finite with the mean within 0.5;
44. ``tame_torch.scripts.multihost_probe`` and ``multihost_proof`` on the
    card (two processes, gloo): 120, and the proof's bounds.

Phases 22-44 each print their wall time beside the card's name and power
limit; phases 28-38 write only into temporary directories.  Each of
phases 3-44 is a path of its own (phases 7, 11, 13, 14, 16-18, 23, 25,
28-37 and 39-44 several): the launch counters are zeroed just before it
and read just after, and each path must have launched its kernels; a
spawned rank zeroes and reads its own, and its counts join the sums.  K6
lies on no path: its ``launches`` are its comparison launches in phase
2.  The second-to-last line is a JSON object describing each kernel
(``launches`` summed over the paths), the last is the device record.
Needs one CUDA card; without one it exits non-zero before printing any
result.
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

# The K4 paths' ms/iteration, printed beside K4's own times at the end.
K4_PATHS: dict = {}

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


def k4_compare(label: str, k, t, nodes=None) -> float:
    """Require K4's outputs ``k`` within REL_TOL (mean, cov, cross_cov)
    and LOGDET_RTOL (logdet) of the twin's ``t`` on ``nodes`` (all when
    None); returns the largest absolute error."""
    errs = {}
    for name in ("mean", "cov", "cross_cov"):
        got, ref = getattr(k, name), getattr(t, name)
        if nodes is not None:
            got, ref = got[nodes], ref[nodes]
        errs[name] = rel_err(got, ref)
    kl, tl = ((k.logdet, t.logdet) if nodes is None
              else (k.logdet[nodes], t.logdet[nodes]))
    ld_rel = ((kl - tl).abs() / tl.abs()).max().item()
    print(f"K4 {label}: (max_abs_err, rel) {errs}, logdet rel {ld_rel}")
    require(all(e[1] <= REL_TOL for e in errs.values())
            and ld_rel <= LOGDET_RTOL, f"K4 disagrees with its twin at {label}")
    return max(e[0] for e in errs.values())


def phase_smoother_kernel(report: dict) -> None:
    from tame_torch.ops import _ext
    from tame_torch.ops import cholesky as ch
    from tame_torch.ops import fused_smoother as fs

    ext = _ext.load()
    require(all(ext.fused_smoother_smem_bytes(d, w)
                == fs.fused_smoother_smem_bytes(d, w)
                and ext.fused_smoother_warps(n, d) == fs.fused_smoother_warps(n, d)
                for d in (4, 6, 8, 10, 12, 14, 16, 32, 34, ch.MAX_KERNEL_D)
                for w in range(1, fs.MAX_WARPS + 1) for n in (125, 2000)),
            "K4 shared-memory or packing formula differs between Python and "
            "CUDA")
    gen = torch.Generator(device="cuda").manual_seed(1)
    entry = report["fused_smoother"]
    entry["max_abs_err"] = 0.0
    # (i) one block phase of the n=2000 smoothed fit (the reported
    # timing), (ii) one Jacobi sweep at n=2000 (four nodes per block),
    # (iii) the smallest d with T=2, (iv) T=1, where the backward pass is
    # empty and cross_cov is (n, 0, d, d), (v) one block phase of the r = 6
    # smoothed fit, (vi, vii) the edges of one row per lane (d = 32, 34),
    # (viii) a ragged n at the largest d, (ix) one update of the smoothed
    # non-Gaussian families and the binary EM at n=1000, T=20, r=2, (x)
    # the card-against-CPU phase's n=40, T=5.
    for n, T, d in [(125, 50, 10), (2000, 50, 10), (3, 2, 4), (3, 1, 4),
                    (125, 50, 14), (4, 3, 32), (4, 3, 34), (5, 4, 48),
                    (1000, 20, 6), (40, 5, 6)]:
        D, O, b = smoother_system(n, T, d, gen)
        k = fs.fused_smoother_kernel(D, O, b)
        torch.cuda.synchronize()
        t = fs.fused_smoother_twin(D, O, b)
        entry["max_abs_err"] = max(entry["max_abs_err"], k4_compare(
            f"n={n} T={T} d={d}", k, t))
        ms = cuda_ms(lambda: fs.fused_smoother_kernel(D, O, b))
        plain_ms = cuda_ms(lambda: fs.fused_smoother_twin(D, O, b), reps=5,
                           warmup=1)
        # forward: two d x d products, a factor and an inverse per step;
        # backward: three products per step
        flops = n * T * d**3 * (4 + 1 / 3 + 2) + n * (T - 1) * 6 * d**3
        b_ = bound(nbytes(D, O, b, *k), flops, "f32")
        print(f"K4 n={n} T={T} d={d} ({fs.fused_smoother_warps(n, d)} "
              f"nodes per block): kernel {ms} ms, twin {plain_ms} ms, bound "
              f"{b_['bound_ms']} ms ({b_['bound_by']})")
        if "ms" not in entry:
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=None, **b_)
        if (n, T, d) == (125, 50, 14):
            entry["ms_d14"] = ms
        if (n, T, d) == (2000, 50, 10):
            entry["ms_n2000"] = ms
        if (n, T, d) == (1000, 20, 6):
            entry["n1000_T20_d6"] = dict(ms=ms, plain_ms=plain_ms,
                                         library_ms=None, **b_)
    # one node's D made indefinite: NaN for that node, the twin's outputs
    # for the others
    D, O, b = smoother_system(6, 5, 14, gen)
    D[2, 3] = -torch.eye(14, device="cuda")
    k = fs.fused_smoother_kernel(D, O, b)
    torch.cuda.synchronize()
    t = fs.fused_smoother_twin(D, O, b)
    require(all(bool(torch.isnan(x[2]).all()) for x in k),
            "K4 did not give NaN for the indefinite node")
    keep = [0, 1, 3, 4, 5]
    require(all(bool(torch.isfinite(x[keep]).all()) for x in k),
            "K4's indefinite node spoiled another node")
    k4_compare("n=6 T=5 d=14, node 2 indefinite (others)", k, t, keep)
    print(f"K4 summary: n=125 T=50 d=10 {entry['ms']} ms, d=14 "
          f"{entry['ms_d14']} ms, n=2000 d=10 {entry['ms_n2000']} ms")


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


def spd_flops(B: int, d: int, with_inverse: bool = True) -> float:
    """K1's operations (multiply-adds counted twice): the factor d^3 / 3,
    the inverse 2 d^3, the mean 2 d^2 per system; without the inverse the
    factor and the mean only."""
    per = d**3 / 3 + 2 * d * d + (2 * d**3 if with_inverse else 0)
    return 2 * B * per


def phase_kernels(report: dict) -> None:
    """K1 and K2 against their twins.  Their ``ms`` is device time, 20
    launches replayed from one CUDA graph (``spd_probe.graph_ms``): one
    call between two events (``call_ms``) mostly times the host reaching
    the launch."""
    from tame_torch.ops import _ext
    from tame_torch.ops import cholesky as ch
    from tame_torch.scripts.spd_probe import graph_ms

    ext = _ext.load()
    require(all(tuple(ext.spd_geometry(d, nw)) == ch.spd_geometry(d, nw)
                for d in range(ch.MAX_KERNEL_D + 4) for nw in (False, True)),
            "K1/K2 geometry differs between Python and CUDA")
    gen = torch.Generator(device="cuda").manual_seed(0)
    entry = report["spd_solve_inv"]
    entry["max_abs_err"] = 0.0
    # K1 at a block phase of the n=2000 fit (B = 125 * 50; timed), at 8
    # blocks (bench's n=2000 legs) and a Jacobi sweep (n T), a ragged batch
    # at the demo's d, the r = 6 fit's block phase (timed) and a ragged
    # batch, and the padded capacity with two rows per lane (d = 34, 48).
    for d, B, timed in [(10, 6250, True), (10, 12500, False),
                        (10, 100000, False), (6, 1001, False),
                        (6, 20000, True), (14, 6250, True), (14, 1001, False),
                        (34, 1003, False), (48, 1001, False)]:
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
        require(torch.equal(mu1, mu), f"K1's mu-only launch is not bitwise "
                f"its full launch's mu at d={d} B={B}")
        entry["max_abs_err"] = max(entry["max_abs_err"], worst)
        if not timed:
            continue
        t = dict(
            ms=graph_ms(lambda: ch.spd_solve_inv_kernel(P, eta), 10),
            ms_mu_only=graph_ms(lambda: ch.spd_solve_inv_kernel(
                P, eta, with_inverse=False), 10),
            call_ms=cuda_ms(lambda: ch.spd_solve_inv_kernel(P, eta)),
            plain_ms=cuda_ms(lambda: ch.spd_solve_inv_twin(P, eta)),
            library_ms=cuda_ms(lambda: torch.linalg.solve(P, eta)),
            library_inv_ms=cuda_ms(lambda: torch.linalg.inv_ex(P)),
            **bound(nbytes(P, eta, mu, cov), spd_flops(B, d), "f32"))
        print(f"K1 d={d} B={B}: kernel {t['ms']} ms (mu only "
              f"{t['ms_mu_only']}; one call {t['call_ms']}), twin "
              f"{t['plain_ms']} ms, "
              f"torch.linalg.solve (mu only) {t['library_ms']} ms, "
              f"torch.linalg.inv_ex (inverse only) {t['library_inv_ms']} "
              f"ms, bound {t['bound_ms']} ms ({t['bound_by']})")
        if d == 10:
            entry.update(t, library="torch.linalg.solve(P, eta), the "
                         "mu-only function; library_inv_ms: "
                         "torch.linalg.inv_ex(P), the inverse alone")
        elif d == 6:  # the non-Gaussian engines' n=1000, T=20 solve
            entry["d6_B20000"] = t
        else:
            entry[f"ms_d{d}"] = t["ms"]
    # one system made indefinite at the first pivot, one at the third:
    # NaN for those, the twin's values for the others
    for d in (14, 48):
        P, eta = spd_batch(37, d, gen)
        P[5] = -P[5]
        P[20] = torch.eye(d, device="cuda")
        P[20, 2, 2] = -1.0
        outs = (*ch.spd_solve_inv_kernel(P, eta),
                ch.spd_solve_inv_kernel(P, eta, with_inverse=False),
                ch.logdet_spd_kernel(P))
        torch.cuda.synchronize()
        keep = [b for b in range(37) if b not in (5, 20)]
        require(all(bool(torch.isnan(x[[5, 20]]).all())
                    and bool(torch.isfinite(x[keep]).all()) for x in outs),
                f"K1/K2 did not give NaN for the indefinite systems alone "
                f"at d={d}")
        mu_t, cov_t = ch.spd_solve_inv_twin(P, eta)
        errs = [rel_err(outs[0][keep], mu_t[keep]),
                rel_err(outs[1][keep], cov_t[keep]),
                rel_err(outs[3][keep], ch.logdet_spd_twin(P)[keep])]
        print(f"K1/K2 d={d}, systems 5 and 20 indefinite: NaN there; "
              f"others (max_abs_err, rel) {errs}")
        require(all(e[1] <= REL_TOL for e in errs),
                f"K1/K2 disagree with their twins beside an indefinite "
                f"system at d={d}")

    # K2 at the n=2000 entropy batch (n T = 100,000 factors, d = 10; the
    # reported timing), the r = 6 one (d = 14; timed), ragged batches and
    # the padded capacity.
    entry = report["logdet_spd"]
    entry["max_abs_err"] = 0.0
    for d, B, timed in [(10, 100000, True), (6, 20000, True),
                        (14, 100000, True), (14, 1001, False),
                        (34, 1003, False), (48, 1001, False)]:
        P, _ = spd_batch(B, d, gen)
        ld, ld_t = ch.logdet_spd_kernel(P), ch.logdet_spd_twin(P)
        torch.cuda.synchronize()
        err, rel = rel_err(ld, ld_t)
        print(f"K2 d={d} B={B}: max_abs_err {err} rel {rel}")
        require(rel <= REL_TOL, f"K2 disagrees with its twin at d={d} B={B}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if not timed:
            continue
        t = dict(ms=graph_ms(lambda: ch.logdet_spd_kernel(P), 10),
                 call_ms=cuda_ms(lambda: ch.logdet_spd_kernel(P)),
                 plain_ms=cuda_ms(lambda: ch.logdet_spd_twin(P)),
                 library_ms=cuda_ms(lambda: torch.logdet(P)),
                 **bound(nbytes(P, ld), 2 * B * d**3 / 3, "f32"))
        print(f"K2 d={d} B={B}: kernel {t['ms']} ms (one call "
              f"{t['call_ms']}), twin {t['plain_ms']} "
              f"ms, torch.logdet {t['library_ms']} ms, bound "
              f"{t['bound_ms']} ms ({t['bound_by']})")
        if d == 10:
            entry.update(t)
        elif d == 6:  # the non-Gaussian engines' n=1000, T=20 entropy
            entry["d6_B20000"] = t
        else:
            entry[f"ms_d{d}"] = t["ms"]


def k3_compare(label: str, args, kw) -> float:
    """Runs K3 and its twin on ``args``; requires the same stop, the ELBO
    history within REL_TOL, the state within STATE_ATOL and NaN past the
    stop; returns the largest state error."""
    from tame_torch.ops import fused_fit as ff

    k = ff.fused_fit_kernel(*args, **kw)
    t = ff.fused_fit_twin(*args, **kw)
    torch.cuda.synchronize()
    n = t.n_iter
    eh_k, eh_t = k.elbo_history[:n], t.elbo_history[:n]
    h_rel = ((eh_k - eh_t).abs() / eh_t.abs()).max().item()
    xm_err = (k.X_mean - t.X_mean).abs().max().item()
    xc_err = (k.X_cov - t.X_cov).abs().max().item()
    print(f"K3 {label}: n_iter {k.n_iter}/{t.n_iter} converged "
          f"{k.converged}/{t.converged} elbo rel {h_rel} X_mean {xm_err} "
          f"X_cov {xc_err}")
    require(k.n_iter == t.n_iter and k.converged == t.converged
            and k.diverged == t.diverged, f"K3 stop differs from twin at "
            f"{label}")
    require(h_rel <= REL_TOL and xm_err <= STATE_ATOL
            and xc_err <= STATE_ATOL, f"K3 disagrees with its twin at {label}")
    require(bool(torch.isnan(k.elbo_history[k.n_iter:]).all()),
            f"K3 history past the stop is not NaN at {label}")
    if args[9] > 0.0:  # the tolerance
        require(k.converged and k.n_iter < args[7],
                f"K3 stopping-rule case did not stop early at {label}")
    return max(xm_err, xc_err)


def phase_fused_fit(report: dict) -> None:
    """K3 against its twin: the 15-block demo fit (every structure,
    corrected, the stopping rule), every d in FUSED_DIMS (Jacobi and 4
    blocks), ``bench``'s 150-iteration Jacobi fit and the n=100, T=10,
    10-block fit whose data stay in device memory; then the bare launch
    and the wrapper timed at both demo shapes."""
    from tame_torch.inference import cavi
    from tame_torch.models import TemporalAMEModel
    from tame_torch.ops import _ext
    from tame_torch.ops import fused_fit as ff
    from tame_torch.scripts import fused_fit_probe as probe

    ext = _ext.load()
    for shape in [(15, 10, 6, 15), (15, 10, 6, 1), (100, 10, 6, 10),
                  (8, 4, 12, 1), (2000, 50, 10, 16)]:
        layout = ff.fused_fit_layout(*shape)
        want = ff.fused_fit_smem_bytes(*shape, layout) if layout >= 0 else 0
        require(tuple(ext.fused_fit_layout(*shape)) == (layout, want),
                f"K3 layout rule differs between Python and CUDA at {shape}")
    entry = report["fused_fit"]
    entry["max_abs_err"] = 0.0

    def fit(n, T, r, seed, structure, max_iter, lr, tol, num_blocks,
            corrected=False):
        model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=r,
                                 seed=seed)
        Y = model.generate_data(device="cuda")
        p = model.params.to("cuda")
        init = cavi.init_state(torch.Generator().manual_seed(3), n, T,
                               2 + 2 * r, structure, 0.1, 0.5,
                               device="cuda")
        args = (Y, p.R_inv, p.Sigma0, p.Q, p.Phi, init.X_mean, init.X_cov,
                max_iter, lr, tol)
        return args, dict(r=r, buf_size=64 if max_iter <= 64 else 256,
                          structure=structure, corrected=corrected,
                          num_blocks=num_blocks)

    cases = [(f"15-block demo {s} corrected={c} tol={tol}",
              fit(15, 10, 2, 7, s, 25 if tol == 0.0 else 150, 0.7, tol, 15,
                  c))
             for s, c, tol in [("full", False, 0.0), ("full", True, 0.0),
                               ("diag", False, 0.0), ("block", False, 0.0),
                               ("full", False, 1e-3)]]
    for d in ff.FUSED_DIMS:
        r = (d - 2) // 2
        cases += [(f"d={d} n=12 T=5 Jacobi full", fit(12, 5, r, d, "full",
                                                      20, 0.7, 0.0, 1)),
                  (f"d={d} n=12 T=5 4 blocks full corrected",
                   fit(12, 5, r, d, "full", 20, 0.7, 0.0, 4, True))]
    cases.append(("n=100 T=10 d=6 10 blocks (data in device memory)",
                  fit(100, 10, 2, 5, "full", 25, 0.7, 0.0, 10)))
    demo, jacobi = probe.fit_shapes(torch.device("cuda"))
    for label, args, kw in (demo, jacobi):
        kw = dict(kw, r=2, buf_size=256, structure="full", corrected=False)
        cases.append((label, (args, kw)))
    for label, (args, kw) in cases:
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   k3_compare(label, args, kw))

    times = {}
    for label, args, kw in (demo, jacobi):
        kw = dict(kw, r=2, buf_size=256, structure="full", corrected=False)
        times[label] = probe.time_fit(args, kw, repeats=10)
        print(f"K3 {label}: bare launch {times[label]['bare_ms']} ms, "
              f"wrapper {times[label]['wrapper_ms']} ms")
    args, kw = demo[1], dict(demo[2], r=2, buf_size=256, structure="full",
                             corrected=False)
    k = ff.fused_fit_kernel(*args, **kw)
    Y = args[0]
    entry.update(
        ms=times[demo[0]]["bare_ms"],
        wrapper_ms=times[demo[0]]["wrapper_ms"],
        jacobi150_ms=times[jacobi[0]]["bare_ms"],
        jacobi150_wrapper_ms=times[jacobi[0]]["wrapper_ms"],
        plain_ms=cuda_ms(lambda: ff.fused_fit_twin(*args, **kw), reps=3,
                         warmup=1),
        library_ms=None,
        # each input read once (Y, R^-1, the priors, the initial state),
        # each output written once (the state, both histories, the stats)
        **bound(nbytes(*args[:7]) + nbytes(k.X_mean, k.X_cov)
                + 4 * (2 * kw["buf_size"] + 5),
                fused_fit_flops(15, 10, 6, 15, k.n_iter), "f32"))
    # the same for bench's Jacobi fit (one block phase per iteration)
    args, kw = jacobi[1], dict(jacobi[2], r=2, buf_size=256,
                               structure="full", corrected=False)
    k = ff.fused_fit_kernel(*args, **kw)
    jb = bound(nbytes(*args[:7]) + nbytes(k.X_mean, k.X_cov)
               + 4 * (2 * kw["buf_size"] + 5),
               fused_fit_flops(15, 10, 6, 1, k.n_iter), "f32")
    entry.update(
        jacobi150_plain_ms=cuda_ms(lambda: ff.fused_fit_twin(*args, **kw),
                                   reps=3, warmup=1),
        jacobi150_bound_ms=jb["bound_ms"], jacobi150_bound_by=jb["bound_by"])
    print(f"K3 25-iteration 15-block fit: kernel {entry['ms']} ms (wrapper "
          f"{entry['wrapper_ms']}), twin {entry['plain_ms']} ms, bound "
          f"{entry['bound_ms']} ms; 150-iteration Jacobi fit: kernel "
          f"{entry['jacobi150_ms']} ms (wrapper "
          f"{entry['jacobi150_wrapper_ms']}), twin "
          f"{entry['jacobi150_plain_ms']} ms, bound "
          f"{entry['jacobi150_bound_ms']} ms ({jb['bound_by']})")


def phase_demo() -> None:
    from tame_torch import TemporalAMENaiveMFVI, TemporalAMEStructuredMFVI

    model = demo_model("cuda")
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


def phase_real_size() -> int:
    """Returns the number of iterations run."""
    from tame_torch import TemporalAMEStructuredMFVI

    model = north_star_model()
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
    return n_iter


def phase_smoothed() -> int:
    """Returns the number of iterations run."""
    from tame_torch import TemporalAMESmoothedVI

    model = north_star_model()
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
    block when ``on``; otherwise unset, and ``cavi.use_packed_mask`` held
    to the einsum, whose bf16 path the card's masked fits under
    ``mixed_precision`` leave for K5 by default; the old values are
    restored."""
    from tame_torch.inference import cavi

    old = os.environ.pop("TAME_PACKED_MASK", None)
    route = cavi.use_packed_mask
    if on:
        os.environ["TAME_PACKED_MASK"] = "1"
    else:
        cavi.use_packed_mask = lambda *args, **kwargs: False
    try:
        yield
    finally:
        cavi.use_packed_mask = route
        os.environ.pop("TAME_PACKED_MASK", None)
        if old is not None:
            os.environ["TAME_PACKED_MASK"] = old


def phase_contract_kernels(report: dict) -> None:
    """K5 and K6 against their twins on CUDA inputs, timed beside the
    bf16 ``bmm`` that computes the same products.  Their ``ms`` is device
    time, launches replayed from one CUDA graph
    (``contract_probe.rotating_graph_ms``), K5's block stripes in rotation
    over the 16 stripes of the mask (or a sharded rank's 16 shares), so
    each arrives cold as in a block sweep; ``call_ms`` is one wrapper call
    between two events.  K6's two
    launches on the same inputs must give the same bits."""
    from tame_torch.inference import cavi
    from tame_torch.models import random_dyad_mask
    from tame_torch.ops import dual_contract as dc
    from tame_torch.ops import masked_contract as mc
    from tame_torch.scripts.contract_probe import rotating_graph_ms

    gen = torch.Generator(device="cuda").manual_seed(2)
    n, T, r = 2000, 50, 4
    mask = hidden_dyads(n, T)
    U, V = (0.5 * torch.randn(n, T, r, device="cuda", generator=gen)
            for _ in range(2))
    panels = {57: cavi._masked_panel(U, V),          # precision panel
              56: torch.randn(n, T, 56, device="cuda", generator=gen)}
    small = random_dyad_mask(gen, 20, 3, MISSING_FRAC)
    # (label, stripes checked, stripes timed in rotation, panel): one
    # n=2000 block phase (16 blocks, bs=125) with the precision and the
    # stats panel, the ragged n=20 case (every stripe) and the full n=2000
    # mask as one stripe.
    # The sharded path's stripes: on two nodes ranks (rows cyclic), rank
    # k's share of block b is its rows of [125 b, 125 b + 125), 63 or 62
    # of them, packed by pack_rows as sharded_cavi.rank_inputs packs them;
    # rank 0's 16 stripes in rotation, as its block sweep reads them.
    blocks = list(mc.pack_mask(mask, 16))
    shares = [[slice(lo + (k - lo) % 2, lo + 125, 2)
               for lo in range(0, n, 125)] for k in range(2)]
    rank0 = mc.pack_rows(mask, shares[0])
    ragged = [rank0[0], mc.pack_rows(mask, shares[1][:1])[0]]  # 63, 62
    small_stripes = list(mc.pack_mask(small, 4))
    whole = [mc.pack_mask(mask, 1)[0]]
    cases = [("n=2000 bs=125 K=57", blocks[:1], blocks, panels[57]),
             ("n=2000 bs=125 K=56", blocks[:1], blocks, panels[56]),
             ("n=2000 rank share 63/62 rows K=57", ragged, rank0,
              panels[57]),
             ("n=2000 rank share 63/62 rows K=56", ragged, rank0,
              panels[56]),
             ("n=20 T=3 K=5 nb=4", small_stripes, small_stripes,
              torch.randn(20, 3, 5, device="cuda", generator=gen)),
             ("n=2000 one stripe K=57", whole, whole, panels[57])]
    entry = report["masked_contract"]
    entry["max_abs_err"] = 0.0
    for label, stripes, rotation, Z in cases:
        err = rel = 0.0
        for Mp in stripes:
            got = mc.packed_rows_contract_kernel(Mp, Z)
            torch.cuda.synchronize()
            e, rl = rel_err(got, mc.packed_rows_contract_twin(Mp, Z))
            require(rl <= REL_TOL, f"K5 disagrees with its twin at {label}")
            err, rel = max(err, e), max(rel, rl)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        Mp = stripes[0]
        ms = rotating_graph_ms(
            [lambda M=M: mc.packed_rows_contract_kernel(M, Z)
             for M in rotation], 10, max(20, 2 * len(rotation)))
        call_ms = cuda_ms(lambda: mc.packed_rows_contract_kernel(Mp, Z))
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
        print(f"K5 {label}: max_abs_err {err} rel {rel}; kernel {ms} ms "
              f"(device, {len(rotation)} stripes in rotation), one call "
              f"{call_ms} ms, twin {plain_ms} ms, bf16 bmm {lib_ms} ms, "
              f"bound {b['bound_ms']} ms ({b['bound_by']})")
        if "ms" not in entry:  # the path's shape: one block phase
            entry.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **b)
        if label.startswith("n=2000 rank share") and "sharded" not in entry:
            # the sharded path's shape: a rank's 63-row share of a block
            entry["sharded"] = dict(rows=Mp.shape[1], ms=ms,
                                    call_ms=call_ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, **b)
        del Mb, Zb
    del blocks, rank0, ragged, small_stripes, whole

    entry = report["dual_contract"]
    entry.update(max_abs_err=0.0, launches=0)
    # the probe's shape, the ragged n=20 case, m = 40 in slices of 16, 16
    # and 8, and a ragged n with m = 13
    for T_, n_, m in [(50, 2000, 8), (3, 20, 4), (50, 2000, 40), (3, 37, 13)]:
        Wp = dc.pad_data(torch.randn(T_, n_, n_, device="cuda",
                                     generator=gen))
        Z = torch.randn(T_, n_, m, device="cuda", generator=gen)
        before = dc.dual_contract_kernel.launches
        row, col = dc.dual_contract_padded(Wp, Z)
        again = dc.dual_contract_padded(Wp, Z)
        # K6 lies on no path: its launches are these comparison launches
        # (not the timing loops'), one per 16-column slice of Z
        entry["launches"] += dc.dual_contract_kernel.launches - before
        torch.cuda.synchronize()
        require(torch.equal(again[0], row) and torch.equal(again[1], col),
                f"K6's two launches differ at T={T_} n={n_} m={m}")
        row_t, col_t = dc.dual_contract_twin(Wp, Z)
        errs = [rel_err(row, row_t), rel_err(col, col_t)]
        require(all(e[1] <= REL_TOL for e in errs),
                f"K6 disagrees with its twin at T={T_} n={n_} m={m}")
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [e[0] for e in errs])
        ms = rotating_graph_ms([lambda: dc.dual_contract_kernel(Wp, Z)], 10,
                               20)
        call_ms = cuda_ms(lambda: dc.dual_contract_kernel(Wp, Z))
        plain_ms = cuda_ms(lambda: dc.dual_contract_twin(Wp, Z), reps=5,
                           warmup=1)
        Wb = Wp[..., :n_]
        Zb = Z.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: (
            torch.bmm(Wb, Zb, out_dtype=torch.float32),
            torch.bmm(Wb.transpose(1, 2), Zb, out_dtype=torch.float32)))
        b = bound(nbytes(Wp, Z, row, col), 2 * 2 * T_ * n_ * n_ * m, "bf16")
        print(f"K6 T={T_} n={n_} m={m}: (max_abs_err, rel) row/col {errs}; "
              f"two launches bitwise equal; kernel {ms} ms (device), one "
              f"call {call_ms} ms, twin {plain_ms} ms, two bf16 bmm {lib_ms}"
              f" ms, bound {b['bound_ms']} ms ({b['bound_by']})")
        if "ms" not in entry:
            entry.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **b)
        del Wp, Wb, row, col, again, row_t, col_t
    # two launches of each call: one slice each, three at m = 40
    require(entry["launches"] == 2 * (1 + 1 + 3 + 1), "K6 did not launch "
            "once per slice")


def phase_eta_kernel(report: dict) -> None:
    """K7 against its twin at the engines' shapes and ragged ones: a block
    phase's 125-row stripes of the n=2000, T=50 weights in float32 and in
    bf16 against a panel that is a strided view of a state's means (R = r
    at r = 4 and 6), the whole bf16 matrix against the stats diagnostics'
    two halves (4r = 16 columns at r = 4, 24 at r = 6) and the probe's
    R = 4, the quick start's one-row stripes (n=15, T=10, R=2) and n=37.
    ``ms`` is device time from one CUDA graph replayed
    (``contract_probe.rotating_graph_ms``), a phase's 16 stripes in
    rotation so that each arrives cold as in a block sweep; ``call_ms``
    one wrapper call between two events.  The entry's own numbers are
    the float32 stripe's (the float32 north star's path); ``shapes``
    holds each case's."""
    from tame_torch.ops import eta_contract as ec
    from tame_torch.scripts.contract_probe import rotating_graph_ms

    gen = torch.Generator(device="cuda").manual_seed(3)
    entry = report["eta_contract"]
    entry["max_abs_err"] = 0.0
    entry["shapes"] = {}
    n, T = 2000, 50
    Wf = torch.randn(T, n, n, device="cuda", generator=gen)
    Wb = Wf.to(torch.bfloat16)

    def panel(n_, T_, r, cols):
        """Columns ``cols`` of a (n, T, 2 + 2r) state's means."""
        X = torch.randn(n_, T_, 2 + 2 * r, device="cuda", generator=gen)
        return X[..., cols]

    def stripes(W, bs):
        return [W[:, lo:lo + bs] for lo in range(0, W.shape[1], bs)]

    small = torch.randn(10, 15, 15, device="cuda", generator=gen)
    ragged = torch.randn(3, 37, 37, device="cuda", generator=gen)
    cases = [("f32 stripe 125 of n=2000 T=50 R=4", stripes(Wf, 125),
              panel(n, T, 4, slice(6, 10))),
             ("bf16 stripe 125 of n=2000 T=50 R=4", stripes(Wb, 125),
              panel(n, T, 4, slice(6, 10))),
             ("f32 stripe 125 of n=2000 T=50 R=6 (r=6)", stripes(Wf, 125),
              panel(n, T, 6, slice(8, 14))),
             ("bf16 whole n=2000 T=50 R=16 (stats halves)", [Wb],
              torch.randn(n, T, 16, device="cuda", generator=gen)),
             ("bf16 whole n=2000 T=50 R=24 (r=6 halves)", [Wb],
              torch.randn(n, T, 24, device="cuda", generator=gen)),
             ("bf16 whole n=2000 T=50 R=4 (the probe's)", [Wb],
              panel(n, T, 4, slice(6, 10))),
             ("f32 stripe 1 of n=15 T=10 R=2", stripes(small, 1),
              panel(15, 10, 2, slice(4, 6))),
             ("bf16 whole n=37 T=3 R=1", [ragged.to(torch.bfloat16)],
              torch.randn(37, 3, 1, device="cuda", generator=gen)),
             ("f32 stripe 12 of n=37 T=3 R=16", stripes(ragged, 12),
              torch.randn(37, 3, 16, device="cuda", generator=gen))]
    for label, rotation, Z in cases:
        err = rel = 0.0
        for W in rotation[:2] + rotation[-1:]:
            got = ec.eta_contract_kernel(W, Z)
            torch.cuda.synchronize()
            e, rl = rel_err(got, ec.eta_contract_twin(W, Z))
            require(rl <= REL_TOL, f"K7 disagrees with its twin at {label}")
            err, rel = max(err, e), max(rel, rl)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        W = rotation[0]
        ms = rotating_graph_ms(
            [lambda W=W: ec.eta_contract_kernel(W, Z) for W in rotation], 10,
            max(20, 2 * len(rotation)))
        call_ms = cuda_ms(lambda: ec.eta_contract_kernel(W, Z))
        plain_ms = cuda_ms(lambda: ec.eta_contract_twin(W, Z), reps=5,
                           warmup=1)
        m_, R = W.shape[1], Z.shape[2]
        # the stripe's weights, the panel and the sums, each once
        b = bound(W.element_size() * W.numel()
                  + 4 * (Z.shape[0] + m_) * W.shape[0] * R,
                  2 * W.numel() * R, "f32")
        line = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, rel=rel, **b)
        if label.startswith("bf16 whole n=2000 T=50 R=4"):
            Wc, Zb = W.contiguous(), Z.to(torch.bfloat16).transpose(
                0, 1).contiguous()
            line["library_ms"] = cuda_ms(
                lambda: torch.bmm(Wc, Zb, out_dtype=torch.float32))
            del Wc, Zb
        print(f"K7 {label}: max_abs_err {err} rel {rel}; kernel {ms} ms "
              f"(device, {len(rotation)} in rotation), one call {call_ms} "
              f"ms, twin {plain_ms} ms"
              + (f", bf16 bmm {line['library_ms']} ms"
                 if "library_ms" in line else "")
              + f", bound {b['bound_ms']} ms ({b['bound_by']})", flush=True)
        entry["shapes"][label] = line
        if "ms" not in entry:  # the float32 stripe
            entry.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms, **b)
    del Wf, Wb


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


def check_history(label: str, h: dict, n_iter: int, ms: float) -> float:
    """Checks a fixed-length fit's history; returns its ms/iteration."""
    mse = h["reconstruction_error"]
    print(f"{label}: {len(h['elbo'])} iterations, {ms / len(h['elbo'])} "
          f"ms/iteration, ELBO {h['elbo'][0]} -> {h['elbo'][-1]}, MSE "
          f"{mse[0]} -> {mse[-1]}")
    require(len(h["elbo"]) == n_iter, f"{label} stopped early")
    require(all(math.isfinite(v) for v in h["elbo"] + mse),
            f"non-finite {label} history")
    require(mse[-1] < mse[0] and h["elbo"][-1] > h["elbo"][0],
            f"{label} did not improve its fit")
    return ms / len(h["elbo"])


def phase_high_rank_good(model) -> int:
    """An r = 6 Good-SMF fit (16 blocks, exact diagnostics) of 20
    iterations through K1 and K2 at d = 14."""
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
    through K4 at d = 14."""
    from tame_torch import TemporalAMESmoothedVI

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    vi = TemporalAMESmoothedVI(model, init_mode="warm", learning_rate=0.8)
    start.record()
    h = vi.fit(max_iter=20, tolerance=0.0, verbose=False)
    end.record()
    end.synchronize()
    K4_PATHS["r6_smoothed_ms_per_iter"] = check_history(
        "n=2000 T=50 r=6 smoothed (warm init)", h, 20,
        start.elapsed_time(end))
    return 20


def phase_bench() -> dict:
    from tame_torch.scripts import bench

    res = bench.main(["--n-fits", "32", "--repeats", "2"])
    K4_PATHS["bench_n2000_smoothed_ms_per_iter"] = res[
        "n2000_smoothed_ms_per_iter"]
    return res


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
    return north_star_model(), hidden_dyads(2000, 50)


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


# ---------------------------------------------------------------------------
# The seq sweep, checkpointed fits and forecasts
# ---------------------------------------------------------------------------

SEQ_ELBO_RTOL = 1e-4  # card vs CPU seq fit: f32 sums in another order
FORECAST_RTOL = 1e-5  # card vs CPU forecast: a few f32 products
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
SEQ_MS: dict = {}
SEQ_DEMO_ITERS = 50  # Naive/Good at MSE 0.261, Bad at 1.36 by then (CPU)
CKPT: dict = {}


def demo_model(device: str):
    """The demo drive's data (``TemporalAMEModel(15, 10, 2, seed=42)``
    drawn from a CPU generator) on ``device``."""
    from tame_torch import TemporalAMEModel

    model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2, seed=42,
                             device="cpu")
    model.generate_data(generator=torch.Generator().manual_seed(42),
                        device=device)
    return model


def seq_engines(model):
    from tame_torch import TemporalAMENaiveMFVI, TemporalAMEStructuredMFVI

    return [("naive", TemporalAMENaiveMFVI(model, learning_rate=0.7,
                                           update_mode="seq")),
            ("good", TemporalAMEStructuredMFVI(
                model, factorization="good", learning_rate=0.7,
                update_mode="seq")),
            ("bad", TemporalAMEStructuredMFVI(
                model, factorization="bad", learning_rate=0.7,
                update_mode="seq"))]


def phase_seq(name: str):
    """One seq fit (50 iterations at most; the demo's 150 cut for the
    script's time) at the demo shape on the card,
    held to the same fit on the CPU from the same data and init; returns
    (its iterations, its final MSE, whether it diverged)."""
    card = dict(seq_engines(demo_model("cuda")))[name]
    cpu = dict(seq_engines(demo_model("cpu")))[name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = card.fit(max_iter=SEQ_DEMO_ITERS, verbose=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(h["elbo"])
    hc = cpu.fit(max_iter=SEQ_DEMO_ITERS, verbose=False)
    m = min(len(h["elbo"]), len(hc["elbo"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(h["elbo"][:m],
                                                  hc["elbo"][:m]))
    SEQ_MS[name] = ms
    print(f"seq {name} (n=15 T=10 r=2, lr 0.7): card {len(h['elbo'])} "
          f"iterations (converged {card._converged}, diverged "
          f"{card._diverged}), CPU {len(hc['elbo'])} iterations; ELBO "
          f"{h['elbo'][-1]} (CPU {hc['elbo'][-1]}), MSE "
          f"{h['reconstruction_error'][-1]}; max relative ELBO difference "
          f"over {m} iterations {rel}; {ms} ms/iteration on the card (host "
          f"clock)")
    require(rel <= SEQ_ELBO_RTOL, f"seq {name} on the card departs from the "
            f"CPU fit: {rel}")
    require(all(math.isfinite(v) for v in h["elbo"]) or card._diverged,
            f"seq {name} history not finite")
    return len(h["elbo"]), h["reconstruction_error"][-1], card._diverged


def _same_values(a: list, b: list) -> bool:
    """Equal lengths and equal floats, NaN equal to NaN (the Poisson
    engine's deviance is NaN on its rejected iterations)."""
    return len(a) == len(b) and all(
        x == y or (math.isnan(x) and math.isnan(y)) for x, y in zip(a, b))


def _bitwise(label: str, a, b) -> None:
    """Require two engines' histories and states bit for bit equal."""
    require(a.history.keys() == b.history.keys()
            and all(_same_values(a.history[k], b.history[k])
                    for k in a.history), f"{label}: histories differ")
    for name in a.state_dict():
        require(torch.equal(getattr(a, name), getattr(b, name)),
                f"{label}: {name} differs")


def killed_and_resumed(make, label: str, total: int, every: int,
                       kill: int, counter=None):
    """The one-shot fit twice (bit for bit equal), then a fit killed after
    ``kill`` iterations in segments of ``every`` and resumed to ``total``
    by a fresh engine, which must give the one-shot bits.  Returns the
    resumed engine and, given ``counter`` (a kernel wrapper), its launches
    in the killed and the resumed fit."""
    import shutil

    ref = [make() for _ in range(2)]
    for vi in ref:
        vi.fit(max_iter=total, tolerance=0.0, verbose=False)
    _bitwise(f"{label}: two one-shot fits", ref[0], ref[1])
    ckpt = CKPT_DIR / label.replace(" ", "_")
    shutil.rmtree(ckpt, ignore_errors=True)
    before = counter.launches if counter is not None else 0
    make().fit(max_iter=kill, tolerance=0.0, verbose=False,
               checkpoint_every=every, ckpt_dir=ckpt)
    vi = make()
    vi.fit(max_iter=total, tolerance=0.0, verbose=False,
           checkpoint_every=every, ckpt_dir=ckpt, resume=True)
    launches = counter.launches - before if counter is not None else None
    require(len(vi.history["elbo"]) == total, f"{label}: resumed fit ran "
            f"{len(vi.history['elbo'])} iterations, not {total}")
    _bitwise(f"{label}: killed at {kill} and resumed", vi, ref[0])
    manifest = json.loads((ckpt / "manifest.json").read_text())
    require(manifest["format"] == "tamestore",
            f"{label}: checkpoint written as {manifest['format']}")
    print(f"{label}: two one-shot fits of {total} iterations bit for bit "
          f"equal; killed after {kill} (segments of {every}), resumed to "
          f"{total}: bit for bit the one-shot fit (history, "
          f"{', '.join(vi.state_dict())}); checkpoint format "
          f"{manifest['format']}")
    return vi, launches


def phase_ckpt_k3() -> None:
    """The demo's Good-SMF fit (15 blocks) killed at 10 and resumed to 20
    in segments of 5: one K3 launch per segment."""
    from tame_torch import TemporalAMEStructuredMFVI
    from tame_torch.ops import fused_fit as ff

    model = demo_model("cuda")
    _, launches = killed_and_resumed(
        lambda: TemporalAMEStructuredMFVI(model, learning_rate=0.7),
        "checkpointed demo Good SMF (K3)", 20, 5, 10, ff.fused_fit_kernel)
    print(f"checkpointed demo: {launches} K3 launches in the killed and the "
          f"resumed fit")
    require(launches == 4, f"the killed and resumed demo fit launched K3 "
            f"{launches} times, not once per segment (4)")


def north_star_model():
    from tame_torch import TemporalAMEModel

    model = TemporalAMEModel(n_nodes=2000, n_time=50, latent_dim=4, seed=0)
    model.generate_data(
        generator=torch.Generator(device="cuda").manual_seed(0))
    return model


def phase_ckpt_unfused(model):
    """The n=2000 Good-SMF fit (16 blocks, exact diagnostics) killed at
    20 and resumed to 30 in segments of 10; then one synchronous save of
    its state, timed."""
    from tame_torch import TemporalAMEStructuredMFVI

    vi, _ = killed_and_resumed(
        lambda: TemporalAMEStructuredMFVI(model, learning_rate=0.8),
        "checkpointed n=2000 Good SMF (K1/K2)", 30, 10, 20)
    path = CKPT_DIR / "n2000_save"
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vi.save_checkpoint(path)
        times.append((time.perf_counter() - t0) * 1e3)
    mb = sum(f.stat().st_size for f in path.iterdir()) / 1e6
    CKPT.update(save_ms=times, size_mb=mb)
    print(f"n=2000 T=50 r=4 checkpoint: {mb} MB, save {times} ms (host "
          f"clock: device to host, CRC32 and write)")
    return vi


def phase_ckpt_smoothed(model):
    from tame_torch import TemporalAMESmoothedVI

    killed_and_resumed(
        lambda: TemporalAMESmoothedVI(model, init_mode="warm",
                                      learning_rate=0.8),
        "checkpointed n=2000 smoothed (K4)", 12, 4, 8)


def phase_forecast(vi) -> None:
    """H=5 forecasts from the n=2000 fit on the card against the same
    functions on a CPU copy of its last states."""
    from tame_torch.inference.engine import forecast_dyads, forecast_states

    mus, covs = vi.predict_forward_with_cov(5)
    mean, std = vi.predict_dyads(5)
    torch.cuda.synchronize()
    p = vi.params.to("cpu")
    cmus, ccovs = forecast_states(vi.X_mean[:, -1].cpu(),
                                  vi.X_cov[:, -1].cpu(), p, 5)
    cmean, cstd = forecast_dyads(cmus, ccovs, p.R)
    errs = {k: rel_err(a.cpu(), b)[1] for k, a, b in [
        ("means", mus, cmus), ("covs", covs, ccovs), ("dyad mean", mean,
                                                      cmean),
        ("dyad std", std, cstd)]}
    print(f"forecast n=2000 H=5: relative difference card vs CPU {errs}; "
          f"std {std.min().item()} .. {std.max().item()}")
    require(all(e <= FORECAST_RTOL for e in errs.values()),
            f"the card's forecast departs from the CPU's: {errs}")
    require(bool(torch.isfinite(std).all() and (std > 0).all()),
            "forecast std not finite and positive")


# ---------------------------------------------------------------------------
# The non-Gaussian families: K1 and K2 in the mean-field engines, K4 in the
# smoothed families and the binary EM
# ---------------------------------------------------------------------------

FAMILY_ELBO_RTOL = 1e-4   # card vs CPU objective, every iteration
KARATE_RATE_RTOL = 1e-4   # card vs CPU fitted rates, against max |rate|
FAMILY: dict = {}          # the paths' numbers, printed at the end


def family_model(family: str, n: int, T: int, r: int, seed: int = 0):
    """A ``TemporalAMEModel`` whose data are ``family`` ties drawn on the
    card from ``ModelConfig(seed=seed)``; ``X`` holds the latents."""
    from tame_torch import TemporalAMEModel
    from tame_torch.models import sample

    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=r, seed=seed)
    model.Y, model.X = sample(model.params.to("cuda"), torch.Generator(
        device="cuda").manual_seed(seed), n, T, family=family)
    return model


def family_engine(family: str, model, **kw):
    from tame_torch.inference import (TemporalAMEBernoulliVI,
                                      TemporalAMEPoissonVI)

    if family == "bernoulli":
        return TemporalAMEBernoulliVI(model, learning_rate=0.8, **kw)
    return TemporalAMEPoissonVI(model, learning_rate=0.7, **kw)


def timed_fit(vi, **kw):
    """``vi.fit(**kw)`` between CUDA events: (history, ms/iteration)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    h = vi.fit(verbose=False, **kw)
    end.record()
    end.synchronize()
    return h, start.elapsed_time(end) / len(h["elbo"])


def rejected_count(h: dict) -> int:
    return sum(math.isnan(v) for v in h.get("deviance", []))


def phase_family_full_size(family: str) -> int:
    """The JAX probes' setting: n=1000, T=20, r=2, random init, 40
    iterations at tolerance 0 (lr 0.8 Bernoulli, 0.7 Poisson).  The
    Bernoulli fit's predictor must then correlate >= 0.95 with the
    generating one.  The Poisson fit is then continued by the engine's
    default fit (<= 200 iterations to tolerance 1e-5) and must not diverge
    and reach 0.97 at its stop: from a random init the guard rejects the
    first iterations on this realization and the step scale grows back
    x1.25 per step, so 40 iterations leave it short
    of 0.97, as the JAX algorithm is on the same data; both correlations
    are printed.  Returns the iterations run."""
    from tame_torch.scripts._common import predictor_corr

    model = family_model(family, 1000, 20, 2)
    vi = family_engine(family, model, init_mode="random")
    h, ms = timed_fit(vi, max_iter=40, tolerance=0.0)
    corr = predictor_corr(model.X, vi.X_mean, 2)
    key2 = "accuracy" if family == "bernoulli" else "deviance"
    out = FAMILY[f"{family}_n1000"] = dict(ms_per_iter=ms, corr40=corr,
                                           rejected=rejected_count(h))
    print(f"{family} n=1000 T=20 r=2 (random init, 40 iterations): {ms} "
          f"ms/iteration (CUDA events over fit()), correlation with the "
          f"generating predictor {corr}, {key2} {h[key2][-1]}, bound/ELBO "
          f"{h['elbo'][0]} -> {h['elbo'][-1]}, rejected iterations "
          f"{rejected_count(h)}, diverged {vi._diverged}")
    require(len(h["elbo"]) == 40 and all(math.isfinite(v)
                                         for v in h["elbo"]),
            f"the n=1000 {family} fit did not run 40 finite iterations")
    require(not vi._diverged, f"the n=1000 {family} fit diverged")
    n_iter = 40
    if family == "poisson":
        h = vi.fit(max_iter=200, tolerance=1e-5, verbose=False)
        more = len(h["elbo"]) - 40   # the history holds both fits
        n_iter += more
        corr = predictor_corr(model.X, vi.X_mean, 2)
        out.update(continued=more, corr=corr, converged=vi._converged)
        print(f"poisson n=1000 continued: {more} more iterations "
              f"to tolerance 1e-5 (converged {vi._converged}, diverged "
              f"{vi._diverged}, {rejected_count(h)} rejected), correlation "
              f"{corr}, deviance {h['deviance'][-1]}")
        require(not vi._diverged, "the continued n=1000 poisson fit "
                "diverged")
    require(corr >= (0.95 if family == "bernoulli" else 0.97),
            f"the n=1000 {family} fit's predictor correlation {corr} is "
            "below its bar")
    return n_iter


def phase_family_north_star(family: str) -> int:
    """n=2000, T=50, r=4 (d=10, B = 100,000 per K1 launch) from the warm
    init, 20 iterations."""
    from tame_torch.ops import dyad as dyad_ops

    model = family_model(family, 2000, 50, 4)
    m_true = dyad_ops.dyadic_fwd_temporal(model.X, 4)
    vi = family_engine(family, model, init_mode="warm")
    h, ms = timed_fit(vi, max_iter=20, tolerance=0.0)
    FAMILY[f"{family}_n2000"] = dict(ms_per_iter=ms,
                                     rejected=rejected_count(h),
                                     objective=[h["elbo"][0], h["elbo"][-1]])
    print(f"{family} n=2000 T=50 r=4 (warm init, 20 iterations): {ms} "
          f"ms/iteration (CUDA events over fit()), bound/ELBO "
          f"{h['elbo'][0]} -> {h['elbo'][-1]}, rejected iterations "
          f"{rejected_count(h)}, generating predictor "
          f"{m_true.min().item()} .. {m_true.max().item()}, largest "
          f"observation {model.Y.max().item()}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
    if h["elbo"][-1] > 0:
        # no ELBO of a pmf's data is positive: the e^20 clamp of the CVI
        # weights binds where the generating log-rates exceed 20 (ROADMAP
        # C.7), and the guard then accepts what the clamped objective
        # rates higher, as the JAX engine does
        print(f"{family} n=2000: the objective is positive, so not an "
              "ELBO: the weights' e^20 clamp binds on these data "
              "(ROADMAP C.7)")
    require(all(math.isfinite(v) for v in h["elbo"]) and not vi._diverged,
            f"the n=2000 {family} fit is not finite or diverged")
    require(h["elbo"][-1] > h["elbo"][0],
            f"the n=2000 {family} fit did not raise its objective")
    return 20


CARD_VS_CPU = ("Bernoulli", "Poisson", "smoothed Bernoulli",
               "smoothed Poisson")


def family_fit(kind: str, Y, params, init, mask, **kw):
    """One of the four non-Gaussian fits through its function."""
    from tame_torch.inference import (fit_cavi_bernoulli, fit_cavi_poisson,
                                      fit_smoothed_family)

    if kind == "Bernoulli":
        return fit_cavi_bernoulli(Y, params, init, mask=mask,
                                  learning_rate=0.8, **kw)
    if kind == "Poisson":
        return fit_cavi_poisson(Y, params, init, mask=mask,
                                learning_rate=0.7, **kw)
    return fit_smoothed_family(Y, params, init, mask=mask,
                               family=kind.split()[1].lower(),
                               learning_rate=0.7, **kw)


def rejected_iterations(kind: str, out) -> list:
    """The guarded loop's rejected iterations: NaN deviance (Poisson), a
    repeated objective (smoothed families; the Bernoulli engine has no
    guard)."""
    eh = out.elbo_history[:out.n_iter].tolist()
    if kind == "Poisson":
        return [i for i, v in enumerate(out.deviance_history[:out.n_iter]
                                        .tolist()) if math.isnan(v)]
    if kind == "Bernoulli":
        return []
    return [i for i in range(1, len(eh)) if eh[i] == eh[i - 1]]


def phase_card_vs_cpu(kind: str) -> int:
    """n=40, T=5, r=2 with 30 % of the dyads hidden: the fit on the card
    and on a CPU copy (the twins) from one init computed on the CPU, 60
    iterations each at tolerance 0; the same stop, the same rejected
    iterations and the objective within FAMILY_ELBO_RTOL at every
    iteration.  Then both at tolerance 1e-5 (<= 150 iterations), their
    stops printed: a relative stop falls where float32 sums in another
    order decide it.  Returns the iterations run on the card."""
    from tame_torch.inference import cavi, warm_init_smoothed_family
    from tame_torch.models import random_dyad_mask

    family = kind.split()[-1].lower()
    model = family_model(family, 40, 5, 2)
    params, Y = model.params, model.Y.cpu()
    mask = random_dyad_mask(torch.Generator().manual_seed(1), 40, 5, 0.3)
    if kind == "Bernoulli":
        init = cavi.init_state(torch.Generator().manual_seed(10), 40, 5, 6,
                               "full", 0.1, 0.5)
    elif kind == "Poisson":
        init = cavi.warm_init_state(torch.log(Y + 0.5), params,
                                    structure="full", obs_mask=mask)
    else:
        init = warm_init_smoothed_family(Y, params, family, obs_mask=mask)
    on_card = type(init)(*(x.cuda() for x in init))
    card = family_fit(kind, model.Y, params.to("cuda"), on_card,
                      mask.cuda(), max_iter=60, tolerance=0.0)
    cpu = family_fit(kind, Y, params, init, mask, max_iter=60,
                     tolerance=0.0)
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        card.elbo_history[:60].tolist(), cpu.elbo_history[:60].tolist()))
    rej = rejected_iterations(kind, card)
    stops = [family_fit(kind, Y_, p_, i_, m_, max_iter=150, tolerance=1e-5)
             for Y_, p_, i_, m_ in ((model.Y, params.to("cuda"), on_card,
                                     mask.cuda()), (Y, params, init, mask))]
    FAMILY[f"card_vs_cpu {kind}"] = dict(
        max_rel_elbo=rel, rejected=rej,
        stops_at_1e5=[o.n_iter for o in stops])
    print(f"card vs CPU, {kind} n=40 T=5 r=2, 30 % hidden: 60 iterations "
          f"each (diverged {card.diverged} / {cpu.diverged}), rejected "
          f"iterations {rej} / {rejected_iterations(kind, cpu)}, max "
          f"relative objective difference {rel}; at tolerance 1e-5 the "
          f"card stops at {stops[0].n_iter} (converged "
          f"{stops[0].converged}), the CPU at {stops[1].n_iter} (converged "
          f"{stops[1].converged})")
    require((card.n_iter, card.diverged) == (cpu.n_iter, cpu.diverged)
            == (60, False), f"card vs CPU {kind}: different stops")
    require(stops[0].n_iter == stops[1].n_iter
            and stops[0].converged == stops[1].converged,
            f"card vs CPU {kind}: different stops at tolerance 1e-5")
    require(rej == rejected_iterations(kind, cpu),
            f"card vs CPU {kind}: different rejected iterations")
    require(rel <= FAMILY_ELBO_RTOL, f"card vs CPU {kind}: the objectives "
            f"differ by {rel}")
    return 60 + stops[0].n_iter


@contextlib.contextmanager
def counting_inner_iterations(tally: list, e_step="fit_smoothed_family"):
    """Count the iterations of every E-step ``fit_em`` runs (its backoff
    retries included) into ``tally``: the smoothed family's, or
    ``e_step="fit_cavi_smoothed"`` the Gaussian one's."""
    from tame_torch.inference import em

    inner = getattr(em, e_step)

    def counted(*args, **kw):
        out = inner(*args, **kw)
        tally.append(out.n_iter)
        return out

    setattr(em, e_step, counted)
    try:
        yield
    finally:
        setattr(em, e_step, inner)


def phase_binary_em() -> int:
    """``em_scale_probe --binary``: n=1000, T=20, r=2 Bernoulli ties from
    phi 0.8 (seed 1), start phi 0.3, 8 EM iterations of <= 60 smoothed
    E-step iterations at lr 0.7; returns the inner iterations run."""
    from tame_torch.scripts import em_scale_probe

    tally: list = []
    with counting_inner_iterations(tally):
        res = em_scale_probe.main(["--binary"])
    FAMILY["binary_em"] = dict(res, inner_iterations=sum(tally))
    print(f"binary EM: {res['em_iters']} EM iterations, {sum(tally)} inner "
          f"iterations ({tally}), learned phi {res['phi']} (truth 0.8), "
          f"{res['wall_s']} s (host clock)")
    require(abs(res["phi"] - 0.8) < 0.1,
            f"the binary EM learned phi {res['phi']}, not within 0.1 of 0.8")
    return sum(tally)


def phase_ckpt_poisson():
    """The n=1000 Poisson fit (warm init) killed after 8 iterations in
    segments of 4 and resumed to 12: the guarded loop's carry (proposal,
    step scale) rides the checkpoint."""
    model = family_model("poisson", 1000, 20, 2)
    killed_and_resumed(lambda: family_engine("poisson", model),
                       "checkpointed n=1000 Poisson (K1/K2)", 12, 4, 8)


def phase_karate() -> dict:
    """The masked Poisson fit of the karate-club network (n=34, T=1, r=2,
    20 % of the dyads hidden by ``random_dyad_mask`` seeded 1, warm init,
    <= 300 iterations to 1e-6) on the card and on a CPU copy from the
    CPU's warm init: the fitted rates within KARATE_RATE_RTOL; the
    held-out AUC beside the degree baseline's."""
    import types

    from tame_torch.config import ModelConfig
    from tame_torch.inference import TemporalAMEPoissonVI
    from tame_torch.io import load_karate_club
    from tame_torch.models import build_params, random_dyad_mask

    data = load_karate_club()
    n = data.n_nodes
    hide = random_dyad_mask(torch.Generator().manual_seed(1), n, 1, 0.2)
    off = 1.0 - torch.eye(n)[:, :, None]
    fitmask, held = off * hide, off * (1.0 - hide)
    params = build_params(ModelConfig(n_nodes=n, n_time=1, latent_dim=2,
                                      seed=0))
    engines = {}
    for dev in ("cuda", "cpu"):
        m = types.SimpleNamespace(Y=data.Y.to(dev), params=params, n=n, T=1,
                                  d=6, r=2)
        engines[dev] = TemporalAMEPoissonVI(m, mask=fitmask.to(dev),
                                            init_mode="warm")
    card, cpu = engines["cuda"], engines["cpu"]
    init_diff = rel_err(card.X_mean.cpu(), cpu.X_mean)[1]
    card.X_mean, card.X_cov = cpu.X_mean.cuda(), cpu.X_cov.cuda()
    hc = card.fit(max_iter=300, tolerance=1e-6, verbose=False)
    hp = cpu.fit(max_iter=300, tolerance=1e-6, verbose=False)
    rate = card.predict_rate().cpu()
    err = rel_err(rate, cpu.predict_rate())[1]
    y0 = data.Y[..., 0].cpu()
    sel = held > 0
    lbl = y0[sel] > 0
    fm = fitmask * y0
    base = (fm.sum((1, 2))[:, None] + fm.sum((0, 2))[None, :])[:, :, None]
    auc = {k: auc_score(v.expand_as(y0)[sel], lbl)
           for k, v in (("model", rate), ("degree", base))}
    out = dict(iterations=(len(hc["elbo"]), len(hp["elbo"])),
               rate_rel=err, auc=auc["model"], auc_degree=auc["degree"],
               warm_init_rel=init_diff)
    FAMILY["karate"] = out
    print(f"karate masked Poisson (n=34, 20 % hidden): {out['iterations']} "
          f"iterations card / CPU (converged {card._converged} / "
          f"{cpu._converged}), fitted rates card vs CPU {err} of max; "
          f"held-out AUC {auc['model']}, degree baseline {auc['degree']}; "
          f"the card's own warm init differed from the CPU's by "
          f"{init_diff} of max")
    require(err <= KARATE_RATE_RTOL,
            f"the card's karate rates depart from the CPU's by {err}")
    return out


def auc_score(scores: torch.Tensor, labels: torch.Tensor) -> float:
    """The probability that a positive outscores a negative (ties half)."""
    pos, neg = scores[labels][:, None], scores[~labels][None, :]
    return float(((pos > neg).double() + 0.5 * (pos == neg).double()).mean())


# ---------------------------------------------------------------------------
# The time-parallel smoother and the samplers
# ---------------------------------------------------------------------------

PTRI_ATOL = 5e-4        # parallel vs sequential smoother (tame's bound)
PTRI_LOGDET_RTOL = 1e-4
PARALLEL_ELBO_RTOL = 1e-4   # parallel vs K4 smoothed fit, every iteration
LOGPROB_RTOL = 1e-5     # card vs CPU log density and gradient
GRAPH_RTOL = 1e-4       # graph replay vs eager gradient: f32 sum order
CARD = ""               # nvidia-smi's name and power limit, set in main
SAMPLERS: dict = {}     # the sampler phases' numbers, printed at the end


def timed_phase(label: str, fn, *args):
    """Run one phase and print its wall time beside the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"phase {label}: {time.perf_counter() - t0:.2f} s wall on {CARD}",
          flush=True)
    return out


def weak_information_system(n: int, T: int, d: int, phi: float,
                            gen: torch.Generator):
    """Observation information A A' + 0.1 I with A ~ 0.05 N(0, 1) (weak)
    and the prior of tame's high-phi test, as (Pobs, eta, (Phi, Q,
    Sigma0), D, O) with D, O the sequential system's blocks."""
    eye = torch.eye(d, device="cuda")
    A = torch.randn(n, T, d, d, device="cuda", generator=gen) * 0.05
    Pobs = A @ A.transpose(-1, -2) + 0.1 * eye
    eta = torch.randn(n, T, d, device="cuda", generator=gen)
    Phi = phi * eye
    Q = (1 - phi ** 2) * 0.1 * (eye + 0.2 * torch.ones(d, d, device="cuda"))
    Sigma0 = eye * 0.7 + 0.1
    Q_inv, S0_inv = torch.linalg.inv(Q), torch.linalg.inv(Sigma0)
    t = torch.arange(T, device="cuda")
    D = (Pobs + (t == 0)[:, None, None] * S0_inv
         + (t > 0)[:, None, None] * Q_inv
         + (t < T - 1)[:, None, None] * (Phi.T @ Q_inv @ Phi))
    return Pobs, eta, (Phi, Q, Sigma0), D, -Phi.T @ Q_inv


def phase_parallel_smoother() -> dict:
    """The associative-scan smoother against K4 on the same systems: one
    north-star block phase (n=125, T=50, d=10; D_obs = A A'/d + I and the
    model's prior), (64, 1024, 10) and (16, 2048, 10) at phi 0.97 with weak
    information; means and covariances within 5e-4, logdets within 1e-4
    relative; both timed (CUDA-event medians of 5)."""
    from tame_torch.config import ModelConfig
    from tame_torch.inference import cavi
    from tame_torch.models import build_params
    from tame_torch.ops.fused_smoother import fused_smoother
    from tame_torch.ops.ptridiag import parallel_block_tridiag_smoother

    gen = torch.Generator(device="cuda").manual_seed(12)
    p = build_params(ModelConfig(n_nodes=2000, n_time=50,
                                 latent_dim=4)).to("cuda")
    pri = cavi.precompute_priors(p)
    A = torch.randn(125, 50, 10, 10, device="cuda", generator=gen)
    Pobs = A @ A.transpose(-1, -2) / 10 + torch.eye(10, device="cuda")
    eta = torch.randn(125, 50, 10, device="cuda", generator=gen)
    cases = {"n=125 T=50 d=10 (north-star block phase)": (
        Pobs, eta, (p.Phi, p.Q, p.Sigma0),
        Pobs + cavi._prior_precision(pri, 50)[None], -pri.Qinv_Phi.T)}
    for n, T in ((64, 1024), (16, 2048)):
        cases[f"n={n} T={T} d=10 (phi 0.97, weak information)"] = \
            weak_information_system(n, T, 10, 0.97, gen)
    out = {}
    for label, (Pobs, eta, prior, D, O) in cases.items():
        seq = fused_smoother(D, O, eta)
        par = parallel_block_tridiag_smoother(Pobs, eta, *prior)
        errs = {name: (getattr(par, name) - getattr(seq, name)).abs().max()
                .item() for name in ("mean", "cov", "cross_cov")}
        ld = ((par.logdet - seq.logdet).abs() / seq.logdet.abs()).max().item()
        k4_ms = cuda_ms(lambda: fused_smoother(D, O, eta), reps=5)
        par_ms = cuda_ms(lambda: parallel_block_tridiag_smoother(
            Pobs, eta, *prior), reps=5)
        out[label] = dict(k4_ms=k4_ms, parallel_ms=par_ms, max_abs=errs,
                          logdet_rel=ld)
        print(f"parallel smoother vs K4, {label}: K4 {k4_ms} ms, parallel "
              f"{par_ms} ms; max |diff| {errs}, logdet rel {ld}", flush=True)
        require(all(e <= PTRI_ATOL for e in errs.values())
                and ld <= PTRI_LOGDET_RTOL,
                f"the parallel smoother departs from K4 at {label}")
    SAMPLERS["parallel vs K4"] = out
    return out


def phase_parallel_fit(model, smoother: str, iters: int = 10):
    """The north-star smoothed fit from the warm init, 16 blocks, ``iters``
    iterations at tolerance 0 with ``smoother``; returns (ELBO history,
    ms/iteration by CUDA events)."""
    from tame_torch.inference.smoothed import (
        fit_cavi_smoothed,
        warm_init_smoothed_state,
    )

    Y = model.Y
    params = model.params.to("cuda")
    init = warm_init_smoothed_state(Y, params)
    fit_cavi_smoothed(Y, params, init, max_iter=1, smoother=smoother,
                      num_blocks=16)          # first products pick kernels
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fit_cavi_smoothed(Y, params, init, max_iter=iters, tolerance=0.0,
                            smoother=smoother, num_blocks=16)
    end.record()
    end.synchronize()
    require(res.n_iter == iters, f"the {smoother} fit stopped early")
    return res.elbo_history[:iters], start.elapsed_time(end) / iters


def logprob_case(kind: str, dev: str):
    """(log density fn, latents (4, n, T, d)) at n=40, T=5, r=2 on ``dev``
    for one of: gaussian, masked (30 % hidden, NaN-coded), poisson,
    bernoulli; data drawn on the CPU, then moved."""
    from tame_torch import TemporalAMEModel
    from tame_torch.inference.logprob import make_logdensity_fn
    from tame_torch.models import random_dyad_mask, sample_observations

    model = TemporalAMEModel(n_nodes=40, n_time=5, latent_dim=2, seed=3,
                             device="cpu")
    Y, X = model.generate_data(return_latents=True)
    mask, family = None, None
    if kind == "masked":
        mask = random_dyad_mask(torch.Generator().manual_seed(4), 40, 5, 0.3)
        Y = torch.where(mask[..., None] > 0, Y, torch.tensor(math.nan))
    elif kind in ("poisson", "bernoulli"):
        family = kind
        Y = sample_observations(model.params, torch.Generator().manual_seed(5),
                                X, family=kind)
    states = X[None] + 0.3 * torch.randn(
        (4,) + X.shape, generator=torch.Generator().manual_seed(6))
    fn = make_logdensity_fn(model.params.to(dev), Y.to(dev),
                            obs_mask=None if mask is None else mask.to(dev),
                            family=family)
    return fn, states.to(dev)


def phase_logprob() -> dict:
    """log_joint and its gradient for 4 states in one batched call on the
    card against the CPU: values within 1e-5 relative, gradients within
    1e-5 of their largest entry and finite."""
    from tame_torch.inference.hmc import value_and_grad

    out = {}
    for kind in ("gaussian", "masked", "poisson", "bernoulli"):
        (cf, cx), (gf, gx) = logprob_case(kind, "cpu"), logprob_case(
            kind, "cuda")
        cv, cg = value_and_grad(cf, cx)
        gv, gg = value_and_grad(gf, gx)
        v_rel = ((gv.cpu() - cv).abs() / cv.abs()).max().item()
        g_rel = rel_err(gg.cpu(), cg)[1]
        out[kind] = dict(value_rel=v_rel, grad_rel=g_rel)
        print(f"log density n=40 T=5 r=2 {kind}, card vs CPU: value rel "
              f"{v_rel}, gradient rel {g_rel}", flush=True)
        require(torch.isfinite(gg).all(), f"non-finite {kind} gradient")
        require(v_rel <= LOGPROB_RTOL and g_rel <= LOGPROB_RTOL,
                f"the {kind} log density departs from the CPU's")
    return out


def phase_nuts() -> dict:
    """``mcmc_bench`` at its width (n=128, T=16, r=2, 64 chains, depth 6,
    CAVI-preconditioned, each gradient the replay of one captured CUDA
    graph), warmup and draws cut to 600 + 100 (the chains climb from the
    CAVI start to the typical set in ~500 transitions, so a shorter warmup
    samples a trend: 300 + 100 gave a log-density R-hat of 5.67, and depth
    4 or 5 did not mix either): the graphed gradient within 1e-4 of the
    eager one (of its largest entry), the
    log-density split-R-hat <= 1.1, the mean accept statistic in [0.6,
    0.95], the median dyad-mean effect size against the SMF fit < 0.3."""
    from tame_torch.scripts import mcmc_bench

    res = mcmc_bench.main(["--warmup", "600", "--samples", "100"])
    SAMPLERS["nuts"] = {k: res[k] for k in (
        "wall_s", "ess_per_s_median", "ess_per_s_min", "ess_median",
        "syncs_per_transition", "steps_per_transition", "grad_ms",
        "grad_kernels", "grad_device_ms", "graph_grad_ms",
        "graph_rel_diff", "ms_per_gradient_in_run",
        "accept_mean", "logdensity_rhat", "split_rhat_max",
        "smf_effect_size_median", "step_size_median")}
    print(f"NUTS n=128 T=16 r=2, 64 chains: ESS/s median "
          f"{res['ess_per_s_median']} (min {res['ess_per_s_min']}), "
          f"{res['syncs_per_transition']} host readbacks per transition, "
          f"{res['wall_s']} s on {CARD}", flush=True)
    require(res["graph_rel_diff"] <= GRAPH_RTOL, f"the graphed gradient "
            f"departs from the eager one: {res['graph_rel_diff']}")
    require(res["logdensity_rhat"] <= 1.1, "NUTS log-density R-hat > 1.1")
    require(0.6 <= res["accept_mean"] <= 0.95,
            f"NUTS mean accept {res['accept_mean']} outside [0.6, 0.95]")
    require(res["smf_effect_size_median"] < 0.3,
            "NUTS and the SMF fit disagree in dyad-mean space")
    return res


def phase_hmc() -> dict:
    """HMC at the same width: 64 chains, 16 leapfrog steps, 100 warmup and
    100 draws, CAVI-preconditioned: finite, mean accept >= 0.5."""
    from tame_torch import TemporalAMEModel
    from tame_torch.inference import TemporalAMEHMC

    model = TemporalAMEModel(n_nodes=128, n_time=16, latent_dim=2, seed=0)
    model.generate_data(
        generator=torch.Generator(device="cuda").manual_seed(0))
    hmc = TemporalAMEHMC(model, num_chains=64, num_leapfrog=16, seed=0)
    t0 = time.perf_counter()
    out = hmc.sample(num_warmup=100, num_samples=100)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = float(out.accept_prob.mean())
    SAMPLERS["hmc"] = dict(wall_s=wall, accept_mean=acc,
                           step_size_median=float(out.step_size.median()))
    print(f"HMC n=128 T=16 r=2, 64 chains x 16 leapfrog, 100 + 100: "
          f"{wall} s, mean accept {acc}", flush=True)
    require(torch.isfinite(out.positions).all()
            and torch.isfinite(out.logdensities).all(), "non-finite HMC")
    require(acc >= 0.5, f"HMC mean accept {acc} < 0.5")
    return SAMPLERS["hmc"]


def phase_smc() -> dict:
    """``smc_bench`` at its width (n=64, T=8, r=2, 256 particles, buffer
    600, 20 leapfrog, 30 stages per call), one replicate (cut from 4) of
    3 moves a stage (cut from 6; 194 stages, the evidence 47 nats above
    the exact ELBO on an H100, against 102 with 6): beta reaches 1 inside
    the buffer and the log-evidence lies above the exact ELBO less 3
    nats (``tests/test_mcmc.py``)."""
    from tame_torch.scripts import smc_bench

    res = smc_bench.main(["--replicates", "1", "--moves", "3"])
    SAMPLERS["smc"] = {k: res[k] for k in (
        "stages", "wall_s_per_replicate", "kl_gap_nats", "log_evidence_mean",
        "exact_elbo", "accept_mean", "resamples_mean")}
    print(f"SMC n=64 T=8 r=2, 256 particles: {res['stages']} stages, "
          f"{res['wall_s_per_replicate']} s, evidence - exact ELBO "
          f"{res['kl_gap_nats']} nats on {CARD}", flush=True)
    require(res["reached_beta_1"], "SMC did not reach beta = 1")
    require(res["kl_gap_nats"] > -3.0, "the SMC evidence lies below the "
            "exact ELBO")
    return res


def phase_rwm_acceptance() -> dict:
    """Random-walk moves at the ``smc_bench`` shape with step_scale 0.5
    (the default the port keeps) and 0.15, 10 stages each: the mean
    acceptance of each (ROADMAP C.5)."""
    from tame_torch.inference.hmc import precondition_from_cavi
    from tame_torch.inference.smc import run_smc
    from tame_torch.scripts import _common

    _, params, Y = _common.north_star(torch.device("cuda"), 64, 8, 2)
    _, variances = precondition_from_cavi(Y, params)
    out = {}
    for scale in (0.5, 0.15):
        res = run_smc(params, Y, torch.Generator(device="cuda").manual_seed(7),
                      num_particles=256, num_stages=600, num_moves=6,
                      step_scale=scale, move_kernel="rwm",
                      proposal_scale=variances.sqrt(), max_new_stages=10)
        acc = res.accept_history[:res.n_stages]
        out[scale] = dict(accept_mean=float(acc.mean()),
                          beta=float(res.beta_history[res.n_stages - 1]))
        print(f"RWM moves, step_scale {scale}, {res.n_stages} stages: mean "
              f"acceptance {out[scale]['accept_mean']}, beta reached "
              f"{out[scale]['beta']}", flush=True)
    SAMPLERS["rwm"] = out
    return out



def sampler_paths(drive) -> None:
    """The time-parallel smoother and the samplers, each a path driven by
    ``drive`` (the launch counters zeroed before it) and timed."""
    _, c = drive("parallel smoother vs K4", timed_phase,
                 "parallel smoother vs K4", phase_parallel_smoother)
    require(c["fused_smoother"] > 0, "the comparison did not run K4")
    model = north_star_model()
    fits = {}
    for smoother in ("sequential", "parallel"):
        fits[smoother], c = drive(
            f"n=2000 smoothed fit, smoother={smoother}", timed_phase,
            f"n=2000 smoothed fit, smoother={smoother}", phase_parallel_fit,
            model, smoother)
        # one warm-up iteration and 10 timed ones, 16 block phases each
        want = 16 * 11 if smoother == "sequential" else 0
        require(c["fused_smoother"] == want, f"the {smoother} smoothed fit "
                f"launched K4 {c['fused_smoother']} times, not {want}")
    (seq_h, seq_ms), (par_h, par_ms) = fits["sequential"], fits["parallel"]
    rel = ((par_h - seq_h).abs() / seq_h.abs()).max().item()
    SAMPLERS["n=2000 smoothed fit"] = dict(k4_ms_per_iter=seq_ms,
                                           parallel_ms_per_iter=par_ms,
                                           elbo_rel=rel)
    print(f"n=2000 T=50 r=4 smoothed fit, warm, 16 blocks, 10 iterations: "
          f"K4 {seq_ms} ms/iteration, parallel smoother {par_ms} "
          f"ms/iteration; max relative ELBO difference {rel}", flush=True)
    require(rel <= PARALLEL_ELBO_RTOL, "the parallel smoothed fit departs "
            "from the K4 fit")
    del model
    drive("log density card vs CPU", timed_phase, "log density card vs CPU",
          phase_logprob)
    for label, phase in (("NUTS n=128 T=16 r=2", phase_nuts),
                         ("HMC n=128 T=16 r=2", phase_hmc)):
        _, c = drive(label, timed_phase, label, phase)
        require(c["spd_solve_inv"] > 0 and c["logdet_spd"] > 0
                and c["fused_fit"] == 0, f"the {label} preconditioner did "
                f"not run K1 and K2: {c}")
    _, c = drive("SMC n=64 T=8 r=2", timed_phase, "SMC n=64 T=8 r=2",
                 phase_smc)
    require(c["fused_fit"] > 0, f"the SMC preconditioner did not run K3: {c}")
    drive("RWM acceptance", timed_phase, "RWM acceptance",
          phase_rwm_acceptance)
    print(f"sampler and parallel-smoother paths: {json.dumps(SAMPLERS)}")


# ---------------------------------------------------------------------------
# The host layers: the command line, the experiments, the demo, the setup
# check
# ---------------------------------------------------------------------------

HOST: dict = {}         # the host-layer phases' numbers, printed at the end
NORTH_STAR = dict(n_nodes=2000, n_time=50, latent_dim=4)
FAMILY_SHAPE = dict(n_nodes=1000, n_time=20, latent_dim=2)


def shape_flags(shape: dict) -> list:
    """The CLI's model-size flags for a shape."""
    return [a for k, v in shape.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]
# The sampler phases cut the CLI's 200 + 200 draws to fit the time budget
# (NUTS 15 + 15, HMC 50 + 50; the model, the chains and SMC's particles stay
# at the CLI's defaults).
SAMPLER_DRAWS = {"nuts": ["--num-warmup", "15", "--num-samples", "15"],
                 "hmc": ["--num-warmup", "50", "--num-samples", "50"],
                 "smc": []}


def cli_run(argv: list) -> str:
    """``tame_torch.cli.main(argv)`` in this process on the card, its
    standard output captured; requires exit code 0 and returns the
    output."""
    import io

    from tame_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    out = buf.getvalue()
    require(rc == 0, f"python -m tame_torch {' '.join(argv)} exited {rc}:\n"
            f"{out[-2000:]}")
    return out


def grab(out: str, pattern: str, group: int = 1) -> str:
    """The first match of ``pattern`` in a command's output."""
    import re

    m = re.search(pattern, out)
    require(m is not None, f"no line matching {pattern!r} in:\n{out[-2000:]}")
    return m.group(group)


def grab_float(out: str, pattern: str) -> float:
    value = float(grab(out, pattern))
    require(math.isfinite(value), f"{pattern!r} printed {value}")
    return value


def stage_seconds(out: str) -> dict:
    """The ``fit`` subcommand's stage split (data, init, fit, diagnostics,
    held_out) from its wall-time line."""
    line = grab(out, r"Wall time \(s, host clock, device synchronized\): "
                r"(.*)")
    return {k: float(v) for k, v in (kv.split("=") for kv in line.split())}


def phase_cli_fit(extra: list) -> dict:
    """``python -m tame_torch fit`` at the north star (n=2000, T=50, r=4,
    Good SMF, 16-block updates, exact diagnostics, 150 iterations at
    most): the printed final ELBO and MSE, the stage split and the
    command's wall time (host clock, synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cli_run(["fit", *shape_flags(NORTH_STAR), "--method", "good",
                   "--max-iter", "150", *extra])
    torch.cuda.synchronize()
    res = dict(n_iter=int(grab(out, r"Number of iterations: (\d+)")),
               elbo=grab(out, r"Final ELBO:\s+(\S+)"),
               mse=grab(out, r"Final reconstruction MSE: (\S+)"),
               stages=stage_seconds(out), wall_s=time.perf_counter() - t0)
    if extra:
        res.update(observed=grab_float(out, r"Observed-dyad recon MSE: "
                                            r"(\S+)"),
                   held_out=grab_float(out, r"Held-out-dyad recon MSE: "
                                            r"(\S+)"))
    return res


def phase_cli_overhead() -> dict:
    """The CLI's fit against the engine alone in turns (engine, CLI, CLI,
    engine), host clock: the medians and the CLI's overhead over the
    engine."""
    runs = {"engine": [], "cli": []}
    for who in ("engine", "cli", "cli", "engine"):
        runs[who].append(phase_direct_fit() if who == "engine"
                         else phase_cli_fit([]))
    engine = statistics.median(r["data_and_init_s"] + r["fit_s"]
                               for r in runs["engine"])
    cli = statistics.median(r["wall_s"] for r in runs["cli"])
    res = dict(engine_s=[r["data_and_init_s"] + r["fit_s"]
                         for r in runs["engine"]],
               engine_fit_s=[r["fit_s"] for r in runs["engine"]],
               cli_s=[r["wall_s"] for r in runs["cli"]],
               cli_stages=[r["stages"] for r in runs["cli"]],
               overhead_s=cli - engine)
    HOST["fit n=2000 in turns"] = res
    print(f"n=2000 fit in turns (engine, CLI, CLI, engine): engine "
          f"{res['engine_s']} s (fit {res['engine_fit_s']}), CLI "
          f"{res['cli_s']} s, stages {res['cli_stages']}; CLI overhead "
          f"(medians) {res['overhead_s']} s", flush=True)
    return res


def phase_direct_fit() -> dict:
    """The same fit as the CLI's, through the engine alone: the model and
    engine the ``fit`` subcommand builds from its defaults (seed 42, lr
    0.7, random init, tolerance 1e-4), its final ELBO and MSE formatted as
    the CLI prints them, and its wall time (host clock, synchronized)."""
    from tame_torch import TemporalAMEModel, TemporalAMEStructuredMFVI

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = TemporalAMEModel(**NORTH_STAR, seed=42)
    model.generate_data(return_latents=True)
    vi = TemporalAMEStructuredMFVI(model, factorization="good",
                                   learning_rate=0.7, seed=42)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    h = vi.fit(max_iter=150, tolerance=1e-4, verbose=False, check_every=10)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(n_iter=len(h["elbo"]), elbo=f"{h['elbo'][-1]:10.2f}".strip(),
                mse=f"{h['reconstruction_error'][-1]:.6f}",
                data_and_init_s=t1 - t0, fit_s=t2 - t1)


def phase_cli_smoothed() -> int:
    out = cli_run(["fit", *shape_flags(NORTH_STAR), "--method", "smoothed",
                   "--init", "warm"])
    HOST["smoothed"] = stage_seconds(out)
    return int(grab(out, r"Number of iterations: (\d+)"))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def phase_cli_checkpoint() -> int:
    """``fit --checkpoint D --checkpoint-every 10 --max-iter 20``, then
    ``--resume --max-iter 40``, against a one-shot ``--max-iter 40``: the
    final checkpoints' arrays and scalars bit for bit equal, both in the
    native ``tamestore`` format.  Returns the iterations of the one-shot
    fit."""
    import tempfile

    import numpy as np

    from tame_torch.io import load_checkpoint

    base = ["fit", *shape_flags(NORTH_STAR), "--method", "good"]
    with tempfile.TemporaryDirectory() as tmp:
        a, b = f"{tmp}/resumed", f"{tmp}/one_shot"
        cli_run(base + ["--checkpoint", a, "--checkpoint-every", "10",
                        "--max-iter", "20"])
        out = cli_run(base + ["--checkpoint", a, "--resume", "--max-iter",
                              "40"])
        resumed_iter = int(grab(out, r"Number of iterations: (\d+)"))
        out = cli_run(base + ["--checkpoint", b, "--max-iter", "40"])
        n_iter = int(grab(out, r"Number of iterations: (\d+)"))
        require(resumed_iter == n_iter, f"the resumed CLI fit ran "
                f"{resumed_iter} iterations, the one-shot {n_iter}")
        fa, fb = (_flat(load_checkpoint(p)) for p in (a, b))
        require(fa.keys() == fb.keys(), f"checkpoint keys differ: "
                f"{sorted(fa)} vs {sorted(fb)}")
        for k in fa:
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            require(x.dtype == y.dtype and x.shape == y.shape
                    and x.tobytes() == y.tobytes(),
                    f"checkpoint entry {k} differs between the resumed and "
                    f"the one-shot CLI fit")
        formats = {json.loads(pathlib.Path(p, "manifest.json").read_text())
                   ["format"] for p in (a, b)}
        require(formats == {"tamestore"}, f"checkpoints written as "
                f"{formats}")
    print(f"CLI checkpointed fit n=2000 T=50 r=4: 20 iterations in "
          f"segments of 10, resumed to 40 = the one-shot fit of {n_iter} "
          f"bit for bit ({len(fa)} entries: {sorted(fa)}); format "
          f"tamestore", flush=True)
    return n_iter


def phase_cli_family(method: str) -> dict:
    out = cli_run(["fit", *shape_flags(FAMILY_SHAPE), "--method", method,
                   "--missing-frac", "0.2"])
    label = "accuracy" if method == "binary" else "mean deviance"
    res = dict(n_iter=int(grab(out, r"Number of iterations: (\d+)")),
               observed=grab_float(out, rf"Observed-dyad {label}: (\S+)"),
               held_out=grab_float(out, rf"Held-out-dyad {label}: (\S+)"),
               stages=stage_seconds(out))
    HOST[f"fit {method}"] = res
    print(f"CLI fit --method {method} n=1000 T=20 r=2, 20 % hidden: "
          f"{res['n_iter']} iterations, observed {label} "
          f"{res['observed']}, held-out {res['held_out']}; stages (s) "
          f"{res['stages']}", flush=True)
    return res


def phase_cli_learn() -> float:
    out = cli_run(["learn", *shape_flags(FAMILY_SHAPE), "--n-em", "3"])
    phi = grab_float(out, r"Learned after \d+ EM iterations: phi=(\S+)")
    HOST["learn phi"] = phi
    print(f"CLI learn n=1000 T=20 r=2, 3 EM iterations: phi 0.3 -> {phi} "
          f"(true 0.8)", flush=True)
    require(abs(phi - 0.8) < abs(0.3 - 0.8), f"EM did not move phi toward "
            f"0.8: {phi}")
    return phi


def phase_cli_sample(sampler: str) -> dict:
    out = cli_run(["sample", "--sampler", sampler, *SAMPLER_DRAWS[sampler]])
    if sampler == "smc":
        require("WARNING" not in out, f"SMC did not reach beta = 1:\n{out}")
        res = dict(stages=int(grab(out, r"(\d+) adaptive stages")),
                   log_evidence=grab_float(out, r"log-evidence = (\S+),"))
    else:
        res = dict(accept=grab_float(out, r"mean accept = (\S+),"))
    HOST[f"sample {sampler}"] = res
    print(f"CLI sample --sampler {sampler} (n=15, T=10, r=2): {res}",
          flush=True)
    return res


def demo_mse(out: str) -> dict:
    """Final MSE by method from ``compare_methods``' ranking."""
    import re

    block = out.split("Final reconstruction_error:")[1].split("\n\n")[0]
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\d+\. (Naive MF|Good SMF|Bad SMF)\s*: (\S+)", block)}


def phase_cli_demo(outdir: str) -> dict:
    out = cli_run(["demo", "--lr", "0.7", "--max-iter", "150", "--outdir",
                   outdir])
    mse = demo_mse(out)
    HOST["demo mse"] = mse
    naive, good, bad = mse["Naive MF"], mse["Good SMF"], mse["Bad SMF"]
    print(f"CLI demo lr 0.7, 150 iterations: final MSE {mse}", flush=True)
    require(naive < 0.5 and good < 0.5 and abs(naive - good) < 0.05,
            f"demo: Naive and Good did not reach a low, equal MSE: {mse}")
    require(not math.isfinite(bad) or (bad > 1.0 and bad > 3.0 * good),
            f"demo: Bad SMF did not blow up: {mse}")
    return mse


def phase_cli_experiment(argv: list, fits: int) -> str:
    """One experiment subcommand with ``--no-save``; its host-clock
    seconds per fit (``fits`` of them) go to ``HOST``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cli_run(argv + ["--no-save"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    HOST[" ".join(argv)] = dict(seconds=seconds, per_fit_s=seconds / fits)
    print(f"CLI {' '.join(argv)}: {seconds} s, {seconds / fits} s per fit "
          f"({fits} fits)", flush=True)
    return out


def phase_saved_results(tmp: str) -> dict:
    """The three-way results saved with ``save_results`` and reported with
    ``generate_experiment_report`` into ``tmp``; a process that sees no
    card loads the pickle and finds numpy arrays and Python values only,
    without importing torch."""
    from tame_torch import TemporalAMEModel
    from tame_torch.experiments import (generate_experiment_report,
                                        save_results, setup_experiment_dir)
    from tame_torch.experiments.three_way_comparison import (
        run_three_way_comparison)

    results, _ = run_three_way_comparison(learning_rate=0.7,
                                          save_outputs=False, verbose=False)
    _, X_true = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2,
                                 seed=42).generate_data(return_latents=True)
    exp_dir = setup_experiment_dir("three_way_comparison", base_dir=tmp)
    save_results({name: {k: v for k, v in r.items() if k != "vi"}
                  for name, r in results.items()}, exp_dir)
    generate_experiment_report(results, exp_dir, X_true=X_true,
                               experiment_name="Three-Way Comparison")
    report = (exp_dir / "report.md").read_text()
    require("## Parameter Recovery" in report, "the report lacks the "
            "parameter-recovery table")
    probe = (
        "import json, pickle, sys\n"
        "def leaves(x):\n"
        "    if isinstance(x, dict):\n"
        "        for v in x.values(): yield from leaves(v)\n"
        "    elif isinstance(x, (list, tuple)):\n"
        "        for v in x: yield from leaves(v)\n"
        "    else: yield x\n"
        "d = pickle.load(open(sys.argv[1], 'rb'))\n"
        "print(json.dumps({'types': sorted({type(v).__module__ + '.' + "
        "type(v).__name__ for v in leaves(d)}), 'torch_imported': "
        "'torch' in sys.modules}))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", probe, str(exp_dir / "data" / "results.pkl")],
        capture_output=True, text=True, env=env, timeout=120)
    require(proc.returncode == 0, f"loading the pickle without a card "
            f"failed:\n{proc.stderr}")
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    allowed = {"numpy.ndarray", "builtins.float", "builtins.int",
               "builtins.str", "builtins.NoneType", "builtins.bool"}
    require(not seen["torch_imported"] and set(seen["types"]) <= allowed,
            f"the saved results hold more than numpy and Python values: "
            f"{seen}")
    print(f"three-way results saved and reported in {exp_dir}; loaded "
          f"without a card: leaf types {seen['types']}, torch imported "
          f"{seen['torch_imported']}", flush=True)
    return seen


def phase_figures(tmp: str) -> None:
    """``three-way`` with its figures into ``tmp`` where matplotlib is
    installed; else one line saying the figures were not drawn."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed on this machine: the three-way "
              "figures were not drawn (figures need matplotlib; the fits, "
              "the saved results and the report above do not)", flush=True)
        HOST["figures"] = "not drawn: no matplotlib"
        return
    with contextlib.chdir(tmp):
        cli_run(["three-way"])
    figs = sorted(p.name for p in pathlib.Path(tmp, "results").glob(
        "three_way_comparison_*/figures/*.png"))
    HOST["figures"] = figs
    print(f"three-way figures drawn: {figs}", flush=True)
    require(len(figs) == 8, f"three-way drew {len(figs)} figures, not 8")


def phase_quick_test() -> None:
    proc = subprocess.run([sys.executable, "-m", "tame_torch.quick_test"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    print(f"python -m tame_torch.quick_test: exit {proc.returncode}; "
          f"{(proc.stdout.strip().splitlines() or [''])[-1]}", flush=True)
    require(proc.returncode == 0, f"python -m tame_torch.quick_test exited "
            f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr}")


def host_layer_paths(drive) -> None:
    """The command line, the experiments, the demo and the setup check on
    the card, each a path driven by ``drive`` (the launch counters zeroed
    before it) and timed beside the card."""
    import tempfile

    def run(label, fn, *args):
        return drive(label, timed_phase, label, fn, *args)

    cli, c = run("CLI fit n=2000 Good SMF", phase_cli_fit, [])
    require(c["spd_solve_inv"] == 16 * cli["n_iter"]
            and c["logdet_spd"] == cli["n_iter"] and c["fused_fit"] == 0,
            f"the CLI fit did not run 16 K1 and 1 K2 launches per "
            f"iteration: {c}")
    direct, c = run("engine fit n=2000 Good SMF", phase_direct_fit)
    require(c["spd_solve_inv"] == 16 * direct["n_iter"],
            f"the engine fit did not run K1 per block phase: {c}")
    same = all(cli[k] == direct[k] for k in ("n_iter", "elbo", "mse"))
    HOST["fit n=2000"] = dict(cli=cli, engine=direct)
    print(f"CLI fit n=2000 T=50 r=4: {cli['n_iter']} iterations, final "
          f"ELBO {cli['elbo']}, MSE {cli['mse']}; the engine alone: "
          f"{direct['n_iter']}, {direct['elbo']}, {direct['mse']}",
          flush=True)
    require(same, "the CLI's fit departs from the engine's at the printed "
            "precision")
    _, c = run("n=2000 fit in turns", phase_cli_overhead)
    require(c["spd_solve_inv"] == 4 * 16 * cli["n_iter"],
            f"the fits in turns did not run K1 per block phase: {c}")
    masked, c = run("CLI fit n=2000 Good SMF, 30 % hidden", phase_cli_fit,
                    ["--missing-frac", "0.3"])
    HOST["fit n=2000 masked"] = masked
    print(f"CLI fit n=2000, 30 % hidden: {masked['n_iter']} iterations, "
          f"observed MSE {masked['observed']}, held-out MSE "
          f"{masked['held_out']}; stages (s) {masked['stages']}", flush=True)
    require(c["spd_solve_inv"] > 0 and c["logdet_spd"] > 0,
            f"the masked CLI fit did not run K1 and K2: {c}")
    require(masked["held_out"] < 2.0 * masked["observed"] + 0.05,
            "the masked CLI fit does not recover the held-out dyads")
    n_iter, c = run("CLI fit n=2000 smoothed, warm", phase_cli_smoothed)
    print(f"CLI smoothed fit n=2000: {n_iter} iterations; stages (s) "
          f"{HOST['smoothed']}", flush=True)
    require(c["fused_smoother"] == 16 * n_iter, f"the CLI smoothed fit did "
            f"not launch K4 16 times per iteration ({n_iter}): {c}")
    n_iter, c = run("CLI checkpointed fit n=2000", phase_cli_checkpoint)
    # 20 + 20 resumed + 40 one-shot iterations
    require(n_iter != 40 or (c["spd_solve_inv"] == 16 * 80
                             and c["logdet_spd"] == 80),
            f"the checkpointed CLI fits did not run 16 K1 and 1 K2 "
            f"launches per iteration: {c}")
    for method in ("binary", "poisson"):
        res, c = run(f"CLI fit {method} n=1000", phase_cli_family, method)
        require(c["spd_solve_inv"] > 0 and c["logdet_spd"] > 0
                and c["fused_fit"] == 0 and c["fused_smoother"] == 0,
                f"the CLI {method} fit did not run K1 and K2 only: {c}")
    _, c = run("CLI learn n=1000", phase_cli_learn)
    require(c["fused_smoother"] > 0, f"the CLI learn did not run K4: {c}")
    for sampler in ("nuts", "hmc", "smc"):
        _, c = run(f"CLI sample {sampler}", phase_cli_sample, sampler)
        require(c["fused_fit"] + c["spd_solve_inv"] > 0, f"the {sampler} "
                f"preconditioner launched neither K3 nor K1: {c}")
    with tempfile.TemporaryDirectory() as tmp:
        _, c = run("CLI demo", phase_cli_demo, f"{tmp}/demo")
        require(c["fused_fit"] == 3, f"the demo did not run one K3 launch "
                f"per engine: {c}")
        _, c = run("CLI three-way", phase_cli_experiment, ["three-way"], 4)
        require(c["fused_fit"] == 3 and c["fused_smoother"] > 0,
                f"three-way did not run K3 for Naive, Good and Bad and K4 "
                f"for the smoothed fit: {c}")
        _, c = run("CLI mult-strength", phase_cli_experiment,
                   ["mult-strength"], 6)
        require(c["fused_fit"] == 6, f"mult-strength did not run one K3 "
                f"launch per fit (6): {c}")
        # 5 values x 2 methods x 3 replicates
        _, c = run("CLI sensitivity n_nodes", phase_cli_experiment,
                   ["sensitivity"], 30)
        require(c["fused_fit"] == 30, f"the n_nodes sweep did not run one "
                f"K3 launch per replicate (5 values x 2 methods x 3): {c}")
        _, c = run("CLI sensitivity missing_frac", phase_cli_experiment,
                   ["sensitivity", "--parameter", "missing_frac", "--values",
                    "0.0", "0.1", "0.3", "0.5"], 24)
        require(c["fused_fit"] == 6 and c["spd_solve_inv"] > 0,
                f"the missing_frac sweep did not run K3 unmasked and K1 "
                f"masked: {c}")
        _, c = run("CLI binary-compare", phase_cli_experiment,
                   ["binary-compare"], 3)
        require(c["spd_solve_inv"] > 0 and c["logdet_spd"] > 0
                and c["fused_smoother"] > 0, f"binary-compare did not run "
                f"K1, K2 and K4: {c}")
        drive("three-way saved", timed_phase, "three-way saved",
              phase_saved_results, tmp)
        drive("three-way figures", timed_phase, "three-way figures",
              phase_figures, tmp)
    drive("quick_test", timed_phase, "quick_test", phase_quick_test)
    print(f"host-layer paths: {json.dumps(HOST)}", flush=True)


# ---------------------------------------------------------------------------
# tame_torch.parallel: fits sharded over ranks, chains over the batch axis
# ---------------------------------------------------------------------------

PARALLEL: dict = {}     # the sharded phases' numbers, printed at the end
SHARDED_FIT = dict(structure="full", update_mode="block", num_blocks=16,
                   learning_rate=0.8)
ONE_RANK_ELBO_RTOL = 1e-6   # one rank: the single-device arithmetic
# Several ranks: the ELBO's sums all-reduced in another order
# (multihost_proof.py's bounds).
SHARDED_DX, SHARDED_ELBO_RTOL = 5e-4, 1e-5
SMOOTHED_ELBO_RTOL = 1e-5
BUDGET, SMOOTHED_ITERS, TURN_ITERS = 100, 10, 30
ATOL_HMC, ATOL_SMC = 1e-5, 1e-4
# The sharded masked legs: masked_fit's flags (bf16 weights, stats
# diagnostics, lr 0.8) with SHARDED_FIT's 16 blocks; the bf16 einsum mask
# and K5 (TAME_PACKED_MASK=1).
MASKED_FIT = dict(SHARDED_FIT, mixed_precision=True, diag_mode="stats")
MASKED_SMOOTHED = dict(max_iter=SMOOTHED_ITERS, tolerance=0.0,
                       learning_rate=0.8, update_mode="block", num_blocks=16,
                       mixed_precision=True, diag_mode="stats")
MASKED_PATHS = (("masked einsum", False), ("masked K5", True))
MASKED_BUDGET, SEQ_ITERS, FAMILY_ITERS = 30, 30, 20
NS_SHAPE = (2000, 50, 4)         # (n, T, r) of the sharded north-star legs
SHARDED_FAMILY = (1000, 20, 2)   # (n, T, r) of the sharded family legs
RESUME_TOTAL, RESUME_KILL = 16, 8
# Several ranks' seq sweep: the same solves, the ELBO summed in another
# order.
SEQ_SHARDED_RTOL = 1e-5
# The sharded warm inits, EM and smoothed families: the north-star warm
# init (dyadic means within WARM_DYAD_RTOL of the max on several ranks),
# one EM iteration from em_data()'s wrong start with its E-step to its stop
# (learned scalars within EM_SCALAR_RTOL relative, ELBO and exact ELBO
# within SHARDED_ELBO_RTOL), the smoothed Bernoulli fit at SHARDED_FAMILY
# (FAMILY_ITERS iterations, 30 % hidden, from the plain warm init).
WARM_DYAD_RTOL, EM_SCALAR_RTOL, EM_INNER = 1e-4, 1e-4, 60
EM_SCALARS = ("phi", "trQ", "trSigma0", "sigma2", "rho")
SMOOTHED_BERNOULLI = dict(family="bernoulli", max_iter=FAMILY_ITERS,
                          learning_rate=0.7, tolerance=0.0)


def north_star_inputs(device="cuda"):
    """``north_star_model``'s data (drawn on the card), its parameters and
    a random init from a CPU generator seeded 1: the same numbers in
    every process."""
    from tame_torch.inference import cavi

    model = north_star_model()
    init = cavi.init_state(torch.Generator().manual_seed(1), 2000, 50, 10,
                           "full", 0.1, 0.5)
    return model.Y, model.params.to(model.Y.device), init


def on_card(state):
    return type(state)(*(t.cuda() for t in state))


def max_rel(got, ref) -> float:
    got, ref = torch.as_tensor(got), torch.as_tensor(ref)
    return ((got - ref).abs() / ref.abs()).max().item()


def counted(wrappers: dict, fn):
    """``(fn(), launches)`` with the counters zeroed before it (in a
    spawned rank, whose counters are its own)."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items()}


def launches_of(wrappers: dict, fn):
    """``(fn(), launches)``, the launches ``fn`` added: the counters run on,
    so a path's own counts keep them."""
    before = {k: w.launches for k, w in wrappers.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches - before[k] for k, w in wrappers.items()}


def kernel_wrappers() -> dict:
    from tame_torch.ops import cholesky as ch
    from tame_torch.ops import fused_fit as ff
    from tame_torch.ops import fused_smoother as fs
    from tame_torch.ops import masked_contract as mc

    return {"spd_solve_inv": ch.spd_solve_inv_kernel,
            "logdet_spd": ch.logdet_spd_kernel,
            "fused_fit": ff.fused_fit_kernel,
            "fused_smoother": fs.fused_smoother_kernel,
            "masked_contract": mc.packed_rows_contract_kernel}


def masked_launches(label: str, c: dict, n_iter: int, packed: bool) -> None:
    """A masked north-star fit's launches: 16 K1 and 1 K2 per iteration,
    32 K5 under TAME_PACKED_MASK=1 (16 block-phase stripes and 16
    diagnostics stripes), K3 never."""
    k5 = 32 * n_iter if packed else 0
    require(c["spd_solve_inv"] == 16 * n_iter and c["logdet_spd"] == n_iter
            and c["masked_contract"] == k5 and c["fused_fit"] == 0,
            f"{label}: not 16 K1, 1 K2 and {k5 // max(n_iter, 1)} K5 "
            f"launches per iteration ({n_iter}), K3 never: {c}")


def smoothed_launches(label: str, c: dict, n_iter: int) -> None:
    """The masked smoothed fit through K5: 16 K4 and 48 K5 launches per
    iteration (precision and offset stripes per phase, diagnostics
    stripes)."""
    require(c["fused_smoother"] == 16 * n_iter
            and c["masked_contract"] == 48 * n_iter,
            f"{label}: not 16 K4 and 48 K5 launches per iteration "
            f"({n_iter}): {c}")


def seq_inputs():
    """The demo data on the card, its parameters and a Good-SMF init from a
    CPU generator seeded 0: the same numbers in every process."""
    from tame_torch.inference import cavi

    model = demo_model("cuda")
    init = cavi.init_state(torch.Generator().manual_seed(0), 15, 10, 6,
                           "full", 0.1, 0.5)
    return model.Y, model.params.to("cuda"), init


def seq_fit(Y, params, init, max_iter=SEQ_ITERS):
    from tame_torch.inference import cavi

    return cavi.fit_cavi(Y, params, init, structure="full",
                         update_mode="seq", learning_rate=0.7,
                         max_iter=max_iter)


def family_sharded_inputs(family: str):
    """``family_model``'s n=1000, T=20, r=2 data with 30 % of the dyads
    hidden (drawn on the card) and a random init from a CPU generator
    seeded 1."""
    from tame_torch.inference import cavi
    from tame_torch.models import random_dyad_mask

    model = family_model(family, *SHARDED_FAMILY)
    mask = random_dyad_mask(torch.Generator(device="cuda").manual_seed(1),
                            *SHARDED_FAMILY[:2], MISSING_FRAC)
    init = cavi.init_state(torch.Generator().manual_seed(1),
                           *SHARDED_FAMILY[:2], 6, "full", 0.1, 0.5)
    return model.Y, model.params.to("cuda"), init, mask


def family_sharded_fit(family: str, Y, params, init, mask, **kw):
    from tame_torch.inference import fit_cavi_bernoulli, fit_cavi_poisson

    if family == "bernoulli":
        return fit_cavi_bernoulli(Y, params, init, mask=mask,
                                  learning_rate=0.8, tolerance=0.0, **kw)
    return fit_cavi_poisson(Y, params, init, mask=mask, learning_rate=0.7,
                            tolerance=0.0, **kw)


def sampler_model():
    from tame_torch import TemporalAMEModel

    model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1, seed=7)
    model.generate_data()
    return model


def sharded_samplers(mesh) -> dict:
    """HMC (64 chains), NUTS (8) and SMC (64 particles) at
    ``tests/test_parallel.py``'s sizes with the chains over ``mesh``'s
    batch axis, beside the same samplers unsharded on this rank."""
    from tame_torch.inference import (
        TemporalAMEHMC,
        TemporalAMENUTS,
        TemporalAMESMC,
    )

    model = sampler_model()
    hmc = TemporalAMEHMC(model, num_chains=64, num_leapfrog=5, seed=3,
                         precondition=False)
    t0 = time.perf_counter()
    sh = hmc.sample(num_warmup=15, num_samples=15, mesh=mesh)
    hmc_s = time.perf_counter() - t0
    ref = hmc.sample(num_warmup=15, num_samples=15)
    nuts = TemporalAMENUTS(model, num_chains=8, max_depth=4, seed=3,
                           precondition=False)
    nu = nuts.sample(num_warmup=10, num_samples=10, mesh=mesh).full()
    nu_ref = nuts.sample(num_warmup=10, num_samples=10)
    smc = TemporalAMESMC(model, num_particles=64, num_stages=5, num_moves=1,
                         seed=3, precondition=False)
    res, sref = smc.sample(mesh=mesh), smc.sample()
    return {
        "hmc_local_chains": sh.positions.shape[0], "hmc_s": hmc_s,
        "hmc_dx": (sh.full().positions - ref.positions).abs().max().item(),
        "nuts_finite": bool(torch.isfinite(nu.positions).all()),
        "nuts_mean_dx": (nu.positions.mean((0, 1)) - nu_ref.positions.mean(
            (0, 1))).abs().max().item(),
        "smc_dx": (res.full().particles - sref.particles).abs().max().item(),
        "smc_evidence_dx": abs(float(res.log_evidence)
                               - float(sref.log_evidence))}


def sharded_rank(rank: int, backend: str, refs: dict) -> dict:
    """One rank of phases 40-43: the north-star fits sharded over a
    nodes mesh of the world (fixed budget against phase 39, to the stop,
    the smoothed fit), then the samplers over a batch mesh."""
    import tame_torch  # noqa: F401  (TF32 off)
    from tame_torch.inference import cavi, smoothed
    from tame_torch.parallel import comm as pcomm
    from tame_torch.parallel import (
        make_mesh,
        shard_fit_inputs,
        shard_smoothed_inputs,
    )
    from tame_torch.parallel.comm_analysis import count_iteration

    world = pcomm.world_size()
    mesh = make_mesh(nodes=world, device="cuda", backend=backend)
    wrappers = kernel_wrappers()
    Y, params, init = north_star_inputs()
    warm = smoothed.warm_init_smoothed_state(Y, params)
    warm = type(warm)(*(t.cpu() for t in warm))
    mask = hidden_dyads(*NS_SHAPE[:2]).cpu()   # a rank keeps only its rows
    Y = Y.cpu()   # a rank keeps only its rows on the card
    torch.cuda.empty_cache()
    out = {"rank": rank, "device": str(mesh.device)}
    Y_s, init_s = shard_fit_inputs(mesh, Y, init)
    t0 = time.perf_counter()
    fit, out["budget_launches"] = counted(wrappers, lambda: cavi.fit_cavi(
        Y_s, params, init_s, max_iter=BUDGET, tolerance=0.0, **SHARDED_FIT))
    out["budget_ms_per_iter"] = (time.perf_counter() - t0) * 1e3 / BUDGET
    full = fit.full()
    out["budget_dx"] = (full.X_mean.cpu() - refs["X_mean"]).abs().max()\
        .item()
    out["budget_elbo_rel"] = max_rel(fit.elbo_history[:BUDGET],
                                     refs["elbo"])
    out["collectives_per_iteration"] = count_iteration(
        mesh, *NS_SHAPE, num_blocks=16)
    conv, out["stop_launches"] = counted(wrappers, lambda: cavi.fit_cavi(
        Y_s, params, init_s, max_iter=200, **SHARDED_FIT))
    out["stop"] = (conv.n_iter, conv.converged)
    Ys_s, warm_s = shard_smoothed_inputs(mesh, Y, warm)
    t0 = time.perf_counter()
    sm, out["smoothed_launches"] = counted(
        wrappers, lambda: smoothed.fit_cavi_smoothed(
            Ys_s, params, warm_s, max_iter=SMOOTHED_ITERS, tolerance=0.0,
            learning_rate=0.8))
    out["smoothed_ms_per_iter"] = ((time.perf_counter() - t0) * 1e3
                                   / SMOOTHED_ITERS)
    out["smoothed_elbo_rel"] = max_rel(sm.elbo_history[:SMOOTHED_ITERS],
                                       refs["smoothed_elbo"])
    del fit, full, conv, sm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out.update(sharded_masked(mesh, wrappers, Y_s, Ys_s, warm_s, params,
                              init_s, mask, refs))
    del Y, Y_s, warm_s, mask
    torch.cuda.empty_cache()
    out.update(sharded_small_legs(mesh, wrappers, refs))
    out["new_legs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.update(sharded_em_legs(mesh, wrappers, Ys_s, warm, params, refs))
    out["em_legs_s"] = time.perf_counter() - t0
    del Ys_s
    torch.cuda.empty_cache()
    batch = make_mesh(batch=world, device="cuda", backend=backend)
    out.update(sharded_samplers(batch))
    return out


def sharded_masked(mesh, wrappers, Y_s, Ys_s, warm_s, params, init_s, mask,
                   refs) -> dict:
    """One rank's masked north-star legs (phases 40-42): the production
    flags through the bf16 einsum mask and through K5, at the fixed budget
    against the one-rank references and to the stop; the masked smoothed
    fit (from phase 42's warm init) through K4 and K5; the collectives of
    one masked iteration."""
    from tame_torch.inference import cavi, smoothed
    from tame_torch.parallel.comm_analysis import count_iteration

    out = {}
    for label, packed in MASKED_PATHS:
        ref = refs["masked"][label]
        with packed_mask_env(packed):
            t0 = time.perf_counter()
            fit, c = counted(wrappers, lambda: cavi.fit_cavi(
                Y_s, params, init_s, mask=mask, max_iter=MASKED_BUDGET,
                tolerance=0.0, **MASKED_FIT))
            ms = (time.perf_counter() - t0) * 1e3 / MASKED_BUDGET
            conv, cs = counted(wrappers, lambda: cavi.fit_cavi(
                Y_s, params, init_s, mask=mask, max_iter=200, **MASKED_FIT))
        out[label] = dict(
            ms_per_iter=ms, launches=c, stop_launches=cs,
            dx=(fit.full().X_mean.cpu() - ref["X_mean"]).abs().max().item(),
            elbo_rel=max_rel(fit.elbo_history[:MASKED_BUDGET], ref["elbo"]),
            stop=(conv.n_iter, conv.converged))
    with packed_mask_env(True):
        t0 = time.perf_counter()
        sm, c = counted(wrappers, lambda: smoothed.fit_cavi_smoothed(
            Ys_s, params, warm_s, mask=mask, **MASKED_SMOOTHED))
    out["masked smoothed"] = dict(
        ms_per_iter=(time.perf_counter() - t0) * 1e3 / SMOOTHED_ITERS,
        launches=c, elbo_rel=max_rel(sm.elbo_history[:SMOOTHED_ITERS],
                                     refs["masked smoothed"]))
    out["masked_collectives"] = count_iteration(
        mesh, *NS_SHAPE, num_blocks=16, masked=True,
        mixed_precision=True, diag_mode="stats")
    return out


def sharded_small_legs(mesh, wrappers, refs) -> dict:
    """One rank's smaller legs in the same world: the seq sweep at the
    demo shape, the masked Bernoulli and Poisson fits at n=1000, T=20,
    r=2, and a Poisson fit killed at 8 of 16 iterations and resumed from
    the sharded result's carry."""
    from tame_torch.parallel import shard_fit_inputs

    out = {}
    Y, params, init = seq_inputs()
    Y_s, init_s = shard_fit_inputs(mesh, Y.cpu(), init)
    t0 = time.perf_counter()
    seq, c = counted(wrappers, lambda: seq_fit(Y_s, params, init_s))
    out["seq"] = dict(
        launches=c, stop=(seq.n_iter, seq.converged),
        plain_stop=refs["seq_stop"],
        ms_per_iter=(time.perf_counter() - t0) * 1e3 / seq.n_iter,
        elbo_rel=max_rel(seq.elbo_history[:min(seq.n_iter,
                                                len(refs["seq"]))],
                         refs["seq"][:seq.n_iter]))
    for family in ("bernoulli", "poisson"):
        Y, params, init, mask = family_sharded_inputs(family)
        Y_s, init_s = shard_fit_inputs(mesh, Y.cpu(), init)
        mask = mask.cpu()
        ref = refs["family"][family]
        t0 = time.perf_counter()
        fit, c = counted(wrappers, lambda: family_sharded_fit(
            family, Y_s, params, init_s, mask, max_iter=FAMILY_ITERS))
        out[family] = dict(
            launches=c,
            ms_per_iter=(time.perf_counter() - t0) * 1e3 / FAMILY_ITERS,
            dx=(fit.full().X_mean.cpu() - ref["X_mean"]).abs().max().item(),
            elbo_rel=max_rel(fit.elbo_history[:FAMILY_ITERS], ref["elbo"]))
    # Y_s, init_s and mask are the Poisson leg's
    (one, head, tail), c = counted(wrappers, lambda: killed_sharded_poisson(
        mesh, Y, Y_s, params, init_s, mask))
    out["poisson resume"] = dict(
        launches=c, bits=bool(
            torch.equal(tail.full().X_mean, one.full().X_mean)
            and torch.equal(tail.full().X_cov, one.full().X_cov)
            and torch.equal(torch.cat([head.elbo_history[:RESUME_KILL],
                                       tail.elbo_history[:RESUME_TOTAL
                                                         - RESUME_KILL]]),
                            one.elbo_history[:RESUME_TOTAL])))
    return out


def killed_sharded_poisson(mesh, Y, Y_s, params, init_s, mask):
    """A sharded Poisson fit of RESUME_TOTAL iterations in one shot, and
    the same killed after RESUME_KILL and resumed from the stopped fit's
    state and ``resume_carry()``."""
    from tame_torch.parallel import shard_fit_inputs

    one = family_sharded_fit("poisson", Y_s, params, init_s, mask,
                             max_iter=RESUME_TOTAL)
    head = family_sharded_fit("poisson", Y_s, params, init_s, mask,
                              max_iter=RESUME_KILL)
    _, mid = shard_fit_inputs(mesh, Y.cpu(), head.full())
    tail = family_sharded_fit("poisson", Y_s, params, mid, mask,
                              max_iter=RESUME_TOTAL - RESUME_KILL,
                              carry=head.resume_carry())
    return one, head, tail


def centroid_fwd(X_mean: torch.Tensor) -> torch.Tensor:
    """The dyadic means ``a_i + b_j + U_i . V_j`` (n, n) of a warm init's
    centroid (its t = 0 slice; every t holds the same)."""
    X = X_mean[:, 0]
    r = (X.shape[-1] - 2) // 2
    return X[:, 0, None] + X[None, :, 1] + X[:, 2:2 + r] @ X[:, 2 + r:].T


def timed_warm_init(mesh, Y_s, params):
    """The smoothed warm init of a sharded ``Y``, host-timed, with its
    collectives: ``(state, ms, collectives)``.  The first call on a mesh
    also sets up its ``nodes`` group's communicator, so the phases time a
    second."""
    from tame_torch.inference import smoothed

    torch.cuda.synchronize()
    mesh.comm.reset()
    t0 = time.perf_counter()
    out = smoothed.warm_init_smoothed_state(Y_s, params)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, mesh.comm.stats()


def em_iteration(Y, start, init):
    """One ``fit_em`` iteration from ``init`` (its E-step to its stop, at
    most EM_INNER iterations), host-timed: ``(result, E-step iterations,
    ms)``."""
    from tame_torch.inference import fit_em

    tally: list = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting_inner_iterations(tally, "fit_cavi_smoothed"):
        res = fit_em(Y, start, init=init, n_em=1, inner_max_iter=EM_INNER)
    torch.cuda.synchronize()
    return res, tally, (time.perf_counter() - t0) * 1e3


def em_summary(res, stops: list, Y) -> dict:
    """The learned scalars, the E-step's final ELBO and stops, and the exact
    ELBO of the result (the learned parameters, the E-step's posterior)."""
    from tame_torch.inference import exact_elbo

    h = res.history
    return {**{k: h[k][0] for k in EM_SCALARS}, "elbo": h["elbo"][0],
            "stops": stops,
            "exact_elbo": float(exact_elbo(Y, res.params, res.state))}


def phase_one_rank_em(one: dict, Y, params) -> dict:
    """Phase 39's mesh beside the plain functions, bit for bit: the
    north-star warm init (timed, its collectives); one Gaussian EM
    iteration from em_data()'s wrong start and its own warm init, the
    E-step to its stop (at most EM_INNER), with the exact ELBO of the
    result and the collectives of the EM iteration; the smoothed
    Bernoulli fit at n=1000, T=20, r=2 with 30 % hidden from the plain
    warm init, and that family's warm init from the rank's rows.  Returns
    what the sharded worlds match."""
    from tame_torch.inference import (
        fit_smoothed_family,
        smoothed,
        warm_init_smoothed_family,
    )
    from tame_torch.parallel import shard_smoothed_inputs

    mesh, wrappers = one["mesh"], kernel_wrappers()
    report, refs = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = smoothed.warm_init_smoothed_state(Y, params)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    first_ms = timed_warm_init(mesh, one["Y_s"], params)[1]
    warm, ms, coll = timed_warm_init(mesh, one["Y_s"], params)
    report["warm init"] = dict(
        ms=ms, first_ms=first_ms, plain_ms=plain_ms, collectives=coll,
        bit_for_bit=all(torch.equal(a, b)
                        for a, b in zip(warm.full(), plain)))
    require(report["warm init"]["bit_for_bit"], "the one-rank warm init is "
            "not the plain warm init's bits")
    del plain, warm

    Y_em, start = em_data()
    Y_em_s, _ = shard_smoothed_inputs(mesh, Y_em)
    init = smoothed.warm_init_smoothed_state(Y_em, start)
    init_s = smoothed.warm_init_smoothed_state(Y_em_s, start)
    (res, stops, plain_ms), pc = launches_of(
        wrappers, lambda: em_iteration(Y_em, start, init))
    mesh.comm.reset()
    (res_s, stops_s, ms), sc = launches_of(
        wrappers, lambda: em_iteration(Y_em_s, start, init_s))
    coll = mesh.comm.stats()
    got, want = em_summary(res_s, stops_s, Y_em_s), em_summary(res, stops,
                                                                Y_em)
    bits = bool(got == want
                and all(torch.equal(a, b)
                        for a, b in zip(res_s.params, res.params))
                and all(torch.equal(a, b)
                        for a, b in zip(res_s.state.full(), res.state)))
    report["EM"] = dict(got, ms=ms, plain_ms=plain_ms, launches=sc,
                        collectives_per_em_iteration=coll, bit_for_bit=bits)
    require(bits, f"the one-rank EM iteration is not the plain one's bits: "
            f"{got} against {want}")
    for label, c, n in (("plain", pc, stops), ("one-rank", sc, stops_s)):
        require(c["fused_smoother"] == 16 * sum(n), f"the {label} EM E-step "
                f"did not launch K4 once per block phase ({n}): {c}")
    refs["em"] = got
    del Y_em, Y_em_s, init, init_s, res, res_s
    torch.cuda.empty_cache()

    Yb, pb, _, mask = family_sharded_inputs("bernoulli")
    host_mask = mask.cpu()
    warm = warm_init_smoothed_family(Yb, pb, "bernoulli", obs_mask=mask)
    Yb_s, warm_s = shard_smoothed_inputs(mesh, Yb, warm)
    own = warm_init_smoothed_family(Yb_s, pb, "bernoulli",
                                    obs_mask=host_mask)
    warm_bits = all(torch.equal(a, b) for a, b in zip(own.full(), warm))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, pc = launches_of(wrappers, lambda: fit_smoothed_family(
        Yb, pb, warm, mask=mask, **SMOOTHED_BERNOULLI))
    t1 = time.perf_counter()
    fit_s, sc = launches_of(wrappers, lambda: fit_smoothed_family(
        Yb_s, pb, warm_s, mask=host_mask, **SMOOTHED_BERNOULLI))
    t2 = time.perf_counter()
    bits = bool(torch.equal(fit_s.field("state").full().X_mean,
                            fit.state.X_mean)
                and torch.equal(fit_s.elbo_history[:FAMILY_ITERS],
                                fit.elbo_history[:FAMILY_ITERS]))
    report["smoothed Bernoulli"] = dict(
        ms_per_iter=(t2 - t1) * 1e3 / FAMILY_ITERS,
        plain_ms_per_iter=(t1 - t0) * 1e3 / FAMILY_ITERS, launches=sc,
        warm_init_bit_for_bit=warm_bits, bit_for_bit=bits)
    require(bits and warm_bits, f"the one-rank smoothed Bernoulli fit or its "
            f"warm init is not the plain one's bits: {report}")
    for label, c in (("plain", pc), ("one-rank", sc)):
        require(c["fused_smoother"] == FAMILY_ITERS, f"the {label} smoothed "
                f"Bernoulli fit did not launch K4 once per iteration: {c}")
    refs["bernoulli"] = {"X_mean": fit.state.X_mean.cpu(),
                         "elbo": fit.elbo_history[:FAMILY_ITERS]}
    PARALLEL["one NCCL rank, warm init / EM / smoothed Bernoulli"] = report
    print(f"n=2000 T=50 r=4 warm init and EM, n=1000 T=20 r=2 smoothed "
          f"Bernoulli, one-rank NCCL mesh beside the plain functions: "
          f"{json.dumps(report)} on {CARD}", flush=True)
    return refs


def sharded_em_legs(mesh, wrappers, Ys_s, warm, params, refs) -> dict:
    """One rank's legs of the sharded warm init, EM and smoothed family:
    the north-star warm init from the rank's rows against the plain one
    (``warm``; dyadic means), timed, with its collectives; one EM
    iteration from em_data()'s wrong start and the sharded warm init, its
    E-step to its stop, against the one-rank run (learned scalars, stop,
    ELBO, exact ELBO), its collectives beside
    ``comm_analysis.count_em_iteration``'s; the smoothed Bernoulli fit
    against the one-rank fit, with its K4 launches."""
    from tame_torch.inference import (
        fit_smoothed_family,
        smoothed,
        warm_init_smoothed_family,
    )
    from tame_torch.parallel import shard_smoothed_inputs
    from tame_torch.parallel.comm_analysis import count_em_iteration

    out, ref = {}, refs["em legs"]
    first_ms = timed_warm_init(mesh, Ys_s, params)[1]
    own, ms, coll = timed_warm_init(mesh, Ys_s, params)
    got = centroid_fwd(own.full().X_mean)
    want = centroid_fwd(warm.X_mean.to(got.device))
    out["warm init"] = dict(ms=ms, first_ms=first_ms, collectives=coll,
                            dyad_rel=((got - want).abs().max()
                                      / want.abs().max()).item())
    del own, got, want

    Y_em, start = em_data()
    Y_em_s, _ = shard_smoothed_inputs(mesh, Y_em.cpu())
    del Y_em
    torch.cuda.empty_cache()
    init_s = smoothed.warm_init_smoothed_state(Y_em_s, start)
    mesh.comm.reset()
    (res, stops, ms), c = counted(wrappers, lambda: em_iteration(
        Y_em_s, start, init_s))
    coll = mesh.comm.stats()
    got, want = em_summary(res, stops, Y_em_s), ref["em"]
    out["EM"] = dict(
        got, ms=ms, launches=c, collectives_per_em_iteration=coll,
        counted=count_em_iteration(mesh, *NS_SHAPE, sum(stops))[
            "em_iteration"],
        scalar_rel=max(abs(got[k] - want[k]) / abs(want[k])
                       for k in EM_SCALARS),
        elbo_rel=abs(got["elbo"] - want["elbo"]) / abs(want["elbo"]),
        exact_rel=(abs(got["exact_elbo"] - want["exact_elbo"])
                   / abs(want["exact_elbo"])))
    del Y_em_s, init_s, res
    torch.cuda.empty_cache()

    Yb, pb, _, mask = family_sharded_inputs("bernoulli")
    warm_b = warm_init_smoothed_family(Yb, pb, "bernoulli", obs_mask=mask)
    Yb_s, warm_s = shard_smoothed_inputs(mesh, Yb.cpu(), warm_b)
    mask = mask.cpu()
    del Yb
    t0 = time.perf_counter()
    fit, c = counted(wrappers, lambda: fit_smoothed_family(
        Yb_s, pb, warm_s, mask=mask, **SMOOTHED_BERNOULLI))
    b = ref["bernoulli"]
    out["smoothed Bernoulli"] = dict(
        launches=c,
        ms_per_iter=(time.perf_counter() - t0) * 1e3 / FAMILY_ITERS,
        dx=(fit.field("state").full().X_mean.cpu() - b["X_mean"]).abs()
        .max().item(),
        elbo_rel=max_rel(fit.elbo_history[:FAMILY_ITERS], b["elbo"]))
    return out


def check_em_legs(label: str, ranks: list) -> None:
    """The sharded warm init, EM and smoothed Bernoulli legs on every rank
    of one world: the gates, one E-step stop, the collectives of the EM
    iteration as ``count_em_iteration`` counts them, K4 launches."""
    for r in ranks:
        tag = f"{label}, rank {r['rank']}"
        warm, em, fam = (r["warm init"], r["EM"], r["smoothed Bernoulli"])
        require(warm["dyad_rel"] <= WARM_DYAD_RTOL, f"{tag}: the sharded "
                f"warm init's dyadic means are off the plain ones: "
                f"{warm['dyad_rel']}")
        require(em["scalar_rel"] <= EM_SCALAR_RTOL
                and em["elbo_rel"] <= SHARDED_ELBO_RTOL
                and em["exact_rel"] <= SHARDED_ELBO_RTOL,
                f"{tag}: the sharded EM iteration is off the one-rank one: "
                f"{em}")
        require(em["stops"] == ranks[0]["EM"]["stops"], f"{tag}: the ranks' "
                f"E-steps stopped apart")
        require(em["collectives_per_em_iteration"] == em["counted"],
                f"{tag}: the EM iteration's collectives are not "
                f"count_em_iteration's: {em}")
        require(em["launches"]["fused_smoother"] == 16 * sum(em["stops"]),
                f"{tag}: the sharded E-step did not launch K4 once per block "
                f"phase: {em['launches']}")
        require(fam["dx"] <= SHARDED_DX
                and fam["elbo_rel"] <= SHARDED_ELBO_RTOL,
                f"{tag}: the sharded smoothed Bernoulli fit is off the "
                f"one-rank fit: {fam}")
        require(fam["launches"]["fused_smoother"] == FAMILY_ITERS,
                f"{tag}: the sharded smoothed Bernoulli fit did not launch K4 "
                f"once per iteration: {fam['launches']}")
    key = f"{label}, warm init / EM / smoothed Bernoulli"
    PARALLEL[key] = {
        "warm_init_ms": [r["warm init"]["ms"] for r in ranks],
        "warm_init_collectives": ranks[0]["warm init"]["collectives"],
        "warm_init_dyad_rel": max(r["warm init"]["dyad_rel"] for r in ranks),
        "em": {k: ranks[0]["EM"][k] for k in (*EM_SCALARS, "elbo", "stops",
                                               "exact_elbo")},
        "em_ms": [r["EM"]["ms"] for r in ranks],
        "em_collectives_per_iteration":
            ranks[0]["EM"]["collectives_per_em_iteration"],
        "em_scalar_rel": max(r["EM"]["scalar_rel"] for r in ranks),
        "em_elbo_rel": max(r["EM"]["elbo_rel"] for r in ranks),
        "em_exact_rel": max(r["EM"]["exact_rel"] for r in ranks),
        "bernoulli_ms_per_iter": [r["smoothed Bernoulli"]["ms_per_iter"]
                                  for r in ranks],
        "bernoulli_dx": max(r["smoothed Bernoulli"]["dx"] for r in ranks),
        "bernoulli_elbo_rel": max(r["smoothed Bernoulli"]["elbo_rel"]
                                  for r in ranks),
        "bernoulli_k4_per_rank_per_iteration": [
            r["smoothed Bernoulli"]["launches"]["fused_smoother"]
            / FAMILY_ITERS for r in ranks],
        "legs_s": [r["em_legs_s"] for r in ranks]}
    print(f"{key}: {json.dumps(PARALLEL[key])} on {CARD}", flush=True)


def check_sharded_world(label: str, ranks: list, ref_stop: int) -> None:
    """Phases 40-43's checks on every rank of one world."""
    from tame_torch.parallel.comm_analysis import layout_bytes

    stops = {r["stop"] for r in ranks}
    for r in ranks:
        tag = f"{label}, rank {r['rank']}"
        require(r["budget_dx"] < SHARDED_DX
                and r["budget_elbo_rel"] < SHARDED_ELBO_RTOL,
                f"{tag}: the fixed-budget fit is off phase 39's: "
                f"{r['budget_dx']}, {r['budget_elbo_rel']}")
        c = r["budget_launches"]
        require(c["spd_solve_inv"] == 16 * BUDGET
                and c["logdet_spd"] == BUDGET and c["fused_fit"] == 0,
                f"{tag}: not 16 K1 and 1 K2 launches per iteration: {c}")
        require(r["smoothed_launches"]["fused_smoother"]
                == 16 * SMOOTHED_ITERS, f"{tag}: the smoothed fit did not "
                f"launch K4 once per block phase: {r['smoothed_launches']}")
        require(r["smoothed_elbo_rel"] <= SMOOTHED_ELBO_RTOL,
                f"{tag}: the smoothed ELBO is off: "
                f"{r['smoothed_elbo_rel']}")
        require(r["hmc_dx"] <= ATOL_HMC, f"{tag}: HMC {r['hmc_dx']}")
        require(r["nuts_finite"] and r["nuts_mean_dx"] <= 0.5,
                f"{tag}: NUTS {r['nuts_mean_dx']}")
        require(r["smc_dx"] <= ATOL_SMC and r["smc_evidence_dx"] <= ATOL_SMC,
                f"{tag}: SMC {r['smc_dx']}, {r['smc_evidence_dx']}")
    require(len(stops) == 1 and next(iter(stops))[1],
            f"{label}: the ranks stopped apart or did not converge: {stops}")
    check_sharded_legs(label, ranks)
    check_em_legs(label, ranks)
    r0 = ranks[0]
    coll = r0["collectives_per_iteration"]
    want = layout_bytes(*NS_SHAPE, len(ranks), 1, 16)
    require(sum(v["bytes"] for v in coll.values()) == want,
            f"{label}: the collectives of one iteration are not the "
            f"layout's {want} bytes: {coll}")
    PARALLEL[label] = {
        "ranks": len(ranks), "devices": [r["device"] for r in ranks],
        "budget_ms_per_iter": [r["budget_ms_per_iter"] for r in ranks],
        "budget_dx": max(r["budget_dx"] for r in ranks),
        "budget_elbo_rel": max(r["budget_elbo_rel"] for r in ranks),
        "stop": r0["stop"][0], "one_rank_stop": ref_stop,
        "smoothed_ms_per_iter": [r["smoothed_ms_per_iter"] for r in ranks],
        "smoothed_elbo_rel": max(r["smoothed_elbo_rel"] for r in ranks),
        "collectives_per_iteration": coll,
        "collective_bytes_per_iteration": sum(v["bytes"]
                                              for v in coll.values()),
        "hmc_dx": max(r["hmc_dx"] for r in ranks),
        "hmc_s": [r["hmc_s"] for r in ranks],
        "nuts_mean_dx": max(r["nuts_mean_dx"] for r in ranks),
        "smc_dx": max(r["smc_dx"] for r in ranks),
        "smc_evidence_dx": max(r["smc_evidence_dx"] for r in ranks)}
    print(f"{label}: {json.dumps(PARALLEL[label])} on {CARD}", flush=True)


def check_sharded_legs(label: str, ranks: list) -> None:
    """The checks of the masked, seq and family legs on every rank of one
    world: the fixed budgets within the sharded bounds, one stop on every
    rank (printed beside the plain fit's, never gated on it: an ulp moves
    a masked bf16 stop), the kernels' launches per iteration per rank and
    the resumed Poisson fit's bits."""
    from tame_torch.parallel.comm_analysis import layout_bytes

    masked_world = {}
    for name, packed in MASKED_PATHS:
        for r in ranks:
            leg, tag = r[name], f"{label}, rank {r['rank']}, {name}"
            require(leg["dx"] < SHARDED_DX
                    and leg["elbo_rel"] < SHARDED_ELBO_RTOL,
                    f"{tag}: the fixed-budget fit is off the one-rank "
                    f"fit's: {leg['dx']}, {leg['elbo_rel']}")
            masked_launches(tag, leg["launches"], MASKED_BUDGET, packed)
            masked_launches(f"{tag} to the stop", leg["stop_launches"],
                            leg["stop"][0], packed)
        stops = {r[name]["stop"] for r in ranks}
        require(len(stops) == 1, f"{label}, {name}: the ranks stopped "
                f"apart: {stops}")
        masked_world[name] = {
            "ms_per_iter": [r[name]["ms_per_iter"] for r in ranks],
            "dx": max(r[name]["dx"] for r in ranks),
            "elbo_rel": max(r[name]["elbo_rel"] for r in ranks),
            "stop": ranks[0][name]["stop"]}
    for r in ranks:
        tag = f"{label}, rank {r['rank']}"
        leg = r["masked smoothed"]
        require(leg["elbo_rel"] <= SMOOTHED_ELBO_RTOL, f"{tag}: the masked "
                f"smoothed ELBO is off: {leg['elbo_rel']}")
        smoothed_launches(f"{tag}, masked smoothed", leg["launches"],
                          SMOOTHED_ITERS)
        seq = r["seq"]
        require(seq["elbo_rel"] <= SEQ_SHARDED_RTOL
                and seq["stop"] == tuple(seq["plain_stop"]),
                f"{tag}: the sharded seq fit is off the plain fit: ELBO "
                f"{seq['elbo_rel']}, stop {seq['stop']} against "
                f"{seq['plain_stop']}")
        n_seq = seq["stop"][0]
        require(seq["launches"]["spd_solve_inv"] == 15 * 10 * n_seq
                and seq["launches"]["logdet_spd"] == n_seq,
                f"{tag}: the seq sweep did not launch K1 n T times and K2 "
                f"once per iteration on every rank: {seq['launches']}")
        for family in ("bernoulli", "poisson"):
            leg = r[family]
            require(leg["dx"] < SHARDED_DX
                    and leg["elbo_rel"] < SHARDED_ELBO_RTOL,
                    f"{tag}: the masked {family} fit is off the plain "
                    f"fit's: {leg['dx']}, {leg['elbo_rel']}")
            c = leg["launches"]
            require(c["spd_solve_inv"] == FAMILY_ITERS
                    and c["logdet_spd"] == FAMILY_ITERS,
                    f"{tag}: the masked {family} fit did not launch K1 and "
                    f"K2 once per iteration: {c}")
        require(r["poisson resume"]["bits"], f"{tag}: the resumed sharded "
                f"Poisson fit is not the one-shot fit's bits")
        coll = r["masked_collectives"]
        want = layout_bytes(*NS_SHAPE, len(ranks), 1, 16)
        require(sum(v["bytes"] for v in coll.values()) == want,
                f"{tag}: one masked iteration's collectives are not the "
                f"layout's {want} bytes: {coll}")
    r0 = ranks[0]
    require(len({r["seq"]["stop"] for r in ranks}) == 1, f"{label}: the "
            f"seq ranks stopped apart")
    PARALLEL[f"{label}, masked and small legs"] = {
        **masked_world,
        "masked smoothed": {
            "ms_per_iter": [r["masked smoothed"]["ms_per_iter"]
                            for r in ranks],
            "elbo_rel": max(r["masked smoothed"]["elbo_rel"]
                            for r in ranks)},
        "masked_collectives_per_iteration": r0["masked_collectives"],
        "seq": {"stop": r0["seq"]["stop"],
                "ms_per_iter": [r["seq"]["ms_per_iter"] for r in ranks],
                "elbo_rel": max(r["seq"]["elbo_rel"] for r in ranks)},
        **{f"{family} masked": {
            "ms_per_iter": [r[family]["ms_per_iter"] for r in ranks],
            "dx": max(r[family]["dx"] for r in ranks),
            "elbo_rel": max(r[family]["elbo_rel"] for r in ranks)}
           for family in ("bernoulli", "poisson")},
        "poisson_resume_bit_for_bit": all(r["poisson resume"]["bits"]
                                          for r in ranks),
        "new_legs_s": [r["new_legs_s"] for r in ranks]}
    print(f"{label}, masked and small legs: "
          f"{json.dumps(PARALLEL[f'{label}, masked and small legs'])} on "
          f"{CARD}", flush=True)


def rank_launches(ranks: list) -> dict:
    """The launches of a spawned world's paths, summed over its ranks."""
    total = {}
    for r in ranks:
        counts = [r[key] for key in ("budget_launches", "stop_launches",
                                     "smoothed_launches")]
        counts += [r[leg][key] for leg, _ in MASKED_PATHS
                   for key in ("launches", "stop_launches")]
        counts += [r[leg]["launches"] for leg in (
            "masked smoothed", "seq", "bernoulli", "poisson",
            "poisson resume", "EM", "smoothed Bernoulli")]
        for c in counts:
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
    return total


def phase_one_rank(Y, params, init) -> dict:
    """Phase 39: the north-star block fit on a one-rank NCCL mesh beside
    the plain fit: the same stop, the ELBO history within 1e-6."""
    from tame_torch.inference import cavi
    from tame_torch.parallel import make_mesh, shard_fit_inputs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = cavi.fit_cavi(Y, params, on_card(init), max_iter=200,
                          **SHARDED_FIT)
    plain_s = time.perf_counter() - t0
    mesh = make_mesh()
    require(mesh.backend == "nccl" and mesh.size == 1,
            f"not a one-rank NCCL mesh: {mesh}")
    Y_s, init_s = shard_fit_inputs(mesh, Y, init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cavi.fit_cavi(Y_s, params, init_s, max_iter=200, **SHARDED_FIT)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    n = plain.n_iter
    rel = max_rel(out.elbo_history[:n], plain.elbo_history[:n])
    dx = (out.full().X_mean - plain.X_mean).abs().max().item()
    PARALLEL["one NCCL rank"] = dict(
        stop=out.n_iter, plain_stop=n, elbo_rel=rel, max_abs_dx=dx,
        ms_per_iter=sharded_s * 1e3 / out.n_iter,
        plain_ms_per_iter=plain_s * 1e3 / n,
        collectives=mesh.comm.stats())
    print(f"n=2000 T=50 r=4 on a one-rank NCCL mesh: "
          f"{json.dumps(PARALLEL['one NCCL rank'])} on {CARD}", flush=True)
    require(out.n_iter == n and out.converged == plain.converged,
            f"the one-rank fit stopped at {out.n_iter}, the plain at {n}")
    require(rel <= ONE_RANK_ELBO_RTOL, f"one-rank ELBO off by {rel}")
    return {"n_iter": n, "mesh": mesh, "Y_s": Y_s, "init_s": init_s}


def phase_references(one: dict, Y, params, init) -> dict:
    """The fixed-budget fit on phase 39's mesh and the one-rank smoothed
    fit, for the sharded worlds to match; and the plain and one-rank fits
    timed in turns (plain, one rank, one rank, plain) at a fixed budget."""
    from tame_torch.inference import cavi, smoothed

    turns = {"plain": [], "one rank": []}
    for label in ("plain", "one rank", "one rank", "plain"):
        args = ((Y, params, on_card(init)) if label == "plain"
                else (one["Y_s"], params, one["init_s"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cavi.fit_cavi(*args, max_iter=TURN_ITERS, tolerance=0.0,
                      **SHARDED_FIT)
        torch.cuda.synchronize()
        turns[label].append((time.perf_counter() - t0) * 1e3 / TURN_ITERS)
    PARALLEL["one NCCL rank"]["turns_ms_per_iter"] = turns
    print(f"n=2000 ms/iteration in turns ({TURN_ITERS} iterations each): "
          f"{turns} on {CARD}", flush=True)
    fit = cavi.fit_cavi(one["Y_s"], params, one["init_s"], max_iter=BUDGET,
                        tolerance=0.0, **SHARDED_FIT)
    warm = smoothed.warm_init_smoothed_state(Y, params)
    sm = smoothed.fit_cavi_smoothed(Y, params, warm,
                                    max_iter=SMOOTHED_ITERS, tolerance=0.0,
                                    learning_rate=0.8)
    return {"X_mean": fit.full().X_mean.cpu(),
            "elbo": fit.elbo_history[:BUDGET],
            "smoothed_elbo": sm.elbo_history[:SMOOTHED_ITERS]}


def phase_one_rank_masked(one: dict, Y, params, init) -> dict:
    """Phase 39's mesh with 30 % of the dyads hidden: the production
    flags through the bf16 einsum mask and through K5, each to its stop
    beside the plain fit, bit for bit (means, ELBO history, stop); the
    masked smoothed fit through K4 and K5 (10 iterations) beside the plain
    one, bit for bit; then the fixed-budget fits the sharded worlds
    match.  Each fit's launches are asserted."""
    from tame_torch.inference import cavi, smoothed
    from tame_torch.parallel import shard_smoothed_inputs

    wrappers = kernel_wrappers()
    mask = hidden_dyads(*NS_SHAPE[:2])
    host_mask = mask.cpu()   # the sharded fits slice it, then move it
    refs, report = {}, {}
    for label, packed in MASKED_PATHS:
        with packed_mask_env(packed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain, pc = launches_of(wrappers, lambda: cavi.fit_cavi(
                Y, params, on_card(init), mask=mask, max_iter=200,
                **MASKED_FIT))
            t1 = time.perf_counter()
            out, sc = launches_of(wrappers, lambda: cavi.fit_cavi(
                one["Y_s"], params, one["init_s"], mask=host_mask,
                max_iter=200, **MASKED_FIT))
            t2 = time.perf_counter()
            budget = cavi.fit_cavi(one["Y_s"], params, one["init_s"],
                                   mask=host_mask, max_iter=MASKED_BUDGET,
                                   tolerance=0.0, **MASKED_FIT)
        n = plain.n_iter
        full = out.full()
        bits = bool(out.n_iter == n
                    and torch.equal(full.X_mean, plain.X_mean)
                    and torch.equal(full.X_cov, plain.X_cov)
                    and torch.equal(out.elbo_history[:n],
                                    plain.elbo_history[:n]))
        report[label] = dict(stop=out.n_iter, plain_stop=n,
                             converged=out.converged, bit_for_bit=bits,
                             ms_per_iter=(t2 - t1) * 1e3 / out.n_iter,
                             plain_ms_per_iter=(t1 - t0) * 1e3 / n)
        require(bits, f"one-rank {label} fit is not the plain fit's bits: "
                f"{report[label]}")
        masked_launches(f"the plain {label} fit", pc, n, packed)
        masked_launches(f"the one-rank {label} fit", sc, n, packed)
        refs[label] = {"X_mean": budget.full().X_mean.cpu(),
                       "elbo": budget.elbo_history[:MASKED_BUDGET],
                       "stop": n}
    warm = smoothed.warm_init_smoothed_state(Y, params)
    Ys_s, warm_s = shard_smoothed_inputs(one["mesh"], Y, warm)
    with packed_mask_env(True):
        plain, pc = launches_of(wrappers, lambda: smoothed.fit_cavi_smoothed(
            Y, params, warm, mask=mask, **MASKED_SMOOTHED))
        out, sc = launches_of(wrappers, lambda: smoothed.fit_cavi_smoothed(
            Ys_s, params, warm_s, mask=host_mask, **MASKED_SMOOTHED))
    bits = bool(torch.equal(out.full().state.X_mean, plain.state.X_mean)
                and torch.equal(out.elbo_history[:SMOOTHED_ITERS],
                                plain.elbo_history[:SMOOTHED_ITERS]))
    report["masked smoothed"] = dict(iterations=SMOOTHED_ITERS,
                                     bit_for_bit=bits)
    require(bits, "the one-rank masked smoothed fit is not the plain fit's "
            "bits")
    smoothed_launches("the plain masked smoothed fit", pc, SMOOTHED_ITERS)
    smoothed_launches("the one-rank masked smoothed fit", sc,
                      SMOOTHED_ITERS)
    refs["masked smoothed"] = out.elbo_history[:SMOOTHED_ITERS]
    PARALLEL["one NCCL rank, masked"] = report
    print(f"n=2000 T=50 r=4, 30 % hidden, bf16 + stats, one-rank NCCL mesh "
          f"beside the plain fits: {json.dumps(report)} on {CARD}",
          flush=True)
    return refs


def phase_small_references() -> dict:
    """The plain fits the sharded worlds' smaller legs match: the seq
    sweep at the demo shape (K1 n T times per iteration) and the masked
    Bernoulli and Poisson fits at n=1000, T=20, r=2."""
    Y, params, init = seq_inputs()
    seq = seq_fit(Y, params, on_card(init))
    refs = {"seq": seq.elbo_history[:seq.n_iter],
            "seq_stop": (seq.n_iter, seq.converged), "family": {}}
    for family in ("bernoulli", "poisson"):
        Y, params, init, mask = family_sharded_inputs(family)
        fit = family_sharded_fit(family, Y, params, on_card(init), mask,
                                 max_iter=FAMILY_ITERS)
        refs["family"][family] = {"X_mean": fit.X_mean.cpu(),
                                  "elbo": fit.elbo_history[:FAMILY_ITERS]}
    return refs


def run_script(module: str, *argv: str) -> str:
    """``python -m <module> --device cuda <argv>`` from the checkout."""
    return run_scripts([(module, argv)])[0]


def run_scripts(scripts: list) -> list:
    """``python -m <module> --device cuda <argv>`` for each ``(module,
    argv)``, all started together from the checkout; each must exit 0
    within 600 s.  Returns their last output lines in order."""
    procs = [subprocess.Popen([sys.executable, "-m", module, "--device",
                               "cuda", *argv], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for module, argv in scripts]
    lines = []
    try:
        for (module, _), proc in zip(scripts, procs):
            out, err = proc.communicate(timeout=600)
            require(proc.returncode == 0, f"{module} failed:\n{out}\n{err}")
            lines.append(out.strip().splitlines()[-1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return lines


def parallel_paths(drive, paths: list, nccl_leg: bool = False) -> None:
    """Phases 39-44: ``tame_torch.parallel`` on the card.  ``nccl_leg``
    (``--nccl-leg``, on a machine with 2 cards or more) runs phase 39, its
    references and phase 41 alone, then ``multihost_proof`` and
    ``scaling_eval`` over NCCL with one rank per card."""
    from tame_torch.parallel import comm as pcomm
    from tame_torch.parallel.distributed import spawn_world

    Y, params, init = north_star_inputs()
    one, c = drive("n=2000 one-rank NCCL mesh (and the plain fit)",
                   timed_phase, "n=2000 one-rank NCCL mesh", phase_one_rank,
                   Y, params, init)
    n = one["n_iter"]
    require(c["spd_solve_inv"] == 2 * 16 * n and c["logdet_spd"] == 2 * n
            and c["fused_fit"] == 0, f"the plain and one-rank fits did not "
            f"launch 16 K1 and 1 K2 per iteration each, K3 never: {c}")
    refs, _ = drive("references for the sharded worlds", timed_phase,
                    "references", phase_references, one, Y, params, init)
    refs["masked"], c = drive(
        "n=2000 one-rank NCCL mesh, masked (and the plain fits)",
        timed_phase, "n=2000 one-rank NCCL mesh, masked",
        phase_one_rank_masked, one, Y, params, init)
    refs["masked smoothed"] = refs["masked"].pop("masked smoothed")
    small, c = drive("references for the smaller sharded legs", timed_phase,
                     "references, seq and families", phase_small_references)
    refs.update(small)
    require(c["spd_solve_inv"] == 15 * 10 * refs["seq_stop"][0]
            + 2 * FAMILY_ITERS, f"the seq and family references did not "
            f"launch K1 n T times per seq iteration and once per family "
            f"iteration: {c}")
    refs["em legs"], c = drive(
        "n=2000 one-rank NCCL mesh, warm init and EM; n=1000 smoothed "
        "Bernoulli (and the plain ones)", timed_phase,
        "n=2000 one-rank NCCL mesh, warm init / EM / smoothed Bernoulli",
        phase_one_rank_em, one, Y, params)
    del one, Y
    torch.cuda.empty_cache()
    worlds = [] if nccl_leg else [("two gloo ranks sharing the card", 2,
                                   "gloo")]
    cards = torch.cuda.device_count()
    procs = 4 if cards >= 4 else 2
    if cards >= 2:
        worlds.append(("NCCL, one rank per card", procs, "nccl"))
    else:
        require(not nccl_leg, "--nccl-leg needs 2 cards or more")
        print(f"NCCL with one rank per card: not run, this machine has "
              f"{cards} card(s)", flush=True)
    for label, nprocs, backend in worlds:
        t0 = time.perf_counter()
        ranks = spawn_world(sharded_rank, nprocs, (backend, refs),
                            backend=backend, timeout_s=900.0)
        print(f"phase {label}: {time.perf_counter() - t0:.2f} s wall on "
              f"{CARD}", flush=True)
        check_sharded_world(label, ranks, n)
        counts = rank_launches(ranks)
        counts.setdefault("masked_contract", 0)
        counts.setdefault("eta_contract", 0)
        print(f"launches, {label} (all ranks): {counts}", flush=True)
        paths.append(counts)
    if nccl_leg:
        # one after the other: scaling_eval times the NCCL world
        scripts = [("multihost_proof", ("--backend", "nccl", "--procs",
                                        str(procs))),
                   ("scaling_eval", ("--backend", "nccl", "--procs",
                                     str(procs)))]
        for name, argv in scripts:
            module = f"tame_torch.scripts.{name}"
            line, _ = drive(module, timed_phase, module, run_script, module,
                            *argv)
            PARALLEL[name] = json.loads(line)
            print(f"{module}: {line}", flush=True)
    else:
        # the probe and the proof time nothing: both worlds at once
        names = ("multihost_probe", "multihost_proof")
        label = "tame_torch.scripts.multihost_probe and multihost_proof"
        lines, _ = drive(label, timed_phase, label, run_scripts,
                         [(f"tame_torch.scripts.{name}", ("--backend",
                                                          "gloo"))
                          for name in names])
        for name, line in zip(names, lines):
            PARALLEL[name] = json.loads(line)
            print(f"tame_torch.scripts.{name}: {line}", flush=True)
    pcomm.destroy()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--nccl-leg", action="store_true",
        help="on a machine with 2 cards or more: build, then run phase 39 "
             "and the NCCL world of one rank per card (phase 41) alone, "
             "with multihost_proof and scaling_eval over NCCL")
    args = parser.parse_args(argv)
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
    global CARD
    CARD = smi.stdout.strip()
    print("card (nvidia-smi name, power.limit):")
    print(CARD)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")

    start = t0 = time.perf_counter()

    def wall(label, t0):
        """Each phase's wall time and the script's so far, host clock."""
        now = time.perf_counter()
        print(f"wall, {label}: {now - t0:.2f} s, {now - start:.1f} s since "
              f"the start", flush=True)

    _ext.load()
    print(f"build: {time.perf_counter() - t0:.1f} s (build/tame_torch)")
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
        t0 = time.perf_counter()
        out = path(*args)
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"launches, {label}: {counts}")
        wall(label, t0)
        paths.append(counts)
        return out, counts

    if args.nccl_leg:
        parallel_paths(drive, paths, nccl_leg=True)
        print(json.dumps({"parallel": PARALLEL}))
        return 0

    report = {name: {} for name in KERNELS}
    for phase in (phase_kernels, phase_fused_fit, phase_smoother_kernel,
                  phase_contract_kernels, phase_eta_kernel):
        t0 = time.perf_counter()
        phase(report)
        wall(phase.__name__, t0)

    _, demo = drive("demo", phase_demo)
    good_iter, good = drive("n=2000 Good SMF", phase_real_size)
    n_iter, smoothed = drive("n=2000 smoothed", phase_smoothed)
    _, em = drive("n=2000 EM", phase_em)
    require(demo["fused_fit"] >= 3, "demo drive did not run K3")
    require(good["fused_fit"] == 0, "the n=2000 fit ran K3")
    require(good["spd_solve_inv"] > 0 and good["logdet_spd"] > 0,
            "the n=2000 fit did not run K1 and K2")
    # W0 @ V and W1 @ U of each block's stripe of the time-major weights
    require(good["eta_contract"] == 32 * good_iter
            and smoothed["eta_contract"] == 32 * n_iter,
            "the n=2000 fits did not launch K7 twice per block phase")
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
        # two stripes per block phase and the diagnostics' W0 @ [V | U]
        require(counts["eta_contract"] == 33 * res["n_iter"],
                f"the {label} fit launched K7 {counts['eta_contract']} "
                f"times, not 33 per iteration")
        if fit_mask is not None:
            require(res["mse_held"] < 2.0 * res["mse_obs"] + 0.05,
                    f"the {label} fit does not recover the held-out dyads")
    # ms/iteration in turns (dense, einsum, K5, K5, einsum, dense),
    # 40 iterations each, for the spread of one configuration's runs
    turns = {label: [] for label, _, _ in configs}
    for label, fit_mask, packed in configs + configs[::-1]:
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

    from tame_torch.io import native

    require(native.available(), "the native checkpoint store did not build")
    seq = {}
    for name in ("naive", "good", "bad"):
        seq[name], counts = drive(f"seq {name} (demo shape)", phase_seq, name)
        n_iter = seq[name][0]
        require(counts["spd_solve_inv"] == 15 * 10 * n_iter
                and counts["logdet_spd"] == n_iter
                and counts["fused_fit"] == 0,
                f"seq {name} did not launch K1 n T times and K2 once per "
                f"iteration: {counts}")
    (_, naive, _), (_, good, _), (_, bad, bad_div) = (seq["naive"],
                                                      seq["good"], seq["bad"])
    require(naive < 0.5 and good < 0.5 and abs(naive - good) < 0.05,
            f"seq: Naive and Good did not reach a low, equal MSE: {seq}")
    require(bad_div or (bad > 1.0 and bad > 3.0 * good),
            f"seq: Bad SMF did not diverge or stay worse: {seq}")
    print(f"seq ms/iteration on the card: {SEQ_MS}")

    _, ck3 = drive("checkpointed demo (K3)", phase_ckpt_k3)
    # the two one-shot fits' 1 each, the killed fit's 2 segments and the
    # resumed fit's 2
    require(ck3["fused_fit"] == 2 + 4 and ck3["spd_solve_inv"] == 0,
            f"the checkpointed demo fit did not run one K3 launch per "
            f"segment: {ck3}")
    model = north_star_model()
    vi, ckun = drive("checkpointed n=2000 Good SMF", phase_ckpt_unfused,
                     model)
    # two one-shot fits of 30, the killed 20, the resumed 10
    require(ckun["spd_solve_inv"] == 16 * 90 and ckun["logdet_spd"] == 90
            and ckun["fused_fit"] == 0, f"the checkpointed n=2000 fit did "
            f"not run 16 K1 and 1 K2 launches per iteration: {ckun}")
    drive("forecast n=2000 H=5", phase_forecast, vi)
    del vi
    _, cksm = drive("checkpointed n=2000 smoothed", phase_ckpt_smoothed,
                    model)
    # two one-shot fits of 12, the killed 8, the resumed 4
    require(cksm["fused_smoother"] == 16 * 36, f"the checkpointed smoothed "
            f"fit did not launch K4 16 times per iteration: {cksm}")
    del model

    # the non-Gaussian families: K1 and K2 once per mean-field iteration,
    # K4 once per smoothed-family and inner EM iteration
    def mean_field_counts(label, c, n_iter):
        require(c["spd_solve_inv"] == n_iter and c["logdet_spd"] == n_iter
                and c["fused_fit"] == 0 and c["fused_smoother"] == 0,
                f"{label} did not launch K1 and K2 once per iteration "
                f"({n_iter}) and K3, K4 never: {c}")

    for family in ("bernoulli", "poisson"):
        n_iter, c = drive(f"n=1000 {family}", phase_family_full_size,
                          family)
        mean_field_counts(f"the n=1000 {family} fit", c, n_iter)
    for family in ("bernoulli", "poisson"):
        n_iter, c = drive(f"n=2000 {family}", phase_family_north_star,
                          family)
        mean_field_counts(f"the n=2000 {family} fit", c, n_iter)
    for kind in CARD_VS_CPU:
        n_iter, c = drive(f"card vs CPU {kind}", phase_card_vs_cpu, kind)
        if kind.startswith("smoothed"):
            require(c["fused_smoother"] == n_iter and c["spd_solve_inv"] == 0
                    and c["logdet_spd"] == 0, f"the {kind} fits on the card "
                    f"did not launch K4 once per iteration ({n_iter}): {c}")
        else:
            mean_field_counts(f"the {kind} fits on the card", c, n_iter)
    n_inner, c = drive("binary EM n=1000", phase_binary_em)
    require(c["fused_smoother"] == n_inner and c["spd_solve_inv"] == 0,
            f"the binary EM did not launch K4 once per inner iteration "
            f"({n_inner}): {c}")
    _, c = drive("checkpointed n=1000 Poisson", phase_ckpt_poisson)
    # two one-shot fits of 12, the killed 8, the resumed 4
    mean_field_counts("the checkpointed Poisson fits", c, 36)
    karate, c = drive("karate masked Poisson", phase_karate)
    mean_field_counts("the karate fit on the card", c,
                      karate["iterations"][0])
    print(f"non-Gaussian paths: {json.dumps(FAMILY)}")

    sampler_paths(drive)
    host_layer_paths(drive)
    parallel_paths(drive, paths)

    import shutil

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    k4 = report["fused_smoother"]
    print(f"seq ms/iteration {SEQ_MS}; n=2000 checkpoint {CKPT}")
    print(f"K4 n=125 d=10 {k4['ms']} ms, n=125 d=14 {k4['ms_d14']} ms, "
          f"n=2000 d=10 {k4['ms_n2000']} ms; same run: {K4_PATHS}")
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
