"""What the measurement scripts share: the device flag, the north-star
data, host-clock timing that waits for the card, the slope of a fit's
wall time over its iterations, a profiler pass split by kernel kind, and
the non-Gaussian probes' body."""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Tuple

import torch

from tame_torch.config import ModelConfig
from tame_torch.models import AMEParams, build_params, sample


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where to run (default: the card; 'cpu' runs each kernel's "
             "plain twin)")


def resolve_device(name: str) -> torch.device:
    """The device to run on; the card must exist unless 'cpu' was asked
    for (a measurement never falls back to the CPU)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False (pass --device cpu to run on the CPU)")
    return torch.device(name)


def describe(device: torch.device) -> str:
    """One line naming what the numbers were measured on: the card's name
    and power limit as nvidia-smi prints them, or the CPU."""
    if device.type != "cuda":
        return f"device: cpu (torch {torch.__version__}; host-clock times)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return (f"device: {torch.cuda.get_device_name(0)} "
            f"({smi.stdout.strip().splitlines()[0]}; torch "
            f"{torch.__version__}, cuda {torch.version.cuda})")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device: torch.device):
    """``(fn(), seconds)`` on the host clock, waiting for the card before
    and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def slope_ms(run: Callable[[int, int], object], short: int, long: int,
             device: torch.device) -> Tuple[object, float]:
    """ms per iteration as (wall(long) - wall(short)) / (long - short),
    which removes what a fit costs once; ``run(seed_offset, iters)`` runs
    one fit.  One untimed ``short`` fit first (the first products choose
    their library kernels).  Returns the long fit's result and the slope."""
    run(0, short)
    _, t_short = timed(lambda: run(1, short), device)
    out, t_long = timed(lambda: run(2, long), device)
    return out, (t_long - t_short) / (long - short) * 1e3


def north_star(device: torch.device, n: int, T: int, r: int, seed: int = 0,
               **cfg) -> Tuple[ModelConfig, AMEParams, torch.Tensor]:
    """Config, parameters on ``device`` and data sampled there from a
    generator seeded ``seed``."""
    config = ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=seed, **cfg)
    params = build_params(config).to(device)
    Y, _ = sample(params, torch.Generator(device=device).manual_seed(seed),
                  n, T)
    return config, params, Y


def size_flags(parser: argparse.ArgumentParser, n: int = 2000, T: int = 50,
               r: int = 4) -> None:
    parser.add_argument("--n", type=int, default=n, help="nodes")
    parser.add_argument("--T", type=int, default=T, help="time steps")
    parser.add_argument("--r", type=int, default=r, help="latent rank")


def kernel_kind(name: str) -> str:
    """The kind of a device kernel by its name, for a profile's split:
    the port's kernels by their names, then library GEMMs, reductions,
    elementwise kernels and copies."""
    n = name.lower()
    for key, kind in (("spd_solve_inv", "K1 spd_solve_inv"),
                      ("logdet", "K2 logdet_spd"),
                      ("fused_smoother", "K4 fused_smoother"),
                      ("gemm", "gemm"), ("bmm", "gemm"), ("cutlass", "gemm"),
                      ("reduce", "reduction"), ("memcpy", "copy"),
                      ("memset", "copy"), ("copy", "copy"),
                      ("elementwise", "elementwise")):
        if key in n:
            return kind
    return "other"


def _profile(fn: Callable[[], object], device: torch.device) -> dict:
    """Kernels and device milliseconds, by kind (:func:`kernel_kind`), of
    one call of ``fn`` under ``torch.profiler``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        sync(device)
    out = {"kernels": 0, "device_ms": 0.0, "by_kind": {}}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        kind = kernel_kind(e.key)
        out["kernels"] += e.count
        out["device_ms"] += ms
        out["by_kind"][kind] = out["by_kind"].get(kind, 0.0) + ms
    return out


def profile_device(run: Callable[[int], object], device: torch.device,
                   short: int, long: int, ms_per_iter: float) -> dict:
    """Device work per iteration of a fit, ``run(iters)``: the kernels and
    device milliseconds (by kind, :func:`kernel_kind`) of a ``long`` fit
    minus those of a ``short`` one, over ``long - short`` (so the fit's
    set-up cancels), and the device's idle share ``1 - device ms /
    ms_per_iter`` against the unprofiled ms/iteration.  None where the
    profiler recorded no device time (on the CPU)."""
    a, b = _profile(lambda: run(short), device), _profile(lambda: run(long),
                                                          device)
    per = long - short
    if b["device_ms"] <= 0:
        return dict(kernels_per_iter=None, device_ms_per_iter=None,
                    device_ms_by_kind=None, idle_share=None)
    device_ms = (b["device_ms"] - a["device_ms"]) / per
    return dict(kernels_per_iter=(b["kernels"] - a["kernels"]) / per,
                device_ms_per_iter=device_ms,
                device_ms_by_kind={k: (v - a["by_kind"].get(k, 0.0)) / per
                                   for k, v in b["by_kind"].items()},
                idle_share=1.0 - device_ms / ms_per_iter)


def predictor_corr(X_true: torch.Tensor, X_est: torch.Tensor,
                   r: int) -> float:
    """Correlation of two states' plug-in predictors ``a_i + b_j + U_i .
    V_j`` over the off-diagonal dyads (in float64 on their device)."""
    from tame_torch.ops import dyad as dyad_ops

    n = X_true.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=X_true.device)
    a = dyad_ops.dyadic_fwd_temporal(X_true, r)[off].double().ravel()
    b = dyad_ops.dyadic_fwd_temporal(X_est.to(X_true.device),
                                     r)[off].double().ravel()
    return float(torch.corrcoef(torch.stack([a, b]))[0, 1])


def family_scale_probe(family: str, argv, lr: float) -> dict:
    """The binary and count probes' shared body: data from the family at
    ``--n``/``--T``/``--r`` (seed 0), fits from random inits of ``--short``
    and ``--long`` iterations at ``lr`` with tolerance 0 (ms/iteration by
    their slope, host clock), the long fit's predictor correlation with
    the generating one, its last accuracy or deviance, and the device work
    of ``--profile-iters`` iterations (:func:`profile_device`)."""
    from tame_torch.inference import (cavi, fit_cavi_bernoulli,
                                      fit_cavi_poisson)

    parser = argparse.ArgumentParser(
        description=f"{family} mean-field engine at scale")
    size_flags(parser, n=1000, T=20, r=2)
    parser.add_argument("--short", type=int, default=8)
    parser.add_argument("--long", type=int, default=40)
    parser.add_argument("--profile-iters", type=int, default=3)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    n, T, r = args.n, args.T, args.r
    print(describe(device), flush=True)
    config = ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=0)
    params = build_params(config).to(device)
    Y, X = sample(params, torch.Generator(device=device).manual_seed(0), n,
                  T, family=family)
    fit_fn = fit_cavi_bernoulli if family == "bernoulli" else fit_cavi_poisson

    def run(i: int, iters: int):
        init = cavi.init_state(torch.Generator().manual_seed(10 + i), n, T,
                               params.d, "full", 0.1, 0.5, device=device)
        return fit_fn(Y, params, init, max_iter=iters, learning_rate=lr,
                      tolerance=0.0)

    run(0, args.short)  # the first products choose their library kernels
    short, t_short = timed(lambda: run(1, args.short), device)
    out, t_long = timed(lambda: run(2, args.long), device)
    # by the iterations run: a diverged Poisson fit stops early
    ms = ((t_long - t_short) / max(out.n_iter - short.n_iter, 1) * 1e3)
    corr = predictor_corr(X, out.X_mean, r)
    res = dict(family=family, n=n, T=T, r=r, ms_per_iter=ms,
               predictor_corr=corr, n_iter=out.n_iter)
    last = out.n_iter - 1
    if family == "bernoulli":
        res["accuracy"] = float(out.accuracy_history[last])
        print(f"binary JJ CAVI n={n} T={T} r={r}: {ms} ms/iteration "
              f"(slope {args.short} -> {args.long}); log-odds correlation "
              f"with the truth {corr}; tie accuracy {res['accuracy']}",
              flush=True)
    else:
        dev = out.deviance_history[:out.n_iter]
        res.update(deviance=float(out.deviance_history[last]),
                   diverged=out.diverged, step_scale=out.step_scale,
                   rejected=int(torch.isnan(dev).sum()))
        print(f"Poisson CVI n={n} T={T} r={r}: {ms} ms/iteration (slope "
              f"{args.short} -> {args.long}); diverged {out.diverged}, "
              f"final step scale {out.step_scale}, {res['rejected']} "
              f"rejected iterations; log-rate correlation with the truth "
              f"{corr}; mean deviance {res['deviance']}", flush=True)
    res["profile"] = profile_device(lambda iters: run(3, iters), device, 2,
                                    2 + args.profile_iters, ms)
    print(f"profile, {args.profile_iters} iterations (a fit of "
          f"{2 + args.profile_iters} minus one of 2): {res['profile']}",
          flush=True)
    return res
