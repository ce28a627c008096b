"""NUTS at a production sampler scale: n=128, T=16, r=2, 64 chains (port of
``scripts/mcmc_bench.py``).

    python -m tame_torch.scripts.mcmc_bench [--n 128 --T 16 --r 2
        --chains 64 --warmup 200 --samples 1000 --out f.json]

Runs CAVI-preconditioned NUTS with all chains as one batch on the card
and prints one JSON object with:

* the sampling wall clock and ESS/s (per-coordinate effective sample
  sizes of identified dyad-mean scalars, the Vehtari et al. estimator);
* split-R-hat of those scalars and of the per-draw log density;
* the SMF-vs-NUTS posterior moment gap in dyad-mean space (the identified
  quantity), as an effect size against the posterior sd and as a z-score
  against the ESS-scaled Monte-Carlo standard error, and the same for the
  smoothed family's fit;
* the host readbacks and batched leapfrog steps per NUTS transition,
  one batched gradient's time alone (CUDA events) and its kernels and
  device time (``torch.profiler``), the same gradient replayed as a CUDA
  graph, and the run's time per gradient evaluation (the rest is the
  per-leaf bookkeeping and the readbacks).

The JAX script splits the chains into dispatches of 8 and times a second
sweep after a compiling one; here there is no compilation, so one sweep
of every chain is timed (kernels are built before the clock starts).  The
chains' gradients replay one captured CUDA graph
(:class:`tame_torch.inference.hmc.GraphedLogDensity`), the counterpart of
the JAX script's compiled step.  It writes a file only under ``--out``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from tame_torch.scripts import _common


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.size_flags(ap, n=128, T=16, r=2)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--samples", type=int, default=1000,
                    help=">= 1000 draws per chain lets the ESS estimator "
                         "resolve autocorrelation below the total-draw "
                         "ceiling")
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--k-scalars", type=int, default=64,
                    help="dyad-mean coordinates tracked for R-hat/ESS")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this path")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = _common.resolve_device(args.device)
    print(_common.describe(device), flush=True)

    from tame_torch.inference import cavi
    from tame_torch.inference.hmc import (
        GraphedLogDensity,
        precondition_from_cavi,
        value_and_grad,
    )
    from tame_torch.inference.logprob import make_logdensity_fn
    from tame_torch.inference.nuts import nuts_kernel, run_nuts
    from tame_torch.inference.smoothed import (
        fit_cavi_smoothed,
        warm_init_smoothed_state,
    )
    from tame_torch.ops import dyad as dyad_ops
    from tame_torch.utils.diagnostics import effective_sample_size, split_rhat
    from tame_torch.utils.profiling import benchmark

    n, T, r, C = args.n, args.T, args.r, args.chains
    cfg, params, Y = _common.north_star(device, n, T, r, seed=args.seed)
    print(f"data ready: n={n} T={T} r={r} d={cfg.d} "
          f"({n * T * cfg.d} latent dims/chain, {C} chains)", flush=True)

    # -- SMF reference fit, corrected=True (the exact coordinate update), so
    # the moment comparison is SMF against NUTS on the same posterior
    init = cavi.init_state(torch.Generator().manual_seed(args.seed + 1), n,
                           T, cfg.d, "full", 0.1, 0.5, device=device)
    fit = cavi.fit_cavi(Y, params, init, structure="full",
                        update_mode="block", max_iter=512,
                        corrected=True, learning_rate=0.8, tolerance=1e-5)
    print(f"SMF fit: {fit.n_iter} iters, converged={fit.converged}",
          flush=True)
    # -- the corrected smoothed fit: the joint-trajectory family, same
    # posterior target; its gap isolates the per-(node, time) factorization
    sfit = fit_cavi_smoothed(Y, params, warm_init_smoothed_state(Y, params),
                             max_iter=512, learning_rate=0.8,
                             tolerance=1e-5, corrected=True)
    print(f"smoothed fit: {sfit.n_iter} iters, converged={sfit.converged}",
          flush=True)

    # -- CAVI preconditioning and chain starts -----------------------------
    center, inv_mass = precondition_from_cavi(Y, params, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    inits = center[None] + 0.01 * torch.randn((C,) + center.shape,
                                              generator=gen, device=device)
    logdensity = make_logdensity_fn(params, Y)

    # identified scalars: K random off-diagonal (i, j, t) coordinates
    rng = np.random.default_rng(args.seed)
    ii = rng.integers(0, n, size=4 * args.k_scalars)
    jj = rng.integers(0, n, size=4 * args.k_scalars)
    ok = ii != jj
    ii, jj = ii[ok][:args.k_scalars], jj[ok][:args.k_scalars]
    tt = rng.integers(0, T, size=len(ii))
    ii, jj, tt = (torch.as_tensor(v, device=device) for v in (ii, jj, tt))

    def scalars(X):
        """mu_ij = a_i + b_j + U_i . V_j at the tracked coordinates, for
        X (..., n, T, d)."""
        a, b, U, V = dyad_ops.split_state(X, r)
        return (a[..., ii, tt] + b[..., jj, tt]
                + torch.sum(U[..., ii, tt, :] * V[..., jj, tt, :], -1))

    grad = benchmark(value_and_grad, logdensity, inits, warmup=2, repeats=10,
                     on_card=device.type == "cuda")
    grad_ms = grad["median_s"] * 1e3
    prof = _common._profile(lambda: value_and_grad(logdensity, inits), device)
    print(f"one gradient of all {C} chains: {grad_ms:.3f} ms "
          f"({grad['clock']}, median of 10); under the profiler "
          f"{prof['kernels']} kernels, {prof['device_ms']:.3f} ms of device "
          f"time", flush=True)
    target = GraphedLogDensity(logdensity)
    ggrad = benchmark(value_and_grad, target, inits, warmup=2, repeats=10,
                      on_card=device.type == "cuda")
    ref, got = value_and_grad(logdensity, inits), value_and_grad(target,
                                                                 inits)
    graph_diff = max(float((b - a).abs().max() / a.abs().max())
                     for a, b in zip(ref, got))
    print(f"one gradient replayed as a CUDA graph: "
          f"{ggrad['median_s'] * 1e3:.3f} ms; max |graph - eager| / "
          f"max |eager| {graph_diff}", flush=True)
    syncs0, trans0 = nuts_kernel.syncs, nuts_kernel.transitions
    steps0 = nuts_kernel.steps
    print(f"sampling ({C} chains in one batch, warmup {args.warmup}, "
          f"{args.samples} draws, max depth {args.max_depth}) ...",
          flush=True)
    out, wall = _common.timed(lambda: run_nuts(
        target, inits, gen, num_warmup=args.warmup,
        num_samples=args.samples, max_depth=args.max_depth,
        inv_mass=inv_mass), device)
    syncs = nuts_kernel.syncs - syncs0
    transitions = nuts_kernel.transitions - trans0
    steps = nuts_kernel.steps - steps0
    scal = scalars(out.positions).cpu()              # (C, S, K)
    logp = out.logdensities.cpu()
    print(f"wall (warmup + sample): {wall:.1f} s; per transition "
          f"{steps / transitions:.2f} batched leapfrog steps and "
          f"{syncs / transitions:.2f} host readbacks; "
          f"{wall / (steps + transitions) * 1e3:.3f} ms per gradient "
          f"evaluation", flush=True)

    # -- diagnostics (host) ------------------------------------------------
    ess = effective_sample_size(scal).numpy()
    rhat = split_rhat(scal).numpy()
    rhat_logp = float(split_rhat(logp))
    ess_per_s = ess / wall

    # -- SMF vs NUTS moment gap in the identified dyad-mean space ----------
    mu_vi = scalars(fit.X_mean).cpu().numpy()
    mu_sm = scalars(sfit.state.X_mean).cpu().numpy()
    flat = scal.reshape(-1, scal.shape[-1]).numpy()
    mu_nuts, sd_nuts = flat.mean(0), flat.std(0)
    mcse = sd_nuts / np.sqrt(np.maximum(ess, 1.0))
    gap, gap_sm = mu_vi - mu_nuts, mu_sm - mu_nuts
    effect = np.abs(gap) / np.maximum(sd_nuts, 1e-8)
    effect_sm = np.abs(gap_sm) / np.maximum(sd_nuts, 1e-8)
    z = np.abs(gap) / np.maximum(mcse, 1e-12)
    z_sm = np.abs(gap_sm) / np.maximum(mcse, 1e-12)

    result = {
        "config": {"n": n, "T": T, "r": r, "d": cfg.d, "chains": C,
                   "warmup": args.warmup, "samples": args.samples,
                   "max_depth": args.max_depth, "k_scalars": int(len(ii)),
                   "seed": args.seed, "device": _common.describe(device)},
        "wall_s": wall,
        "accept_mean": float(out.accept_prob.mean()),
        "step_size_median": float(out.step_size.median()),
        "total_draws": int(C * args.samples),
        "transitions": transitions,
        "syncs_per_transition": syncs / transitions,
        "steps_per_transition": steps / transitions,
        "grad_ms": grad_ms,
        "grad_kernels": prof["kernels"],
        "grad_device_ms": prof["device_ms"],
        "graph_grad_ms": ggrad["median_s"] * 1e3,
        "graph_rel_diff": graph_diff,
        "ms_per_gradient_in_run": wall / (steps + transitions) * 1e3,
        "split_rhat_max": float(rhat.max()),
        "split_rhat_median": float(np.median(rhat)),
        "logdensity_rhat": rhat_logp,
        "ess_min": float(ess.min()),
        "ess_median": float(np.median(ess)),
        "ess_per_s_min": float(ess_per_s.min()),
        "ess_per_s_median": float(np.median(ess_per_s)),
        "smf_iters": fit.n_iter,
        "smoothed_iters": sfit.n_iter,
        "smf_gap_rms": float(np.sqrt((gap ** 2).mean())),
        "smf_gap_max_abs": float(np.abs(gap).max()),
        "smf_effect_size_median": float(np.median(effect)),
        "smf_effect_size_max": float(effect.max()),
        "smf_z_median": float(np.median(z)),
        "smoothed_gap_rms": float(np.sqrt((gap_sm ** 2).mean())),
        "smoothed_effect_size_median": float(np.median(effect_sm)),
        "smoothed_effect_size_max": float(effect_sm.max()),
        "smoothed_z_median": float(np.median(z_sm)),
        "posterior_sd_median": float(np.median(sd_nuts)),
    }
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text, flush=True)
    ok = result["split_rhat_max"] < 1.05 and rhat_logp < 1.1
    print("MIXING OK" if ok else "MIXING MARGINAL — inspect R-hats",
          flush=True)
    return result


if __name__ == "__main__":
    main()
