"""Where the time of the seq sweep and of a checkpoint save goes.

    python3 -m tame_torch.scripts.seq_probe            # on the card
    python -m tame_torch.scripts.seq_probe --device cpu --n 6 --T 3 \\
        --ckpt-n 20 --ckpt-T 5

seq: the reference-order sweep (``fit_cavi(update_mode="seq")``, one K1
launch per (node, time) solve on the card) at the demo shape for each
structure: ms/iteration on the host clock around a synchronised fit of
``--iters`` iterations, then ``torch.profiler`` over another such fit:
kernel launches per iteration, the device time (the sum of the kernels'
own times) per iteration and its share of the unprofiled iteration, and
K1's part.
Where the profiler records no device time the numbers are null.

checkpoint: one save of an (n, T, d) state in the engines' layout, split
into the device-to-host copy, the native store's CRC32 and its write of
each array, beside the whole ``save_checkpoint`` (host clock, median of
``--repeats``).  The files go to ``--out-dir`` and are removed after.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.io import native, save_checkpoint
from tame_torch.models import TemporalAMEModel
from tame_torch.scripts._common import (add_device_flag, describe,
                                        resolve_device, sync)


def _host_ms(fn, device, repeats: int) -> float:
    """Median host-clock milliseconds of ``fn()``, waiting for the card
    before and after each call."""
    times = []
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_profile(prof) -> dict:
    """Kernel count and device time (ms) of a profile, K1's apart."""
    kernels = k1 = 0
    dev_us = k1_us = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += e.count
            dev_us += us
            if "spd_solve_inv" in e.key:
                k1 += e.count
                k1_us += us
    return dict(kernels=kernels, device_ms=dev_us / 1e3, k1=k1,
                k1_device_ms=k1_us / 1e3)


def seq_leg(device, n: int, T: int, r: int, structure: str,
            iters: int) -> dict:
    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=r, seed=42,
                             device="cpu")
    Y = model.generate_data(generator=torch.Generator().manual_seed(42),
                            device=device)
    params = model.params.to(device)
    init = cavi.init_state(torch.Generator().manual_seed(42), n, T,
                           2 + 2 * r, structure, 0.1, 0.5, device=device)

    def fit():
        return cavi.fit_cavi(Y, params, init, structure=structure,
                             update_mode="seq", max_iter=iters,
                             learning_rate=0.7, tolerance=0.0)

    fit()  # warm-up: builds the kernels, picks the library's kernels
    ms = _host_ms(fit, device, 3) / iters
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        fit()
        sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    p = _device_profile(prof)
    seen = p["device_ms"] > 0
    return dict(
        ms_per_iter=ms,
        profiled_ms_per_iter=wall_ms / iters,
        kernels_per_iter=p["kernels"] / iters if seen else None,
        k1_launches_per_iter=p["k1"] / iters if seen else None,
        device_ms_per_iter=p["device_ms"] / iters if seen else None,
        # kernels keep their times under the profiler, the host does not:
        # the share is of the unprofiled iteration
        device_share=p["device_ms"] / iters / ms if seen else None,
        k1_device_ms_per_iter=p["k1_device_ms"] / iters if seen else None)


def ckpt_leg(device, n: int, T: int, r: int, out_dir: Path,
             repeats: int) -> dict:
    d = 2 + 2 * r
    g = torch.Generator(device=device).manual_seed(0)
    X_mean = torch.randn(n, T, d, generator=g, device=device)
    X_cov = torch.randn(n, T, d, d, generator=g, device=device)
    state = {"X_mean": X_mean, "X_cov": X_cov,
             "history": {"elbo": np.zeros(30),
                         "reconstruction_error": np.zeros(30)},
             "structure": "full", "carry_elbo": -1.5, "carry_pat": 0}
    host = {}

    def d2h():
        host["X_mean"] = X_mean.cpu().numpy()
        host["X_cov"] = X_cov.cpu().numpy()

    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        d2h_ms = _host_ms(d2h, device, repeats)
        out = dict(format="tamestore" if native.available() else "npy",
                   d2h_ms=d2h_ms)
        if native.available():
            out["crc32_ms"] = _host_ms(
                lambda: [native.crc32(a) for a in host.values()], device,
                repeats)
            out["write_ms"] = _host_ms(
                lambda: [native.write_tensor(out_dir / f"{k}.tame", a)
                         for k, a in host.items()], device, repeats)
        out["save_ms"] = _host_ms(
            lambda: save_checkpoint(out_dir / "ckpt", state), device,
            repeats)
        out["size_mb"] = sum(f.stat().st_size for f in
                             (out_dir / "ckpt").iterdir()) / 1e6
        return out
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(ap)
    ap.add_argument("--n", type=int, default=15)
    ap.add_argument("--T", type=int, default=10)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10,
                    help="iterations of each timed seq fit")
    ap.add_argument("--ckpt-n", type=int, default=2000)
    ap.add_argument("--ckpt-T", type=int, default=50)
    ap.add_argument("--ckpt-r", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out-dir", default="build/seq_probe_ckpt")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(describe(device))
    res = {"seq": {s: seq_leg(device, args.n, args.T, args.r, s, args.iters)
                   for s in ("diag", "full", "block")},
           "checkpoint": ckpt_leg(device, args.ckpt_n, args.ckpt_T,
                                  args.ckpt_r, Path(args.out_dir),
                                  args.repeats)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
