"""K4 (the fused forward-backward smoother) against its plain twin at the
north-star scale, n=2000, T=50, d=10 (port of
``scripts/smoother_bench.py``).

    python -m tame_torch.scripts.smoother_bench [--n 2000 --T 50 --d 10]

Times both on the same systems (CUDA-event medians on the card) and prints
the relative error of mean, cov, cross_cov and logdet (max |twin - K4| /
max |twin|).  On ``--device cpu`` both columns are the twin.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from tame_torch.ops import fused_smoother as fs
from tame_torch.scripts import _common
from tame_torch.utils.profiling import benchmark

REL_TOL = 1e-4  # the same f32 algorithm in another operation order


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=2000, help="trajectories")
    parser.add_argument("--T", type=int, default=50, help="time steps")
    parser.add_argument("--d", type=int, default=10, help="state dimension")
    parser.add_argument("--repeats", type=int, default=5)
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    on_card = device.type == "cuda"
    n, T, d = args.n, args.T, args.d
    print(_common.describe(device), flush=True)

    g = torch.Generator(device=device).manual_seed(0)
    A = torch.randn(n, T, d, d, device=device, generator=g) * 0.3
    D = A @ A.transpose(-1, -2) + 2.0 * torch.eye(d, device=device)
    # coupling scaled so that its norm, and S_t's margin from 0, stay
    # those of d = 10 at any d (the systems stay positive definite)
    O = 0.25 * (10 / d) ** 0.5 * torch.randn(d, d, device=device,
                                             generator=g)
    b = torch.randn(n, T, d, device=device, generator=g)

    out = {}
    for label, fn in (("twin ", fs.fused_smoother_twin),
                      ("K4   " if on_card else "twin (CPU: no K4)",
                       fs.fused_smoother)):
        t = benchmark(fn, D, O, b, repeats=args.repeats, on_card=on_card)
        out[label.strip()] = t["median_s"] * 1e3
        print(f"{label}: {t['median_s'] * 1e3} ms (median of {args.repeats}, "
              f"{t['clock']})", flush=True)
    ref = fs.fused_smoother_twin(D, O, b)
    got = fs.fused_smoother(D, O, b)
    errs = {}
    for name in ("mean", "cov", "cross_cov", "logdet"):
        r, k = getattr(ref, name), getattr(got, name)
        errs[name] = ((r - k).abs().max() / (r.abs().max() + 1e-12)).item()
        print(f"{name}: rel err {errs[name]}", flush=True)
    _common.require(all(e <= REL_TOL for e in errs.values()),
                    f"K4 disagrees with its twin: {errs}")
    return {"ms": out, "rel_err": errs}


if __name__ == "__main__":
    main()
