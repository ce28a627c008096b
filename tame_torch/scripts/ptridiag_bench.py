"""The time-parallel smoother against the sequential one as T grows (port
of ``scripts/ptridiag_bench.py``).

    python -m tame_torch.scripts.ptridiag_bench [--sizes 2000x50,16x4096]

The same d = 10 systems (phi 0.8) and (n, T) splits as the JAX script,
from (2000, 50) to (16, 4096).  The JAX script times its ``vmap``-ed scan
against the associative-scan smoother; on the card the port's sequential
smoother is K4 (:func:`tame_torch.ops.fused_smoother.fused_smoother`), so
this times K4 against
:func:`tame_torch.ops.ptridiag.parallel_block_tridiag_smoother`
(CUDA-event medians) and prints the max |Δmean| at every size.  On
``--device cpu`` the sequential column is K4's plain twin and the times
are host-clock times.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from tame_torch.ops.fused_smoother import fused_smoother
from tame_torch.ops.ptridiag import parallel_block_tridiag_smoother
from tame_torch.scripts import _common
from tame_torch.utils.profiling import benchmark

SIZES = "2000x50,512x128,256x256,128x512,64x1024,16x4096"
D, PHI, REPEATS = 10, 0.8, 5
MEAN_ATOL = 5e-4  # tame's parallel-vs-sequential test bound


def systems(n: int, T: int, device, seed: int):
    """The JAX script's systems for n trajectories: Pobs = A A' + 2 I with
    A ~ 0.3 N(0, 1), eta ~ N(0, 1), the AR(1) prior (Phi = phi I, Q, Sigma0
    = I), and the sequential system's blocks D and O = -Phi' Q^-1; returns
    (Pobs, eta, D, O, (Phi, Q, Sigma0))."""
    g = torch.Generator(device=device).manual_seed(seed)
    eye = torch.eye(D, device=device)
    A = torch.randn(n, T, D, D, generator=g, device=device) * 0.3
    Pobs = A @ A.transpose(-1, -2) + 2.0 * eye
    eta = torch.randn(n, T, D, generator=g, device=device)
    Phi = PHI * eye
    Q = (1 - PHI ** 2) * 0.1 * (eye + 0.1 * torch.ones(D, D, device=device))
    Q_inv = torch.linalg.inv(Q)
    t = torch.arange(T, device=device)
    Dblk = (Pobs + (t == 0)[:, None, None] * eye
            + (t > 0)[:, None, None] * Q_inv
            + (t < T - 1)[:, None, None] * (Phi.T @ Q_inv @ Phi))
    return Pobs, eta, Dblk, -Phi.T @ Q_inv, (Phi, Q, eye)


def main(argv: Optional[Sequence[str]] = None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", default=SIZES,
                        help="comma-separated n x T splits")
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    on_card = device.type == "cuda"
    print(_common.describe(device), flush=True)
    rows = []
    for size in args.sizes.split(","):
        n, T = (int(v) for v in size.split("x"))
        Pobs, eta, Dblk, O, pri = systems(n, T, device, T)
        seq = benchmark(fused_smoother, Dblk, O, eta, repeats=REPEATS,
                        on_card=on_card)
        par = benchmark(parallel_block_tridiag_smoother, Pobs, eta, *pri,
                        repeats=REPEATS, on_card=on_card)
        ref = fused_smoother(Dblk, O, eta)
        got = parallel_block_tridiag_smoother(Pobs, eta, *pri)
        err = (ref.mean - got.mean).abs().max().item()
        row = dict(n=n, T=T, sequential_ms=seq["median_s"] * 1e3,
                   parallel_ms=par["median_s"] * 1e3, max_abs_dmean=err)
        rows.append(row)
        print(f"n={n:5d} T={T:5d}: {'K4' if on_card else 'twin'} "
              f"{row['sequential_ms']:9.3f} ms | parallel "
              f"{row['parallel_ms']:9.3f} ms | sequential / parallel "
              f"{row['sequential_ms'] / row['parallel_ms']:6.3f} | "
              f"max|dmean| {err:.2e} ({seq['clock']}, median of "
              f"{REPEATS})", flush=True)
        _common.require(err <= MEAN_ATOL, f"the parallel smoother's means "
                        f"are {err} from the sequential ones at n={n}, T={T}")
    return rows


if __name__ == "__main__":
    main()
