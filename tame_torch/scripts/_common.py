"""What the measurement scripts share: the device flag, the north-star
data, host-clock timing that waits for the card, and the slope of a fit's
wall time over its iterations."""

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
