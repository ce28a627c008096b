"""The eta contraction's layouts and kernels, each chained so that every
pass depends on the previous output (port of ``scripts/layout_probe3.py``,
which also stands for ``layout_probe.py`` and ``layout_probe2.py``: their
variants are (1) and (2) here, and probe 2 measured nothing, see that
file's docstring).

    python -m tame_torch.scripts.layout_probe3 [--N 2000 --T 50 --R 4 --K 25]

Variants, each run K times in a chain (z <- out / (1 + rms(out))):

1. the (i, j, t) layout's path, the engines' before they stored the
   weights time-major and a dense bf16 mask's still: ``cavi._eta_contract``
   on a plain tensor (a ``bmm`` on a permuted view, so a copy first);
2. ``torch.bmm(..., out_dtype=float32)`` on a contiguous (t, i, j) copy;
3. the streaming ceiling: a float32 row sum of the (t, i, j) weights;
4. K7 (``tame_torch.ops.eta_contract``) on the (t, i, j) weights, the
   engines' path: the (n, T, R) panel in, (n, T, R) out.

Each prints its median ms per pass over ``--repeats`` timed chains (CUDA
events on the card) and GB/s over the N^2 T * 2 bytes of the weights, then
K7's relative error against (2).  On ``--device cpu`` the CPU has no
``bmm(..., out_dtype=)`` and no K7, so (2) and (4) run K7's plain twin and
the script says so.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import torch

from tame_torch.inference import cavi
from tame_torch.ops import eta_contract as ec
from tame_torch.scripts import _common
from tame_torch.utils.profiling import benchmark


def chained(fn: Callable, K: int) -> Callable:
    """``fn`` applied K times; each input is the previous output,
    renormalized by a scalar that depends on every element."""
    def run(W, Z):
        z = Z
        for _ in range(K):
            out = fn(W, z)
            z = out / (1.0 + torch.sqrt(torch.mean(out * out)))
        return z
    return run


def bmm_f32(W: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """One bf16 ``bmm`` with float32 output (the card's overload)."""
    return torch.bmm(W, z.to(torch.bfloat16), out_dtype=torch.float32)


def twin_tjr(W: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """K7's twin on a (T, N, R) panel, (T, N, R) out."""
    return ec.eta_contract_twin(W, z.transpose(0, 1)).transpose(0, 1)


def row_sum(W: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Every weight read once, summed in float32: the streaming ceiling."""
    return W.sum(2, dtype=torch.float32)[..., None] + z * 1e-6


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--N", type=int, default=2000, help="nodes")
    parser.add_argument("--T", type=int, default=50, help="time steps")
    parser.add_argument("--R", type=int, default=4, help="panel width")
    parser.add_argument("--K", type=int, default=25,
                        help="passes per chained run")
    parser.add_argument("--repeats", type=int, default=5,
                        help="timed chained runs per variant (median)")
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    on_card = device.type == "cuda"
    N, T, R, K = args.N, args.T, args.R, args.K
    print(_common.describe(device), flush=True)

    g = torch.Generator(device=device).manual_seed(0)
    W_ijt = torch.randn(N, N, T, device=device, generator=g).to(
        torch.bfloat16)
    W_tij = W_ijt.permute(2, 0, 1).contiguous()
    Z_jtr = torch.randn(N, T, R, device=device, generator=g)
    Z_tjr = Z_jtr.permute(1, 0, 2).contiguous()
    gb = N * N * T * 2 / 1e9

    product = bmm_f32 if on_card else twin_tjr
    variants = [
        ("(1) engine _eta_contract, (i, j, t)", cavi._eta_contract, W_ijt,
         Z_jtr),
        ("(2) bmm out_dtype=f32, (t, i, j)" if on_card
         else "(2) K7 twin on the CPU (no bf16 bmm with f32 out)", product,
         W_tij, Z_tjr),
        ("(3) row-sum ceiling, (t, i, j)", row_sum, W_tij, Z_tjr),
        ("(4) K7 eta_contract, (t, i, j)" if on_card
         else "(4) K7 twin on the CPU (no kernel)", ec.eta_contract, W_tij,
         Z_jtr),
    ]
    before = ec.eta_contract_kernel.launches
    results = {}
    for label, fn, W, Z in variants:
        t = benchmark(chained(fn, K), W, Z, warmup=1, repeats=args.repeats,
                      on_card=on_card)
        ms = t["median_s"] / K * 1e3
        results[label] = {"ms_per_pass": ms, "gb_per_s": gb / ms * 1e3}
        print(f"{label}: {ms} ms/pass ({gb / ms * 1e3} GB/s) [chain of {K}, "
              f"median of {args.repeats}, {t['clock']}]", flush=True)

    ref = product(W_tij, Z_tjr)
    got = ec.eta_contract(W_tij, Z_jtr).transpose(0, 1)
    err = ((ref - got).abs().max() / (ref.abs().max() + 1e-9)).item()
    launches = ec.eta_contract_kernel.launches - before
    print(f"K7 vs (2) rel err: {err}; K7 launches: {launches}", flush=True)
    if on_card:
        _common.require(launches > 0, "the probe did not launch K7")
        _common.require(err <= 1e-4, f"K7 disagrees with bmm: {err}")
    return {"variants": results, "k7_rel_err": err, "k7_launches": launches,
            "shape": {"N": N, "T": T, "R": R, "K": K}}


if __name__ == "__main__":
    main()
