"""K1 (``spd_solve_inv``) and K2 (``logdet_spd``) timed beside their twins,
the library calls for the same functions and their bounds.

    python3 tame_torch/scripts/spd_probe.py [--root TREE --tag TAG]
        [--res-usage] [--fits] [--out FILE]

At every (d, B) of ``--dims`` x ``--batches`` (default d = 6, 10, 14, 34,
48 and B = 6,250, one block phase of the n=2000 fit; 12,500, one of
``bench``'s 8; 100,000, a Jacobi sweep) it times with CUDA events (median
of ``--repeats``) K1 with the inverse and without it (device time: 20
launches replayed from one CUDA graph; ``call_ms`` is one wrapper call
between two events, host time to the launch included), the twin,
``torch.linalg.solve(P, eta)`` (the mu-only function) and
``torch.linalg.inv_ex(P)`` (the inverse alone); at every d of
``--k2-dims`` (default 10, 14) and B = 100,000 (the entropy of the n=2000
fit) K2, its twin and ``torch.logdet``.  Beside each kernel it prints the
bound, the larger of the bytes over 3.35 TB/s and the operations over 67
TFLOP/s (an H100 SXM's float32 rate on the CUDA cores), from the shapes.
The systems are ``chip_smoke.py``'s, A A' / d + I.

``--bits-out FILE`` saves K1's and K2's outputs at a few shapes from fixed
inputs, and ``--bits-against FILE`` compares this tree's with them, bit for
bit (another tree's, saved by a run with ``--root``).  ``--res-usage``
compiles ``csrc/spd.cu`` of the tree alone with ``nvcc
-Xptxas -v`` and prints each kernel's registers and spills.  ``--fits``
times the two r = 6 paths of ``chip_smoke.py`` (n=2000, T=50, 16 blocks,
20 iterations from one warm-up fit of 2): the Good-SMF fit, 16 K1 and 1
K2 launches an iteration, and the smoothed fit, which runs neither (its
K4 launches are the control).

``--root`` imports ``tame_torch`` from another tree, such as a ``git
archive`` of an earlier commit (run the file by its path then, not with
``-m``), so two trees' kernels can be timed in turns in one call; the
probe uses only the calls the port has had since K1 was written.  On
``--device cpu`` there is no kernel and no library yardstick: the twins
are timed on the host clock.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
from typing import Optional, Sequence

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12           # the same, float32 on the CUDA cores


def spd_work(d: int, B: int, kind: str) -> tuple[float, float]:
    """(bytes each input read and output written once, operations with
    multiply-adds counted twice) of ``kind``: "inv" (K1 with the inverse),
    "mu" (K1 without it) or "logdet" (K2)."""
    f = 4.0
    if kind == "logdet":
        return B * (d * d + 1) * f, 2.0 * B * d**3 / 3
    if kind == "mu":
        return B * (d * d + 2 * d) * f, 2.0 * B * (d**3 / 3 + 2 * d * d)
    return (B * 2 * (d * d + d) * f,
            2.0 * B * (d**3 / 3 + 2 * d**3 + 2 * d * d))


def bound_ms(d: int, B: int, kind: str) -> dict:
    n_bytes, flops = spd_work(d, B, kind)
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return ({"bound_ms": by_bytes, "bound_by": "bytes"} if by_bytes >= by_ops
            else {"bound_ms": by_ops, "bound_by": "operations"})


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

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


def graph_ms(fn, reps: int, launches: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls captured
    in one CUDA graph, its replay timed with CUDA events (median of
    ``reps``), divided by ``launches``.  Unlike events around one call,
    this leaves out the host's time to reach the launch, which is longer
    than a small kernel."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _cuda_ms(graph.replay, reps) / launches


def _host_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def spd_batch(B: int, d: int, device, seed: int):
    """``chip_smoke.spd_batch``: P = A A' / d + I and eta ~ N(0, 1)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn(B, d, d, device=device, generator=g)
    P = A @ A.transpose(-1, -2) / d + torch.eye(d, device=device)
    return P, torch.randn(B, d, device=device, generator=g)


def time_k1(d: int, B: int, device, repeats: int) -> dict:
    import torch

    from tame_torch.ops import cholesky as ch

    P, eta = spd_batch(B, d, device, d)
    out = {"d": d, "B": B}
    if device.type != "cuda":
        out["twin_host_ms"] = _host_ms(lambda: ch.spd_solve_inv_twin(P, eta),
                                       repeats)
        return out
    out.update(
        ms=graph_ms(lambda: ch.spd_solve_inv_kernel(P, eta), repeats),
        ms_mu_only=graph_ms(lambda: ch.spd_solve_inv_kernel(
            P, eta, with_inverse=False), repeats),
        call_ms=_cuda_ms(lambda: ch.spd_solve_inv_kernel(P, eta), repeats),
        twin_ms=_cuda_ms(lambda: ch.spd_solve_inv_twin(P, eta), repeats),
        solve_ms=_cuda_ms(lambda: torch.linalg.solve(P, eta), repeats),
        inv_ex_ms=_cuda_ms(lambda: torch.linalg.inv_ex(P), repeats),
        bound=bound_ms(d, B, "inv"), bound_mu_only=bound_ms(d, B, "mu"))
    return out


def time_k2(d: int, B: int, device, repeats: int) -> dict:
    import torch

    from tame_torch.ops import cholesky as ch

    P, _ = spd_batch(B, d, device, 100 + d)
    out = {"d": d, "B": B}
    if device.type != "cuda":
        out["twin_host_ms"] = _host_ms(lambda: ch.logdet_spd_twin(P),
                                       repeats)
        return out
    out.update(ms=graph_ms(lambda: ch.logdet_spd_kernel(P), repeats),
               call_ms=_cuda_ms(lambda: ch.logdet_spd_kernel(P), repeats),
               twin_ms=_cuda_ms(lambda: ch.logdet_spd_twin(P), repeats),
               logdet_ms=_cuda_ms(lambda: torch.logdet(P), repeats),
               bound=bound_ms(d, B, "logdet"))
    return out


# (d, B) of the outputs saved by --bits-out and compared by --bits-against
BITS_SHAPES = ((6, 1001), (10, 6250), (14, 6250), (34, 1003), (48, 1001))


def kernel_outputs(device) -> dict:
    """K1 (mu, P^-1, mu without the inverse) and K2 at BITS_SHAPES, on the
    CPU, from inputs made on the card from fixed seeds."""
    from tame_torch.ops import cholesky as ch

    out = {}
    for d, B in BITS_SHAPES:
        P, eta = spd_batch(B, d, device, 1000 + d)
        mu, cov = ch.spd_solve_inv_kernel(P, eta)
        out[f"d={d} B={B}"] = {
            "mu": mu.cpu(), "cov": cov.cpu(),
            "mu_only": ch.spd_solve_inv_kernel(P, eta,
                                               with_inverse=False).cpu(),
            "logdet": ch.logdet_spd_kernel(P).cpu()}
    return out


def compare_bits(mine: dict, theirs: dict) -> dict:
    """Per shape and output: equal bit for bit, else the largest absolute
    difference."""
    import torch

    return {shape: {name: (True if torch.equal(t, theirs[shape][name])
                           else (t - theirs[shape][name]).abs().max().item())
                    for name, t in outs.items()}
            for shape, outs in mine.items()}


def res_usage(root: pathlib.Path, source: str = "spd.cu") -> list[dict]:
    """Registers, stack and spills of each kernel of ``root``'s
    ``csrc/<source>``, from ``nvcc -Xptxas -v`` on that file alone."""
    from tame_torch.ops import _ext

    csrc = root / "tame_torch" / "csrc"
    stem = pathlib.Path(source).stem
    out_dir = root / "build" / f"{stem}_res_usage"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run(
        [nvcc, *_ext.CUDA_FLAGS, "-Xptxas", "-v", "-I", str(csrc), "-c",
         str(csrc / source), "-o", str(out_dir / f"{stem}.o")],
        capture_output=True, text=True, check=True)
    demangle = shutil.which("c++filt")
    rows, name = [], None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            if demangle:
                name = subprocess.run([demangle, name], capture_output=True,
                                      text=True).stdout.strip() or name
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.append({"kernel": name, "stack": int(m.group(1)),
                         "spill_stores": int(m.group(2)),
                         "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == name:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def time_fits(device, iters: int, n: int = 2000, T: int = 50) -> dict:
    """ms/iteration of ``chip_smoke.py``'s two r = 6 paths (host clock
    around each fit, waiting for the card)."""
    import torch

    from tame_torch import (TemporalAMEModel, TemporalAMESmoothedVI,
                            TemporalAMEStructuredMFVI)
    from tame_torch.ops import cholesky as ch
    from tame_torch.scripts import _common

    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=6, seed=0,
                             device=device)
    model.generate_data(
        generator=torch.Generator(device=device).manual_seed(6))
    res = {}
    for label, make in [
            ("r6_good_smf", lambda: TemporalAMEStructuredMFVI(
                model, factorization="good", learning_rate=0.8)),
            ("r6_smoothed", lambda: TemporalAMESmoothedVI(
                model, init_mode="warm", learning_rate=0.8))]:
        make().fit(max_iter=2, tolerance=0.0, verbose=False)
        k1 = ch.spd_solve_inv_kernel.launches
        h, s = _common.timed(lambda: make().fit(
            max_iter=iters, tolerance=0.0, verbose=False), device)
        _common.require(len(h["elbo"]) == iters, f"{label} stopped early")
        res[label] = {"ms_per_iter": s * 1e3 / iters,
                      "k1_launches": ch.spd_solve_inv_kernel.launches - k1,
                      "final_elbo": h["elbo"][-1]}
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=None,
                        help="tree to import tame_torch from (default: this "
                             "file's)")
    parser.add_argument("--tag", default="", help="label for the output")
    parser.add_argument("--dims", type=int, nargs="+",
                        default=[6, 10, 14, 34, 48])
    parser.add_argument("--batches", type=int, nargs="+",
                        default=[6250, 12500, 100000])
    parser.add_argument("--k2-dims", type=int, nargs="+", default=[10, 14])
    parser.add_argument("--k2-batch", type=int, default=100000)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--res-usage", action="store_true")
    parser.add_argument("--fits", action="store_true")
    parser.add_argument("--fit-iters", type=int, default=20)
    parser.add_argument("--fit-n", type=int, default=2000)
    parser.add_argument("--fit-T", type=int, default=50)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    parser.add_argument("--bits-out", default=None,
                        help="save K1/K2's outputs at BITS_SHAPES here")
    parser.add_argument("--bits-against", default=None,
                        help="compare K1/K2's outputs with those saved here")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    root = pathlib.Path(args.root or pathlib.Path(__file__).parents[2])
    root = root.resolve()
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))

    import tame_torch
    from tame_torch.ops import _ext
    from tame_torch.scripts import _common

    _common.require(pathlib.Path(tame_torch.__file__).resolve().parents[1]
                    == root, f"tame_torch was imported from "
                    f"{tame_torch.__file__}, not from {root}")
    device = _common.resolve_device(args.device)
    res = {"tag": args.tag, "root": str(root),
           "device": _common.describe(device), "k1": [], "k2": []}
    print(res["device"], flush=True)
    if device.type == "cuda":
        t0 = time.perf_counter()
        _ext.load()
        res["build_s"] = time.perf_counter() - t0
    for d in args.dims:
        for B in args.batches:
            row = time_k1(d, B, device, args.repeats)
            res["k1"].append(row)
            print(f"{args.tag} K1 {json.dumps(row)}", flush=True)
    for d in args.k2_dims:
        row = time_k2(d, args.k2_batch, device, args.repeats)
        res["k2"].append(row)
        print(f"{args.tag} K2 {json.dumps(row)}", flush=True)
    if device.type == "cuda" and (args.bits_out or args.bits_against):
        import torch

        outs = kernel_outputs(device)
        if args.bits_out:
            torch.save(outs, args.bits_out)
        if args.bits_against:
            res["bits"] = compare_bits(outs, torch.load(args.bits_against))
            print(f"{args.tag} bits against {args.bits_against}: "
                  f"{json.dumps(res['bits'])}", flush=True)
    if device.type == "cuda" and args.res_usage:
        res["res_usage"] = res_usage(root)
        for row in res["res_usage"]:
            print(f"{args.tag} {json.dumps(row)}", flush=True)
    if args.fits:
        res["fits"] = time_fits(device, args.fit_iters, args.fit_n,
                                args.fit_T)
        print(f"{args.tag} fits {json.dumps(res['fits'])}", flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res) + "\n")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
