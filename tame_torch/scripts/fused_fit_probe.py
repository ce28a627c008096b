"""K3 (``fused_fit``) timed three ways, and its time split over its stages.

    python3 tame_torch/scripts/fused_fit_probe.py [--root TREE] [--stages]

At two shapes, the 25-iteration 15-block demo fit of ``chip_smoke.py``
(n=15, T=10, r=2, seed 7, lr 0.7, tolerance 0) and ``bench``'s
150-iteration Jacobi fit (phi 0.8, rho 0.5, seed 42), it times with CUDA
events (median of ``--repeats``):

* the bare launch: ``_ext.load().fused_fit(...)`` replayed on the inputs
  the wrapper prepared (its arguments are recorded on a first call);
* the whole ``fused_fit_kernel`` wrapper call, input preparation and
  readback included;

then ``bench``'s demo leg (``--n-fits`` sequential fits, best of
``--repeats``) as wall milliseconds per fit.  ``--stages`` builds a copy of
the extension whose K3 kernel reads ``clock64()`` on thread 0 after every
``__syncthreads()`` of its body, into ``<TREE>/build/k3_stages`` (the
source in the tree is not touched), and prints the cycles between each
barrier and the one before it, summed over the fit, beside the barrier's
line in ``fused_fit.cu``: the time of each stage, the slowest thread's.
``--res-usage`` prints ``cuobjdump``'s registers and memory per K3
instantiation of the built extension.

``--root`` imports ``tame_torch`` from another tree, such as a
``git archive`` of an earlier commit (run the file by its path then, not
with ``-m``), so two kernels can be timed in turns in one call; the probe
uses only the calls the port has had since K3 was written.  On
``--device cpu`` there is no kernel: the wrapper runs the twin, and the
bare launch and stages are skipped.
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

STAGE_SLOTS = 32  # history slots past max_iter that carry the stage cycles


def instrumented_source(src: str) -> tuple[str, list[int]]:
    """``fused_fit.cu`` with a ``clock64()`` stamp after every
    ``__syncthreads();`` of the kernel's body and the stamps' sums stored
    into the ELBO history's slots ``max_iter + k`` where thread 0 writes
    the stop statistics; also the source line of each barrier."""
    m = re.search(r"__global__[^{;]*fused_fit_kernel[^{;]*\{", src)
    if m is None:
        raise ValueError("no __global__ fused_fit_kernel in the source")
    depth, end = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    body = src[m.end():end - 1]
    lines, pieces, pos = [], [], 0
    for k, b in enumerate(re.finditer(r"__syncthreads\(\);", body)):
        if k >= STAGE_SLOTS:
            raise ValueError("more barriers than stage slots")
        lines.append(src.count("\n", 0, m.end() + b.start()) + 1)
        pieces += [body[pos:b.start()],
                   f"{{ __syncthreads(); if (threadIdx.x == 0) {{ const long "
                   f"long _c = clock64(); _k3_stage[{k}] += _c - _k3_last; "
                   f"_k3_last = _c; }} }}"]
        pos = b.end()
    body = "".join(pieces) + body[pos:]
    eh = "a.eh" if "a.eh[" in body else "eh"  # the first design's name
    store = ("\n#pragma unroll\n    for (int _k = 0; _k < "
             f"{STAGE_SLOTS}; ++_k) {eh}[a.max_iter + _k] = "
             "static_cast<float>(_k3_stage[_k]);\n    ")
    at = re.search(r"^[ \t]*(a\.)?stats\[0\] =", body, re.M)
    if at is None:
        raise ValueError("the kernel body does not write stats[0]")
    body = body[:at.start()] + store + body[at.start():]
    head = (f"\n  long long _k3_stage[{STAGE_SLOTS}] = {{}};\n"
            "  long long _k3_last = clock64();\n")
    return src[:m.end()] + head + body + src[end - 1:], lines


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


def fit_shapes(device, demo_iters: int = 25, bench_iters: int = 150):
    """(label, positional args, keywords) of the two fits: the
    ``demo_iters``-iteration 15-block demo fit and ``bench``'s
    ``bench_iters``-iteration Jacobi fit."""
    import torch

    from tame_torch.config import ModelConfig
    from tame_torch.inference import cavi
    from tame_torch.models import TemporalAMEModel, build_params, sample

    model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2, seed=7,
                             device=device)
    Y = model.generate_data()
    p = model.params.to(device)
    init = cavi.init_state(torch.Generator().manual_seed(3), 15, 10, 6,
                           "full", 0.1, 0.5, device=device)
    demo = ("15-block demo fit", (Y, p.R_inv, p.Sigma0, p.Q, p.Phi,
                                  init.X_mean, init.X_cov, demo_iters, 0.7,
                                  0.0), dict(num_blocks=15))
    cfg = ModelConfig(n_nodes=15, n_time=10, latent_dim=2,
                      ar_coefficient=0.8, rho_dyadic=0.5, seed=42)
    bp = build_params(cfg).to(device)
    Yb, _ = sample(bp, torch.Generator(device=device).manual_seed(42), 15, 10)
    binit = cavi.init_state(torch.Generator(device=device).manual_seed(43),
                            15, 10, 6, "full", 0.1, 0.5)
    jac = ("bench Jacobi fit", (Yb, bp.R_inv, bp.Sigma0, bp.Q, bp.Phi,
                                binit.X_mean, binit.X_cov, bench_iters, 0.7,
                                0.0), dict(num_blocks=1))
    return [demo, jac]


class _Recorder:
    """The extension, with the arguments of its last ``fused_fit`` call
    kept for replay."""

    def __init__(self, ext):
        self.ext, self.args = ext, None

    def __getattr__(self, name):
        return getattr(self.ext, name)

    def fused_fit(self, *args):
        self.args = args
        return self.ext.fused_fit(*args)


def _with_ext(ext, fn):
    """``fn()`` with ``_ext.load()`` returning ``ext``."""
    from tame_torch.ops import _ext

    real = _ext.load
    _ext.load = lambda: ext
    try:
        return fn()
    finally:
        _ext.load = real


def time_fit(fit_args, kw, repeats: int) -> dict:
    """``bare_ms``, the median of ``repeats`` replays of the extension's
    ``fused_fit`` on the inputs a first wrapper call prepared, and
    ``wrapper_ms``, of the whole ``fused_fit_kernel`` call, readback
    included (CUDA events)."""
    from tame_torch.ops import _ext
    from tame_torch.ops import fused_fit as ff

    rec = _Recorder(_ext.load())
    _with_ext(rec, lambda: ff.fused_fit_kernel(*fit_args, **kw))
    return {"bare_ms": _cuda_ms(lambda: rec.ext.fused_fit(*rec.args),
                                repeats),
            "wrapper_ms": _cuda_ms(lambda: ff.fused_fit_kernel(*fit_args,
                                                               **kw),
                                   repeats)}


def _stage_ext(root: pathlib.Path):
    """The extension built from ``root``'s sources with K3's stage stamps."""
    from torch.utils.cpp_extension import load as cpp_load

    from tame_torch.ops import _ext

    base = root / "build" / "k3_stages"
    csrc = base / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_ext.CSRC, csrc)
    src, lines = instrumented_source((csrc / "fused_fit.cu").read_text())
    (csrc / "fused_fit.cu").write_text(src)
    (base / "build").mkdir(parents=True, exist_ok=True)
    ext = cpp_load(name="tame_torch_k3_stages",
                   sources=[str(csrc / s) for s in _ext.SOURCES],
                   build_directory=str(base / "build"),
                   extra_cflags=["-O3", "-std=c++17"],
                   extra_cuda_cflags=list(_ext.CUDA_FLAGS),
                   extra_include_paths=[str(csrc)])
    return ext, lines


def res_usage() -> list[str]:
    """``cuobjdump -res-usage`` lines of the built extension's K3
    instantiations (function name, then its registers and memory)."""
    from tame_torch.ops import _ext

    so = next(_ext.BUILD_DIR.glob("tame_torch_kernels*.so"))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", str(so)],
                         capture_output=True, text=True, check=True).stdout
    rows = out.splitlines()
    return [f"{a.strip()} {b.strip()}" for a, b in zip(rows, rows[1:])
            if "fused_fit" in a and "Function" in a]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=None,
                        help="tree to import tame_torch from (default: this "
                             "file's)")
    parser.add_argument("--tag", default="", help="label for the output")
    parser.add_argument("--demo-iters", type=int, default=25)
    parser.add_argument("--bench-iters", type=int, default=150)
    parser.add_argument("--n-fits", type=int, default=64,
                        help="sequential fits of the bench demo leg")
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--stages", action="store_true")
    parser.add_argument("--res-usage", action="store_true")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    root = pathlib.Path(args.root or pathlib.Path(__file__).parents[2])
    root = root.resolve()
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))

    import tame_torch
    from tame_torch.ops import _ext
    from tame_torch.ops import fused_fit as ff
    from tame_torch.scripts import _common, bench

    _common.require(pathlib.Path(tame_torch.__file__).resolve().parents[1]
                    == root, f"tame_torch was imported from "
                    f"{tame_torch.__file__}, not from {root}")
    device = _common.resolve_device(args.device)
    print(_common.describe(device), flush=True)
    on_card = device.type == "cuda"
    res = {"tag": args.tag, "root": str(root), "shapes": {}}
    if on_card:
        t0 = time.perf_counter()
        _ext.load()
        res["build_s"] = time.perf_counter() - t0
    if on_card and args.stages:
        sext, lines = _stage_ext(root)
    for label, fit_args, kw in fit_shapes(device, args.demo_iters,
                                          args.bench_iters):
        max_iter = fit_args[7]
        kw = dict(kw, r=2, buf_size=max_iter + STAGE_SLOTS,
                  structure="full", corrected=False)
        out = {}
        if not on_card:
            t0 = time.perf_counter()
            fit = ff.fused_fit(*fit_args, **kw)
            out["twin_s"] = time.perf_counter() - t0
        else:
            fit = ff.fused_fit_kernel(*fit_args, **kw)
            out.update(time_fit(fit_args, kw, args.repeats))
            if args.stages:
                sfit = _with_ext(sext, lambda: ff.fused_fit_kernel(
                    *fit_args, **kw))
                cyc = sfit.elbo_history[max_iter:max_iter + len(lines)]
                total = float(cyc.sum())
                out["stages"] = [
                    {"barrier_line": ln, "cycles": float(c),
                     "share": float(c) / total}
                    for ln, c in zip(lines, cyc.tolist())]
        out["n_iter"] = fit.n_iter
        out["final_elbo"] = float(fit.elbo_history[fit.n_iter - 1])
        res["shapes"][label] = out
        print(f"{args.tag} {label}: {json.dumps(out)}", flush=True)
    rate = bench.demo_rate(device, args.n_fits, args.repeats)
    res["bench_it_per_s"] = rate
    res["bench_ms_per_fit"] = bench.N_ITERS / rate * 1e3
    print(f"{args.tag} bench demo leg ({args.n_fits} fits, best of "
          f"{args.repeats}): {rate} it/s, {res['bench_ms_per_fit']} ms per "
          f"fit", flush=True)
    if on_card and args.res_usage:
        res["res_usage"] = res_usage()
        print("\n".join(res["res_usage"]), flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
