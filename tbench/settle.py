"""Readings that set a cell's ``settle``: the relative gap between the
program's ELBO history and the float64 reference's at each of the first
``--iters`` iterations of many fits, and for each candidate ``settle`` how
many of those fits the widest gap after it puts above the cell's
``elbo_tail_gap`` limit; beside them the control (the reference in TF32,
to its own stop, in the program's place) judged at each candidate.

    python3 -m tbench.settle --workload <cell> --seeds 11,12,... \
        --fits 10 --iters 30 [--control-seeds 21,22,23] [--out FILE]

Each seed draws the cell's networks as a run does, warms up as a run does
and runs its first ``--fits`` fits for ``--iters`` iterations each, the
iterations a whole fit begins with.  Each control seed replays its first
fit by the TF32 reference.  Prints one JSON line per fit and, last, the
table: per candidate ``settle`` the program's fits above the limit and
their widest gap, and the control's numbers, of which ``elbo_tail_gap``
alone depends on ``settle``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from tbench import harness, spec
from tbench.reference.judge import (KEYS, elbo_gaps, fit_numbers,
                                    reference_fit, tail_gap)
from tbench.stream import FitStream


def program_lines(cell, seed: int, device, fits: int, iters: int):
    stream = FitStream(cell, seed, device)
    stream.warm_up()
    for k in range(fits):
        rec = stream.run_fit(k, max_iter=iters, keep=False)
        ref = reference_fit(cell, stream.Y[rec.network],
                            stream.mask(rec.index), rec.engine_seed, "f64",
                            n_iter=len(rec.elbo),
                            device=harness._ref_device(cell))
        yield {"seed": seed, "fit": k, "control": False,
               "failed": rec.failed,
               "gaps": elbo_gaps(rec.elbo, ref.elbo).tolist()}


def control_line(cell, seed: int, device) -> dict:
    stream = FitStream(cell, seed, device)
    k = 0
    args = (stream.Y[stream.network(k)], stream.mask(k),
            stream.engine_seed(k))
    ctrl = reference_fit(cell, *args, "tf32",
                         device=harness._ref_device(cell))
    ref = reference_fit(cell, *args, "f64", n_iter=len(ctrl.elbo),
                        device=harness._ref_device(cell))
    numbers = fit_numbers(ctrl, ref, cell.config["fit"],
                          cell.checks["settle"])
    return {"seed": seed, "fit": k, "control": True, "failed": False,
            "gaps": elbo_gaps(ctrl.elbo, ref.elbo).tolist(),
            **{key: numbers[key] for key in KEYS if key != "elbo_tail_gap"}}


def table(lines, limits: dict, iters: int) -> list:
    """Per candidate ``settle``: the program's fits whose tail gap passes
    the limit, the widest of their tail gaps, and the control's numbers
    (each the smallest over its seeds) and whether every control seed
    fails some limit."""
    prog = [x for x in lines if not x["control"]]
    ctrl = [x for x in lines if x["control"]]
    limit = limits["elbo_tail_gap"]
    rows = []
    for s in range(iters):
        tails = [tail_gap(x["gaps"], s) for x in prog]
        row = {"settle": s,
               "over": sum(not t <= limit for t in tails),
               "widest": max(tails, default=None)}
        if ctrl:
            numbers = [dict({k: x[k] for k in limits if k in x},
                            elbo_tail_gap=tail_gap(x["gaps"], s))
                       for x in ctrl]
            row["control"] = {k: min(n[k] for n in numbers) for k in limits}
            row["control_fails"] = all(
                not harness.passed(harness.checks_of(n, limits))
                for n in numbers)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fits", type=int, default=10)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        from tame_torch.ops import _ext

        _ext.load()
    torch.set_num_threads(2)
    lines = []
    t0 = time.perf_counter()
    for seed in (int(s) for s in args.seeds.split(",") if s):
        for line in program_lines(cell, seed, device, args.fits, args.iters):
            lines.append(line)
            print(json.dumps(line), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        lines.append(control_line(cell, seed, device))
        print(json.dumps(lines[-1]), flush=True)
    rows = table(lines, cell.checks["limits"], args.iters)
    clear = [r["settle"] for r in rows if r["over"] == 0]
    out = {"workload": cell.name, "limit": cell.checks["limits"][
        "elbo_tail_gap"], "fits": sum(not x["control"] for x in lines),
        "failed": sum(x["failed"] for x in lines),
        "least_clear_settle": clear[0] if clear else None, "table": rows}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**out, "lines": lines}, f, indent=1)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    return 0 if not out["failed"] else 1


if __name__ == "__main__":
    sys.exit(main())
