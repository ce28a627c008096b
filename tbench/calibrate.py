"""Readings that set a cell's comparison limits: the compared numbers of
the program's fits over many seeds (the lower reading), and of the control
in the program's place, the reference computed in TF32, over a few seeds
(the upper reading), at the cell's own size, in one process.

    python3 -m tbench.calibrate --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 [--fits 1] [--out FILE]

Each seed draws the cell's networks as a run does, runs ``--fits`` fits
(the first ones of a window) and judges them against the float64
reference; each control seed replays the same fits by the TF32 reference
to its own stop and judges that.  Prints one JSON line per seed and a
summary (the largest program reading and the smallest control reading of
each number) as the last line; ``--out`` writes them all.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from tbench import harness, spec
from tbench.reference.judge import KEYS, Outcome
from tbench.stream import FitStream


def readings(cell, seed: int, device, fits: int, control: bool) -> dict:
    stream = FitStream(cell, seed, device)
    stream.warm_up()
    recs = [stream.run_fit(k) for k in range(fits)]
    t0 = time.perf_counter()
    if control:
        outs = [(r, harness.control_outcome(cell, stream, r)) for r in recs]
    else:
        outs = [(r, Outcome(r.X, r.elbo)) for r in recs]
    numbers = harness.judge(cell, stream, outs)
    return {"seed": seed, "control": control,
            "iters": [len(o.elbo) for _, o in outs],
            "fit_s": [r.seconds for r in recs],
            "judge_s": time.perf_counter() - t0, **numbers}


def summary(lines) -> dict:
    keys = KEYS
    prog = [x for x in lines if not x["control"]]
    ctrl = [x for x in lines if x["control"]]
    return {"lower": {k: max((x[k] for x in prog), default=None)
                      for k in keys},
            "upper": {k: min((x[k] for x in ctrl), default=None)
                      for k in keys},
            "seeds": len(prog), "control_seeds": len(ctrl)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fits", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        from tame_torch.ops import _ext

        _ext.load()
    torch.set_num_threads(2)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    lines = []
    for seed, control in ([(s, False) for s in seeds]
                          + [(s, True) for s in controls]):
        line = readings(cell, seed, device, args.fits, control)
        lines.append(line)
        print(json.dumps(line), flush=True)
    out = summary(lines)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": cell.name, "lines": lines, **out}, f,
                      indent=1)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    return 0 if all(math.isfinite(x["mu_gap"]) for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
