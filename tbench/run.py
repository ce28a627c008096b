"""Run one cell of the benchmark and print its result as the last line.

    python3 -m tbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic and
limits are found by name (:mod:`tbench.spec`).  The run needs as many
CUDA devices as the cell asks for and exits with another code than 0,
printing no result, without them, when the program cannot be imported,
or when a module of JAX or of the JAX package was loaded.  The kernels'
build and every compiler cache stay in fixed directories under the
checkout's ``build/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# compiler caches at fixed paths in the checkout, set before torch loads
CACHES = (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache"))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES:
        os.environ[var] = str(ROOT / "build" / "tbench_cache" / sub)
    from tbench import harness, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
