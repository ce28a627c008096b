"""One run of one cell: set-up, the measured window of whole fits, the
metrics, and the comparison with the plain reference that decides
``correct``.

The window is a closed loop with one caller: fit k starts when fit k - 1
has returned and the device is idle, and the window closes at the end of
the first fit that ends after ``seconds`` (no fit is cut).  A traced run
puts a fixed count of fits (the traffic's ``trace_fits``) under
``torch.profiler`` instead, with the benchmark's spans.  After the window:
the device's peak memory is read, the engines are gone, and the reference
replays a sample of the finished fits drawn from the seed, the longest
among them, in float64.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from tbench import spec, trace
from tbench.reference.judge import (Outcome, check_cell, fit_numbers,
                                    reference_fit, worst)
from tbench.stream import FitRecord, FitStream, derive_seed

# Top-level module names no run may load (compared whole: the port's name
# begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "tame")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run(NamedTuple):
    """What the metric readers read."""

    cell: spec.Cell
    setup_s: float
    window_s: float
    fits: List[FitRecord]
    trace: Optional[trace.TraceData]


def run_window(stream: FitStream, seconds: float,
               max_fits: Optional[int] = None):
    """Whole fits back to back until ``seconds`` have passed (or
    ``max_fits`` fits): ``(fits, window seconds)``."""
    fits: List[FitRecord] = []
    t0 = time.perf_counter()
    while True:
        fits.append(stream.run_fit(len(fits)))
        elapsed = time.perf_counter() - t0
        if (len(fits) >= max_fits if max_fits is not None
                else elapsed >= seconds):
            return fits, elapsed


def traced_window(stream: FitStream, n_fits: int):
    """``n_fits`` fits under the profiler: ``(fits, seconds, trace)``."""
    from torch import profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if stream.device.type == "cuda":
        acts.append(tp.ProfilerActivity.CUDA)
    stream.spans = tp.record_function
    try:
        with trace.wrap_program(tp.record_function, stream.kind.WRAPPED), \
                tp.profile(activities=acts) as prof:
            with tp.record_function("tbench.window"):
                fits, seconds = run_window(stream, 0.0, max_fits=n_fits)
    finally:
        stream.spans = None
    return fits, seconds, trace.collect(prof)


def sample_fits(fits: List[FitRecord], size: int, seed: int):
    """The longest finished fit and ``size - 1`` others drawn from the
    seed."""
    done = [f for f in fits if not f.failed]
    if not done:
        return []
    longest = max(done, key=lambda f: (f.n_iter, -f.index))
    others = [f for f in done if f is not longest]
    rng = np.random.default_rng(derive_seed(seed, 4))
    k = min(size - 1, len(others))
    picks = sorted(rng.choice(len(others), size=k, replace=False)) if k else []
    return [longest] + [others[i] for i in picks]


def judge(cell, stream: FitStream, outcomes) -> dict:
    """The compared numbers, worst over ``outcomes``: pairs of a fit record
    (its network, mask and seed) and what was produced for it, each against
    the float64 reference."""
    readings = []
    for rec, got in outcomes:
        ref = reference_fit(cell, stream.Y[rec.network], stream.mask(rec.index),
                            rec.engine_seed, "f64", n_iter=len(got.elbo),
                            device=_ref_device(cell))
        readings.append(fit_numbers(got, ref, cell.config["fit"],
                                    cell.checks["settle"]))
        del ref
    return worst(readings)


def control_outcome(cell, stream: FitStream, rec: FitRecord) -> Outcome:
    """The control in the program's place: the reference in TF32, to its
    own stop."""
    return reference_fit(cell, stream.Y[rec.network], stream.mask(rec.index),
                         rec.engine_seed, "tf32", device=_ref_device(cell))


def _ref_device(cell):
    """Where the reference runs: the checks file's ``reference_device``
    (the host's cores beat a card's launches at the quick-start size),
    where there is such a device, else the program's."""
    dev = cell.checks.get("reference_device")
    if dev == "cuda" and not torch.cuda.is_available():
        return None
    return dev


def checks_of(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def _launches_per_fit(fits: List[FitRecord]) -> dict:
    out = {}
    for k in fits[0].launches if fits else ():
        vals = [f.launches[k] for f in fits]
        out[k] = None if None in vals else sum(vals) / len(vals)
    return out


def _write_trace_file(cell, seed, data, fits) -> None:
    path = spec.ROOT / "build" / "tbench" / f"{cell.name}-{seed}-trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    spans = {}
    for s in data.spans:
        spans[s.name] = spans.get(s.name, 0.0) + (s.end - s.start) * 1e-6
    with open(path, "w") as f:
        json.dump({"cell": cell.name, "seed": seed,
                   "window_s": (data.window[1] - data.window[0]) * 1e-6,
                   "launches_per_fit": _launches_per_fit(fits),
                   "iterations": [r.n_iter for r in fits],
                   "device_s_by_kernel": {
                       k: v * 1e-6
                       for k, v in trace.device_time_by_name(data).items()},
                   "idle_s_by_span": {
                       k: v * 1e-6
                       for k, v in trace.idle_by_span(data).items()},
                   "span_s": spans}, f, indent=1)


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float, log=print) -> dict:
    """One run: the result line's object (``correct`` decided, the
    comparison's numbers under ``checks``, last).  ``log`` takes the lines
    printed before the result: the launches per fit and the phases'
    seconds.  A cell whose fits the reference does not replay is refused
    before set-up."""
    check_cell(cell)
    if device.type == "cuda":
        from tame_torch.ops import _ext

        _ext.load()
    stream = FitStream(cell, seed, device)
    stream.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    data = None
    if traced:
        fits, window_s, data = traced_window(stream,
                                             cell.traffic["trace_fits"])
    else:
        fits, window_s = run_window(stream, seconds)
    t_window = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    record = Run(cell, setup_s, window_s, fits, data)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    failed = sum(f.failed for f in fits)
    extra = {}
    if traced:
        lo, hi = data.window
        dev.update(busy_s=trace.busy_us(data) * 1e-6,
                   window_s=(hi - lo) * 1e-6)
        extra["breakdown"] = trace.breakdown(data)
        _write_trace_file(cell, seed, data, fits)
    del record, data
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_read = time.perf_counter()

    sample = sample_fits(fits, cell.checks["sample"], seed)
    numbers = (judge(cell, stream, [(f, Outcome(f.X, f.elbo)) for f in sample])
               if sample else {k: math.inf for k in cell.checks["limits"]})
    log(json.dumps({"path_launches_per_fit": _launches_per_fit(fits),
                    "iterations": [f.n_iter for f in fits[:200]],
                    "seconds": {"setup": setup_s, "window": window_s,
                                "reading": t_read - t_window,
                                "reference": time.perf_counter() - t_read}}))
    checks = checks_of(numbers, cell.checks["limits"])
    correct = bool(sample) and failed == 0 and passed(checks)
    return {"correct": correct, "attempted": len(fits), "failed": failed,
            "metrics": metrics, "device": dev, **extra, "checks": checks}
