"""Profiling and observability utilities (counterpart of
:mod:`tame.utils.profiling`).

* :func:`trace` — a ``torch.profiler`` trace of the enclosed block (CPU
  and, with a card, CUDA activity), written as a Chrome trace;
* :func:`benchmark` — warm-up, then ``repeats`` timed calls: CUDA events
  around each call when the work runs on the card (the device's own clock;
  PyTorch returns before the card finishes), the host clock otherwise;
* :class:`MetricsLogger` — append-only JSONL metric stream with host
  timestamps, the structured replacement for print-based progress.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block with ``torch.profiler``; the profile is
    yielded (``key_averages()`` for sums by kernel) and written to
    ``<log_dir>/trace.json`` (open in Perfetto or ``chrome://tracing``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def benchmark(fn: Callable, *args, warmup: int = 1, repeats: int = 3,
              on_card: Optional[bool] = None, **kwargs) -> Dict[str, Any]:
    """Time ``fn(*args, **kwargs)`` after ``warmup`` untimed calls.

    ``on_card`` (default: whether this process has started CUDA work)
    times each call between two CUDA events on the current stream and
    waits for the second; otherwise each call is timed on the host clock.
    Returns ``{"best_s", "median_s", "mean_s", "repeats", "clock"}``.
    """
    if on_card is None:
        on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    for _ in range(warmup):
        fn(*args, **kwargs)
    times: List[float] = []
    if on_card:
        torch.cuda.synchronize()
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "median_s": statistics.median(times),
            "mean_s": sum(times) / len(times), "repeats": repeats,
            "clock": "cuda events" if on_card else "host"}


class MetricsLogger:
    """Append-only JSONL metrics stream.

    Each record: ``{"step": int, "time": unix_seconds, **metrics}``.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, step: int, **metrics: Any) -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path: str | Path) -> List[Dict[str, Any]]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


def log_fit_history(logger: MetricsLogger, history: Dict[str, List[float]],
                    start_step: int = 0) -> None:
    """Stream a fit history dict into a metrics logger."""
    n = max((len(v) for v in history.values()), default=0)
    for i in range(n):
        logger.log(start_step + i,
                   **{k: v[i] for k, v in history.items() if i < len(v)})
