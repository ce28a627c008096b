"""Profiling and observability utilities (counterpart of
:mod:`tame.utils.profiling`).

* :func:`span` — a named span of the program's host time, recorded only
  while a ``torch.profiler`` runs (the profiler is the one switch), on the
  profiler's clock and outside its event list; :func:`spans` reads them,
  :func:`clear_spans` empties the buffer;
* :func:`count` — integer counters, always on (``syncs``: the host's
  syncs with the card; ``graphed_iters``: fit-loop iterations replayed
  as CUDA graphs, :mod:`tame_torch.inference.graphed`; ``k5_contracts``:
  masked contractions of a packed stripe through K5 or its twin;
  ``k7_contracts``: contractions of the time-major dyad weights, or a
  stripe of their rows, through K7 or its twin);
  :func:`counters` reads them beside the kernels' launch counts;
* :func:`trace` — a ``torch.profiler`` trace of the enclosed block (CPU
  and, with a card, CUDA activity), written as a Chrome trace with the
  program's spans in it;
* :func:`benchmark` — warm-up, then ``repeats`` timed calls: CUDA events
  around each call when the work runs on the card (the device's own clock;
  PyTorch returns before the card finishes), the host clock otherwise.

Spans of the fit path, outermost first: ``engine.build`` (an engine's
constructor) holding ``engine.start`` (its random or warm start);
``engine.fit`` (an engine's ``fit``) holding ``fit.run`` (``fit_cavi``,
``fit_cavi_smoothed``), which holds ``fit.inputs`` (the loop-invariant
inputs: the dyad weights, bf16 under mixed precision, the stats
diagnostics' constants and the mask as the contractions read it, packed
for K5 or bf16), a ``loop.step`` around each iteration's update call and
a ``loop.readback`` around each read of device memory to the host.  Each
readback counts one ``syncs``, as does every other place of the fit path
that waits for the card: a synchronous copy to it, a library call that
checks its result on the host.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import statistics
import threading
import time
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    NamedTuple, Optional)

import torch

SPAN_LIMIT = 1 << 18   # records the buffer holds; later ones are dropped
SYNCS = "syncs"
GRAPHED_ITERS = "graphed_iters"
K5_CONTRACTS = "k5_contracts"
K7_CONTRACTS = "k7_contracts"
# The kernels' launch counters (``<function>.launches``), by module.
KERNELS = (("cholesky", "spd_solve_inv_kernel"),
           ("cholesky", "logdet_spd_kernel"),
           ("fused_fit", "fused_fit_kernel"),
           ("fused_smoother", "fused_smoother_kernel"),
           ("masked_contract", "packed_rows_contract_kernel"),
           ("dual_contract", "dual_contract_kernel"),
           ("eta_contract", "eta_contract_kernel"))

_profiling = torch._C._autograd._profiler_enabled


class SpanRecord(NamedTuple):
    """One span, or one unit of a count made while a profiler ran (a
    record of zero length under the counter's name)."""

    name: str
    start_ns: int   # time.time_ns(), the clock torch.profiler reports on
    end_ns: int     # -1 while the span is open
    parent: int     # index in spans() of the span open at the start, or -1
    fit: int        # shared by every record under one outermost span, or -1


class _Buffer:
    """The records since the last clear, at most ``limit`` of them, and
    each thread's stack of open spans ``(index, fit, generation)``."""

    def __init__(self, limit: int):
        self.limit = limit
        self.lock = threading.Lock()
        self.local = threading.local()
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.generation = 0
        self.fits = 0

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def _top(self, stack) -> tuple:
        """``(parent index, fit)`` for a record made now."""
        if not stack:
            return -1, -1
        index, fit, generation = stack[-1]
        return (index if generation == self.generation else -1), fit

    def _add(self, record: SpanRecord) -> int:
        if len(self.records) >= self.limit:
            self.dropped += 1
            return -1
        self.records.append(record)
        return len(self.records) - 1

    def open(self, name: str) -> tuple:
        stack = self.stack()
        parent, fit = self._top(stack)
        with self.lock:
            if fit < 0:
                fit, self.fits = self.fits, self.fits + 1
            entry = (self._add(SpanRecord(name, time.time_ns(), -1, parent,
                                          fit)), fit, self.generation)
        stack.append(entry)
        return entry

    def close(self, entry: tuple) -> None:
        t = time.time_ns()
        self.stack().pop()
        index, _, generation = entry
        with self.lock:
            if index >= 0 and generation == self.generation:
                self.records[index] = self.records[index]._replace(end_ns=t)

    def mark(self, name: str, k: int) -> None:
        parent, fit = self._top(self.stack())
        t = time.time_ns()
        with self.lock:
            for _ in range(k):
                self._add(SpanRecord(name, t, t, parent, fit))

    def clear(self) -> None:
        with self.lock:
            self.records, self.dropped = [], 0
            self.generation += 1


_BUFFER = _Buffer(SPAN_LIMIT)
_COUNTS: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()


class _Span:
    __slots__ = ("name", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.entry = _BUFFER.open(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        _BUFFER.close(self.entry)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager recording ``name``'s span while a
    ``torch.profiler`` runs, else one shared no-op context.  Its times come
    from ``time.time_ns()``, the profiler's clock, but it adds nothing to
    the profiler's events (no ``record_function``), so no annotation of it
    reaches the device's timeline."""
    return _Span(name) if _profiling() else _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> List[SpanRecord]:
    """The records since the last :func:`clear_spans`, by start."""
    with _BUFFER.lock:
        return list(_BUFFER.records)


def clear_spans() -> None:
    """Empty the buffer (and its count of dropped records)."""
    _BUFFER.clear()


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name``; while a profiler runs, also record
    ``k`` zero-length records of ``name`` in the span buffer, so that a
    count over a traced window can be read from :func:`spans`."""
    with _COUNT_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + k
    if _profiling():
        _BUFFER.mark(name, k)


@contextlib.contextmanager
def counts_made() -> Iterator[Dict[str, int]]:
    """A dict that holds, once the block has run, the counts
    :func:`count` made in it, by name (what a CUDA graph's capture
    counted, which each of its replays counts again)."""
    with _COUNT_LOCK:
        before = dict(_COUNTS)
    made: Dict[str, int] = {}
    yield made
    with _COUNT_LOCK:
        made.update((k, v - before.get(k, 0)) for k, v in _COUNTS.items()
                    if v != before.get(k, 0))


def count_syncs(x: torch.Tensor, k: int = 1) -> None:
    """Count ``k`` syncs where ``x`` lives on a card: a library call on it
    that waits for the card (to check its result on the host)."""
    if x.is_cuda:
        count(SYNCS, k)


def count_copies(tensors: Iterable, device) -> None:
    """Count a sync for each of ``tensors`` (None: none) that moving to
    ``device`` copies from the host to a card (a synchronous copy)."""
    if torch.device(device).type == "cuda":
        k = sum(t is not None and not (torch.is_tensor(t) and t.is_cuda)
                for t in tensors)
        if k:
            count(SYNCS, k)


def counters() -> Dict[str, int]:
    """Every counter as it stands: those of :func:`count`, each kernel's
    launches (``launches.<kernel function>``) and ``spans_dropped``, the
    records the span buffer dropped since its last clear."""
    with _COUNT_LOCK:
        out = dict(_COUNTS)
    for module, fn in KERNELS:
        mod = importlib.import_module(f"tame_torch.ops.{module}")
        out[f"launches.{fn}"] = getattr(mod, fn).launches
    out["spans_dropped"] = _BUFFER.dropped
    return out


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block with ``torch.profiler``; the profile is
    yielded (``key_averages()`` for sums by kernel) and written to
    ``<log_dir>/trace.json`` (open in Perfetto or ``chrome://tracing``),
    with the program's spans of the block as events of this thread."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    clear_spans()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    _add_spans(path)


def _add_spans(path: Path) -> None:
    """Append the closed spans to the Chrome trace at ``path`` as complete
    events of this process and thread, on the trace's time base: its
    events' microseconds count from ``baseTimeNanoseconds``."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), threading.get_native_id()
    data.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "tame_torch", "name": s.name, "pid": pid,
         "tid": tid, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"index": i, "parent": s.parent, "fit": s.fit}}
        for i, s in enumerate(spans()) if s.end_ns >= s.start_ns)
    with open(path, "w") as f:
        json.dump(data, f)


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
