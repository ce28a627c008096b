"""What a traced run reads from ``torch.profiler``: the device operations
(kernels, copies, fills) with their times, and the benchmark's own host
spans (``tbench.*``, recorded with ``record_function``), on the profiler's
one clock in microseconds; their reduction to busy time, idle gaps named
by the innermost span open on the host, and the breakdown of the result
line.

Spans of a fit: ``tbench.fit`` (the whole fit), ``tbench.engine_init``
(building the engine, its start drawn or computed), ``tbench.engine_fit``
(its ``fit``); inside that ``tbench.fit_fn`` around the program's fit
function, ``tbench.step`` around each block step and ``tbench.diag``
around each diagnostics pass (wrapped from outside, :func:`wrap_program`);
``tbench.window`` around all traced fits.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import re
from typing import Dict, List, NamedTuple, Tuple

SPAN = "tbench."


class Op(NamedTuple):
    name: str
    start: float    # microseconds
    end: float


class TraceData(NamedTuple):
    ops: List[Op]       # device operations, by start
    spans: List[Op]     # benchmark spans on the host, by start
    window: Tuple[float, float]


@contextlib.contextmanager
def wrap_program(record_function, wrapped):
    """Wrap the program's functions that ``wrapped`` names, ``(module,
    function, span)`` each (a traffic kind's fit function, block step and
    diagnostics), with spans for as long as the context lasts; a function
    that is gone is left out."""
    saved = []
    try:
        for module, fn, span in wrapped:
            try:
                mod = importlib.import_module(module)
                orig = getattr(mod, fn)
            except (ImportError, AttributeError):
                continue

            def wrapped(*a, __orig=orig, __span=span, **kw):
                with record_function(__span):
                    return __orig(*a, **kw)

            saved.append((mod, fn, orig))
            setattr(mod, fn, functools.wraps(orig)(wrapped))
        yield
    finally:
        for mod, fn, orig in reversed(saved):
            setattr(mod, fn, orig)


def _events(prof):
    """``(name, start us, end us, device type)`` of every profiled event,
    read from the profiler's raw results (building its event tree takes
    seconds per hundred thousand events)."""
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns() * 1e-3,
                 (e.start_ns() + e.duration_ns()) * 1e-3, e.device_type())
                for e in raw]
    except AttributeError:
        return [(e.name, float(e.time_range.start), float(e.time_range.end),
                 e.device_type) for e in prof.events()]


def collect(prof) -> TraceData:
    """Device operations and benchmark spans of a finished profile."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for name, start, end, dev in _events(prof):
        item = Op(name, start, end)
        if name.startswith(SPAN):
            # a span, or its shadow on the device's timeline
            if dev != DeviceType.CUDA:
                spans.append(item)
        elif dev == DeviceType.CUDA:
            ops.append(item)
    ops.sort(key=lambda o: o.start)
    spans.sort(key=lambda o: o.start)
    win = [s for s in spans if s.name == "tbench.window"]
    window = ((win[0].start, win[0].end) if win else
              (min(o.start for o in ops + spans),
               max(o.end for o in ops + spans)))
    return TraceData(ops=ops, spans=spans, window=window)


def busy_intervals(ops: List[Op], lo: float, hi: float) -> List[tuple]:
    """The union of the operations' intervals inside [lo, hi], sorted."""
    out: List[list] = []
    for o in ops:
        s, e = max(o.start, lo), min(o.end, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_us(data: TraceData) -> float:
    lo, hi = data.window
    return sum(e - s for s, e in busy_intervals(data.ops, lo, hi))


def idle_gaps(data: TraceData) -> List[tuple]:
    """``(start, end)`` of each stretch of the window with no device
    operation."""
    lo, hi = data.window
    gaps, t = [], lo
    for s, e in busy_intervals(data.ops, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_by_span(data: TraceData) -> Dict[str, float]:
    """Idle microseconds by the innermost benchmark span open at the middle
    of each gap (``host`` where none is)."""
    out: Dict[str, float] = {}
    spans, k, active = data.spans, 0, []
    for s, e in sorted(idle_gaps(data)):
        mid = 0.5 * (s + e)
        while k < len(spans) and spans[k].start <= mid:
            active.append(spans[k])
            k += 1
        active = [a for a in active if a.end >= mid]
        name = (max(active, key=lambda a: (a.start, -a.end)).name if active
                else "host")
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    n = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return (s.split("::")[-1] if s else name)[:80]


def device_time_by_name(data: TraceData) -> Dict[str, float]:
    """Device microseconds by :func:`short_name` inside the window."""
    lo, hi = data.window
    out: Dict[str, float] = {}
    for o in data.ops:
        if lo <= o.start <= hi:
            k = short_name(o.name)
            out[k] = out.get(k, 0.0) + (o.end - o.start)
    return out


def breakdown(data: TraceData) -> dict:
    """The ten device operations that took most time and the ten host spans
    under which the device sat idle longest, in seconds."""
    top = lambda d: [[k, v * 1e-6] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(device_time_by_name(data)),
            "idle_gaps": top(idle_by_span(data))}


def kernels(data: TraceData) -> List[Op]:
    """The window's kernels: device operations other than the copy
    engines' copies and fills."""
    lo, hi = data.window
    return [o for o in data.ops if lo <= o.start <= hi
            and not o.name.startswith(("Memcpy", "Memset"))]


def named(data: TraceData, names: tuple) -> Tuple[int, float]:
    """``(launches, device microseconds)`` of the kernels whose
    :func:`short_name` is one of ``names``."""
    hits = [o for o in kernels(data) if short_name(o.name) in names]
    return len(hits), sum(o.end - o.start for o in hits)
