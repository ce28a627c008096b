"""Finding a cell and its parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic; a configuration's file is the one its entry names, a traffic
mix is ``tbench/traffic/<traffic>.json``, a cell's comparison limits and
the sizes its CPU tests run at are ``tbench/checks/<cell>.json`` and
every metric, end to end or per layer, is read by
``tbench/metrics/<metric>.py``.  A traffic mix names its ``kind``:
the kind of fit it streams, driven through the program by
``tbench/traffic/<kind>.py`` and replayed by the plain reference in
``tbench/reference/kinds/<kind>.py``.  Adding a cell, a configuration, a
traffic mix, a kind or a metric adds files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import NamedTuple

PACKAGE = pathlib.Path(__file__).resolve().parent
ROOT = PACKAGE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict      # the configuration's file
    traffic: dict     # the traffic mix's file
    checks: dict      # sample size, settle, limits, the CPU tests' sizes
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its data files
    read under ``root``."""
    bench = load_benchmark(root)
    w = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], w["config"], "config")
    data = root / PACKAGE.name
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(data / "traffic" / f"{w['traffic']}.json"),
        checks=load_json(data / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def _module(folder: str, name: str):
    """``tbench/<folder>/<name>.py``, loaded by its path (a metric's name
    may hold dots)."""
    path = PACKAGE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(ROOT)}")
    dotted = f"tbench.{folder.replace('/', '.')}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(dotted, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The ``read(run)`` function of ``tbench/metrics/<name>.py``."""
    return _module("metrics", name).read


def traffic_kind(kind: str):
    """The program's side of a kind of fit: ``tbench/traffic/<kind>.py``,
    whose ``engine(stream, k)`` builds fit k's engine, ``WRAPPED`` names
    the program functions a traced run wraps in the benchmark's spans and
    ``FAULT_TARGETS`` where the fault tests plant their faults."""
    return _module("traffic", kind)


def reference_kind(kind: str):
    """The reference's side of a kind of fit:
    ``tbench/reference/kinds/<kind>.py``, whose ``check(config, traffic)``
    refuses what it does not replay, ``start(...)`` begins a replay and
    ``iteration_flops(n, T, d, num_blocks)`` counts an iteration's work."""
    return _module("reference/kinds", kind)
