"""A cell added with data files alone: a temporary root holding a copy of
``BENCHMARK.json`` with one more cell, and that cell's configuration,
traffic mix and checks files, each a copy of the smallest cell's under a
new name.  The cell is found by name there, runs, and is held to the CPU
control and the planted faults by the same checks as the benchmark's own
cells; no test names it.

    python -m pytest tbench/tests -q
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from tbench import harness, spec
from tbench.tests import test_tbench_controls as controls
from tbench.tests.test_tbench_harness import BENCH, CELLS, shrink


def _smallest():
    """The benchmark's cell on the configuration of the fewest nodes."""
    sizes = {c["name"]: spec.load_json(spec.ROOT / c["file"])["model"]
             ["n_nodes"] for c in BENCH["configs"]}
    return min(BENCH["workloads"], key=lambda w: sizes[w["config"]])


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """``(root, name)``: the temporary root and the added cell's name."""
    root = tmp_path_factory.mktemp("root")
    base = _smallest()
    name = f"{base['name']}_added"
    conf = next(c for c in BENCH["configs"] if c["name"] == base["config"])
    bench = json.loads(json.dumps(BENCH))
    new_conf = dict(conf, name=f"{conf['name']}_added",
                    file=f"tbench/configs/{conf['name']}_added.json")
    bench["configs"].append(new_conf)
    bench["workloads"].append(dict(base, name=name, config=new_conf["name"],
                                   traffic=f"{base['traffic']}_added"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base["name"] in m.get("workloads", ()):
            m["workloads"].append(name)
    files = {new_conf["file"]: dict(spec.load_json(spec.ROOT / conf["file"]),
                                    name=new_conf["name"]),
             f"tbench/traffic/{base['traffic']}_added.json": spec.load_json(
                 spec.PACKAGE / "traffic" / f"{base['traffic']}.json"),
             f"tbench/checks/{name}.json": spec.load_json(
                 spec.PACKAGE / "checks" / f"{base['name']}.json"),
             "BENCHMARK.json": bench}
    for rel, obj in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(obj, indent=1))
    return root, name


def test_added_cell_found_by_name_in_its_root(added):
    root, name = added
    assert name not in CELLS
    with pytest.raises(KeyError):
        spec.load_cell(name)
    cell = spec.load_cell(name, root)
    base = spec.load_cell(_smallest()["name"])
    assert cell.name == name and cell.chips == base.chips
    assert cell.traffic == base.traffic and cell.checks == base.checks
    assert cell.config["model"] == base.config["model"]
    for group in ("end_to_end", "per_layer"):
        assert ([m["name"] for m in getattr(cell, group)]
                == [m["name"] for m in getattr(base, group)])


def test_added_cell_runs_correct(added):
    torch.set_num_threads(1)
    cell = spec.load_cell(added[1], added[0])
    small = shrink(cell, *cell.checks["cpu"]["size"])
    res = harness.run(small, 2**35 + 9, 0.0, False, torch.device("cpu"),
                      time.perf_counter(), log=lambda line: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) <= {m["name"] for m in cell.end_to_end}


def test_added_cell_control_fails_on_the_cpu(added):
    controls.check_control_fails_on_the_cpu(spec.load_cell(added[1],
                                                           added[0]))


def test_added_cell_float32_reference_passes(added):
    controls.check_float32_reference_passes(spec.load_cell(added[1],
                                                           added[0]))


@pytest.mark.parametrize("fault", list(controls.FAULTS))
def test_added_cell_fault_comes_out_not_correct(added, fault, monkeypatch):
    controls.check_fault_comes_out_not_correct(
        spec.load_cell(added[1], added[0]), fault, monkeypatch)
