"""Find each piece of a cell by its name.

``BENCHMARK.json`` (at the root of the checkout) names a cell's
configuration and traffic mix, and the metrics it reports. Every piece
lives in a file of its own, so a later change adds a cell by adding
files and entries and edits none:

* a configuration: the file its ``configs`` entry names;
* a traffic mix: ``gbench/traffic/<mix>.json``, parameters only; it names
  its client loop (``gbench/generators/<generator>.py``) and its kind of
  job (``gbench/jobs/<job>.py``);
* a metric: ``gbench/metrics/<metric>.py``, whose ``read(run)`` returns
  one number, or None where the run holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"gbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _read_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    path = os.path.join(HERE, "traffic", f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no traffic mix named {name!r} ({path})")
    return _read_json(path)


def generator(name: str):
    return _load_module("generators", name)


def job_kind(name: str):
    return _load_module("jobs", name)


def metric(name: str):
    return _load_module("metrics", name)


def cell_metrics(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's metric entries: its ``end_to_end`` ones in an untraced
    run, its ``per_layer`` ones in a traced run. An entry without a
    ``workloads`` key belongs to every cell."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
