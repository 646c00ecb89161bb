"""Finds everything by name, from files under a checkout's root.

* ``BENCHMARK.json``: the cells (``workloads``), their configurations and
  the per-layer metrics each cell reports;
* ``benchmark/configs/<config>.json`` (the ``file`` of the configuration's
  entry): one system;
* ``benchmark/cells/<cell>.json``: one traffic mix on one configuration;
* ``benchmark/solvers/<solver>.py``: the program's step and the reference's
  for one kind of run, named by the cell's ``solver``;
* ``benchmark/metrics/<metric>.py``: one per-layer metric reader.

Adding a configuration, a cell or a metric adds files and entries here and
edits no code.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "benchmark"


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict      # the configuration file's contents
    params: dict      # the cell file's contents
    per_layer: list   # the BENCHMARK.json entries of the metrics it reports
    end_to_end: list  # the BENCHMARK.json entries of its end-to-end metrics
    chips: int


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reported_in(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the checkout at ``root``; KeyError if
    ``BENCHMARK.json`` has no such workload."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, config=load_json(root / conf["file"]),
                params=load_json(root / PACKAGE / "cells" / f"{name}.json"),
                per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)],
                end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
                chips=int(w["chips"]))


def _module(root: Path, kind: str, name: str):
    path = root / PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def solver(name: str, root: Path = ROOT):
    return _module(root, "solvers", name)


def metric(name: str, root: Path = ROOT):
    return _module(root, "metrics", name)


def names(kind: str, root: Path = ROOT) -> list[str]:
    """The names of the files of one kind (``configs``, ``cells``,
    ``solvers``, ``metrics``) under ``root``."""
    suffix = ".py" if kind in ("solvers", "metrics") else ".json"
    return sorted(p.name[:-len(suffix)] for p in (root / PACKAGE / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))
