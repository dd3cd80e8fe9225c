"""Finds a cell, its configuration, its driver and its metric readers by name.

Everything is found from files: `BENCHMARK.json` at the checkout's root
names the cells and metrics; `portbench/cells/<cell>.json` names the
configuration (`configs/<config>.json`) and the driver
(`drivers/<driver>.py`) and holds the traffic's parameters; each per-layer
metric is a reader `metrics/<metric>.py` with a `read(view)` function. A
later change adds a cell, configuration, driver or metric by adding such
files and entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(path: Path):
    """The module in a file of the benchmark (drivers and metric readers are
    files named after what they serve, not importable modules)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Registry:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
        return json.loads(path.read_text())

    def _module(self, kind: str, name: str):
        path = self.dir / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
        return load(path)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json names no workload {name!r}")

    def cell(self, name: str) -> dict:
        return self._json("cells", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def driver(self, name: str):
        return self._module("drivers", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if _applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"] if _applies(m, cell)]
