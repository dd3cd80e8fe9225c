"""The harness finds cells, configurations, drivers and metric readers by
name from files alone, and BENCHMARK.json keeps to the benchmark's contract.
A dummy cell with its own configuration, driver and metric, added as new
files beside copies of the existing ones, runs without an edit."""
import json
import re
import shutil
import time

import pytest

from portbench.harness import run_cell
from portbench.registry import ROOT, Registry
from portbench.trace import KERNELS, layer_kernels

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


@pytest.fixture(scope="module")
def reg():
    return Registry()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_kernel_of_the_port_has_a_layer():
    """Each __global__ kernel of csrc/ is named in one file of
    portbench/kernels/, so that its time is not counted as glue, and each
    file's layer is one that PERF.md's layers or the readers use."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")
    src = ROOT / "recon3d_tpu_torch" / "csrc"
    kernels = {n for p in src.glob("*.cu*") for n in pattern.findall(p.read_text())}
    assert {"path_scan_kernel", "tridiag_kernel", "project_sample_kernel"} <= kernels
    assert kernels <= layer_kernels()
    tables = [json.loads(p.read_text()) for p in sorted(KERNELS.glob("*.json"))]
    named = [k for t in tables for k in t["kernels"]]
    assert len(named) == len(set(named))
    assert layer_kernels("SGM") >= {"cost_walk_kernel", "path_scan_kernel", "finalize_kernel"}
    assert layer_kernels("WLS") == {"tridiag_kernel"}
    assert layer_kernels("no such layer") == frozenset()


def test_benchmark_json_keeps_to_the_contract(reg):
    b = reg.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"][:1] == ["python3"] and len(b["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert len(json.dumps(b)) <= 64 * 1024


def test_configs_are_files_under_paths(reg):
    used = {w["config"] for w in reg.bench["workloads"]}
    for c in reg.bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        cfg = reg.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert len({c["file"] for c in reg.bench["configs"]}) == len(reg.bench["configs"])


def test_every_cell_is_found_by_name(reg):
    pairs = set()
    for w in reg.bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = reg.cell(w["name"])
        assert cell["config"] == w["config"]
        assert hasattr(reg.driver(cell["driver"]), "Driver")
        e2e = [m["name"] for m in reg.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert set(e2e) - {"setup_s"} == set(cell["end_to_end"])
        assert reg.per_layer(w["name"]), w["name"]
        assert cell["limits"]


def test_every_metric_is_found_by_name(reg):
    cells = {w["name"] for w in reg.bench["workloads"]}
    e2e = {m["name"] for m in reg.bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in reg.bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in reg.bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        assert _line(m["layer"]) and UNIT.match(m["unit"])
        for cell in m.get("workloads", cells):
            assert m["moves"] in {e["name"] for e in reg.end_to_end(cell)}
        assert callable(reg.metric(m["name"]).read)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), m["layer"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers.values():
        assert layer in perf, f"layer {layer!r} is not in PERF.md's list"


def test_unknown_names_raise(reg):
    for fn in (reg.cell, reg.config, reg.driver, reg.metric, reg.workload):
        with pytest.raises(KeyError):
            fn("no.such.name")


DUMMY_DRIVER = '''
import torch


class Driver:
    def __init__(self, cfg, cell, seed, device):
        self.n = cfg["size"]
        self.x = torch.randn(self.n, generator=torch.Generator().manual_seed(seed))
        self.sums = []

    def warmup(self):
        self.x.sum()

    def step(self):
        self.sums.append(float((self.x * 2).sum()))
        return 2

    def work(self):
        return {"elements": self.n}

    def finish(self):
        pass

    def check(self):
        want = float(self.x.sum()) * 2
        return [{"err": max(abs(s - want) for s in self.sums)}], 0
'''

DUMMY_METRIC = '''
def read(view):
    return view.work["elements"] / view.frames
'''


def test_a_dummy_cell_needs_only_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "a test", "reduced": [],
                             "file": "portbench/configs/dummy_cfg.json", "why": "a test"})
    bench["workloads"].append({"name": "dummy.cpu", "config": "dummy_cfg", "traffic": "cpu",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "frames/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["dummy.cpu"]})
    bench["per_layer"].append({"name": "dummy.elements_per_frame", "unit": "elements",
                               "better": "lower", "source": "program_counter", "layer": "entry",
                               "moves": "dummy_rate", "workloads": ["dummy.cpu"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    d = tmp_path / "portbench"
    (d / "configs" / "dummy_cfg.json").write_text(json.dumps({"size": 1000}))
    (d / "cells" / "dummy.cpu.json").write_text(json.dumps({
        "config": "dummy_cfg", "driver": "dummy_driver", "traffic": {}, "warmup_steps": 1,
        "trace_steps": 3, "end_to_end": {"dummy_rate": "rate"}, "limits": {"err": 1e-3}}))
    (d / "drivers" / "dummy_driver.py").write_text(DUMMY_DRIVER)
    (d / "metrics" / "dummy.elements_per_frame.py").write_text(DUMMY_METRIC)

    reg = Registry(tmp_path)
    plain = run_cell(reg, "dummy.cpu", 5, 0.2, False, "cpu", time.perf_counter())
    assert plain["correct"] and set(plain["metrics"]) == {"dummy_rate", "setup_s"}
    assert plain["metrics"]["dummy_rate"]["value"] > 0
    assert list(plain)[-1] == "checks" and plain["checks"]["err"]["limit"] == 1e-3
    traced = run_cell(reg, "dummy.cpu", 5, 0.2, True, "cpu", time.perf_counter())
    assert traced["correct"]
    assert traced["metrics"] == {"dummy.elements_per_frame": {"value": 1000 / 6,
                                                              "unit": "elements"}}
    assert {"busy_s", "window_s"} <= set(traced["device"])
