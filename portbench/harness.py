"""One run of one cell: set-up, the measured window, the check.

The driver named by the cell builds the program and its inputs from the
seed and warms up every shape it uses; that and the process's start are
`setup_s`. The window is a closed loop: a step hands the program its next
frames and ends when the device has finished them (a synchronize), and the
next starts at once, until `seconds` have passed. Rates are all the frames
over all the window; tails are over every frame. With `trace`, the first
`trace_steps` steps of the window run under the profiler and the per-layer
readers are given that trace; the end-to-end metrics are then not reported.
Once the window has closed the peak memory is read, the driver frees the
program's state and its check compares what the program produced with the
reference.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

from portbench import trace as _trace
from portbench.registry import Registry

STATS = ("rate", "p95_ms")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def worst(values) -> float:
    """The largest of the numbers, NaN where one is NaN."""
    values = list(values)
    return next((v for v in values if v != v), max(values))


def card_readings() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,"
                              "power.limit,temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _power_limit(readings: str):
    try:
        return float(readings.splitlines()[0].split(",")[4].strip().split()[0])
    except (IndexError, ValueError):
        return None


def run_cell(reg: Registry, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, cell: dict = None, cfg: dict = None) -> dict:
    """The result object of one run (see README.md); `cell` and `cfg`
    override the files (the CPU tests run cells at small sizes)."""
    device = torch.device(device)
    cell = cell if cell is not None else reg.cell(name)
    cfg = cfg if cfg is not None else reg.config(cell["config"])
    chips = next((w["chips"] for w in reg.bench["workloads"] if w["name"] == name), 1)
    e2e = reg.end_to_end(name)
    for m in e2e:
        if m["name"] != "setup_s" and cell["end_to_end"].get(m["name"]) not in STATS:
            raise KeyError(f"cell {name} gives no statistic for {m['name']}")

    drv = reg.driver(cell["driver"]).Driver(cfg, cell, seed, device)
    drv.warmup()
    _sync(device)
    setup_s = time.perf_counter() - t0

    lat, frames, view = [], 0, None

    def one_step():
        t = time.perf_counter()
        n = drv.step()
        _sync(device)
        lat.extend([time.perf_counter() - t] * n)
        return n

    if trace:
        def traced():
            n = 0
            for _ in range(int(cell["trace_steps"])):
                with torch.profiler.record_function("portbench.step"):
                    n += one_step()
            return n

        frames += (view := _trace.record(traced, drv.work())).frames
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        frames += one_step()
    elapsed = time.perf_counter() - start
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    readings = card_readings() if device.type == "cuda" else ""
    print(f"# device: {readings or device.type}; memory peak {memory_peak} B", flush=True)

    drv.finish()
    t_check = time.perf_counter()
    samples, missing = drv.check()
    check_s = time.perf_counter() - t_check
    limits = cell["limits"]
    if samples and set(samples[0]) != set(limits):
        raise KeyError(f"cell {name}: checks {sorted(samples[0])} against limits {sorted(limits)}")
    top = {k: worst(s[k] for s in samples) for k in limits} if samples else {}
    bad = sum(1 for s in samples if any(not s[k] <= limits[k] for k in limits))
    correct = missing == 0 and bool(samples) and bad == 0

    metrics = {}
    if trace:
        for m in reg.per_layer(name):
            value = reg.metric(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        stats = {"rate": frames / elapsed, "p95_ms": p95(lat) * 1e3 if lat else float("nan")}
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else stats[cell["end_to_end"][m["name"]]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": memory_peak,
           "power_limit_w": _power_limit(readings)}
    result = {"correct": correct, "attempted": frames, "failed": bad + missing,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
        _write_trace_summary(reg, name, seed, result, readings, view)
    result["checks"] = {k: {"value": top.get(k), "limit": limits[k]} for k in limits}
    for d in getattr(drv, "diagnostics", []):
        print(f"# check reading, not compared: {json.dumps(d)}", file=sys.stderr)
    print(f"# check: {len(samples)} samples compared in {check_s:.3f} s, {bad} failed, "
          f"{missing} never came", file=sys.stderr)
    for k in limits:
        print(f"check {k} = {top.get(k)} (limit {limits[k]})", file=sys.stderr)
    sys.stderr.flush()
    return result


def _write_trace_summary(reg, name, seed, result, readings, view) -> None:
    out = reg.root / "build" / "portbench"
    out.mkdir(parents=True, exist_ok=True)
    summary = {"workload": name, "seed": seed, "device": result["device"], "card": readings,
               "frames": view.frames, "breakdown": result["breakdown"],
               "metrics": result["metrics"]}
    (out / f"trace_{name}.json").write_text(json.dumps(summary, indent=1))
