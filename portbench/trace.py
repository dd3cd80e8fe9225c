"""Device trace of a few steps of the window, and what readers take from it.

`record` runs the given steps under torch.profiler (host operators and
the card's activity), exports the Chrome trace to a temporary directory,
reads it back and deletes it. The traced window is the benchmark's own
span around the steps; every step ends in a synchronize, so the device
work of the steps lies inside it. `TraceView` holds the device operations
(kernels, copies and fills) inside that window and is what the per-layer
readers in metrics/ are given.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import shutil
import tempfile
from collections import defaultdict
from pathlib import Path

KERNELS = Path(__file__).resolve().parent / "kernels"
WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def layer_kernels(layer: str = None) -> frozenset:
    """The bare names of the port's kernels of one layer, or of every layer,
    from the files kernels/*.json ({"layer": ..., "kernels": [...]}). A
    layer's kernels may be spread over several files, so a kernel that a
    change adds comes with a file of its own."""
    names = set()
    for path in sorted(KERNELS.glob("*.json")):
        table = json.loads(path.read_text())
        if layer is None or table["layer"] == layer:
            names.update(table["kernels"])
    return frozenset(names)


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)", "anon")
    cut = n.find("(")
    return (n[:cut] if cut > 0 else n)[:160]


def base_name(name: str) -> str:
    """A kernel's bare name: no namespace, template arguments or signature."""
    n = short_name(name)
    cut = n.find("<")
    n = n[:cut] if cut > 0 else n
    return n.rsplit("::", 1)[-1]


@dataclasses.dataclass
class TraceView:
    ops: list  # (name, cat, start_s, dur_s) of the device operations in the window
    frames: int  # frames the traced steps completed
    window_s: float
    busy_s: float
    work: dict  # the driver's least work of a frame, by stage
    gaps: list  # (host operation, seconds) of the device's idle gaps

    def kernel_ms(self, names) -> float:
        """Device ms a frame of the kernels whose bare name is in `names`."""
        names = set(names)
        s = sum(d for n, c, _, d in self.ops if c == "kernel" and base_name(n) in names)
        return s * 1e3 / self.frames

    def other_kernel_ms(self, names) -> float:
        """Device ms a frame of the kernels whose bare name is not in `names`."""
        names = set(names)
        s = sum(d for n, c, _, d in self.ops if c == "kernel" and base_name(n) not in names)
        return s * 1e3 / self.frames

    def device_ms(self) -> float:
        """Device ms a frame of every kernel, copy and fill."""
        return sum(d for *_, d in self.ops) * 1e3 / self.frames

    def launches_per_frame(self) -> float:
        return len(self.ops) / self.frames

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(float)
        for n, _, _, d in self.ops:
            by_op[short_name(n)] += d
        by_gap = defaultdict(float)
        for n, s in self.gaps:
            by_gap[n] += s
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_at(host, starts, t, look=400):
    """The innermost host operation running at time t: the shortest of those
    that start among the `look` latest before t and end after it."""
    i = bisect.bisect_right(starts, t)
    inner = [h for h in host[max(0, i - look):i] if h[1] >= t]
    return min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host: outside any operation"


def parse(events: list, frames: int, work: dict) -> TraceView:
    """A TraceView from Chrome trace events (times in microseconds)."""
    win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in DEVICE_CATS and b > w0 and a < w1:
            a, b = max(a, w0), min(b, w1)
            ops.append((e.get("name", "?"), e["cat"], a * 1e-6, (b - a) * 1e-6))
            spans.append((a, b))
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
            for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X" and "dur" in e
            and e.get("name") != WINDOW]
    host.sort()
    starts = [h[0] for h in host]
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((_host_at(host, starts, 0.5 * (a + t)), (a - t) * 1e-6))
        t = max(t, b)
    return TraceView(ops=ops, frames=frames, window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                     work=work, gaps=gaps)


def record(run_steps, work: dict) -> TraceView:
    """Trace run_steps() (which returns the frames it completed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            frames = run_steps()
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return parse(events, frames, work)
