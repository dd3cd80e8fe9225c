"""Per-stage timing and torch.profiler integration (twin of
recon3d_tpu/utils/profiling.py).

- StageTimer: named per-stage wall timing; `sync(out)` waits for the
  device work that produces `out`, so a stage's clock covers the device
  time and not only the enqueue (PyTorch's CUDA calls return before the
  card has finished), and a summary table;
- trace(): torch.profiler around a region, written as a Chrome / Perfetto
  trace (TensorBoard's PyTorch profiler plugin or ui.perfetto.dev);
- annotate(): a named range on that trace, and an NVTX range on CUDA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


def _tensors(x) -> Iterator[torch.Tensor]:
    """The tensors in a nest of tuples, lists and dataclasses."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _sync(x) -> None:
    """Wait for the work queued on the current stream of every CUDA device
    that holds a tensor of `x`; nothing for CPU tensors (they are ready)."""
    devices = {t.device for t in _tensors(x) if t.is_cuda}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class StageTimer:
    """Accumulates wall time per named stage.

    timer = StageTimer()
    with timer.stage("sgm"):
        out = step(x)
        timer.sync(out)     # make asynchronous launches visible to the clock
    print(timer.summary())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def sync(self, out) -> None:
        _sync(out)

    def summary(self) -> str:
        rows = ["stage                      total_ms   calls   ms/call"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name] * 1e3, self.counts[name]
            rows.append(f"{name:<26} {t:9.1f} {n:7d} {t / max(n, 1):9.2f}")
        return "\n".join(rows)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(logdir: str, with_perfetto: bool = False) -> Iterator[torch.profiler.profile]:
    """torch.profiler around a region (host ops, and the card's kernels when
    CUDA is available), written to `logdir` as a `*.pt.trace.json` Chrome
    trace on exit. View it with TensorBoard's PyTorch profiler plugin or
    ui.perfetto.dev; with_perfetto prints the file to open there. Yields the
    profiler (its key_averages() sum the region by operator / kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(logdir)
    with torch.profiler.profile(activities=acts, on_trace_ready=handler) as prof:
        yield prof
    if with_perfetto:
        newest = max(glob.glob(os.path.join(logdir, "*.pt.trace.json")), key=os.path.getmtime)
        print(f"trace written to {newest}: open it at ui.perfetto.dev", flush=True)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (shows up on the profiler timeline, and as
    an NVTX range for CUDA tools)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
