"""Per-stage timing and torch.profiler integration (twin of
recon3d_tpu/utils/profiling.py).

- StageTimer: named per-stage wall timing; `sync(out)` waits for the
  device work that produces `out`, so a stage's clock covers the device
  time and not only the enqueue (PyTorch's CUDA calls return before the
  card has finished), and a summary table;
- trace(): torch.profiler around a region, written as a Chrome / Perfetto
  trace (TensorBoard's PyTorch profiler plugin or ui.perfetto.dev);
- annotate(): the port's one span. With no profiler session running it
  costs one check; under a session it is a named range on that trace and
  its calls, host time and stream time add up in a table per name
  (`span_totals()`, `reset_spans()`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


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
        """Times the block; under a profiler session it is also the span
        `annotate(name)`."""
        t0 = time.perf_counter()
        try:
            with annotate(name):
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
    profiler (its key_averages() sum the region by operator / kernel). The
    span table starts empty, so span_totals() in or after the region holds
    the region's spans."""
    reset_spans()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(logdir)
    with torch.profiler.profile(activities=acts, on_trace_ready=handler) as prof:
        yield prof
    if with_perfetto:
        newest = max(glob.glob(os.path.join(logdir, "*.pt.trace.json")), key=os.path.getmtime)
        print(f"trace written to {newest}: open it at ui.perfetto.dev", flush=True)


class _Totals:
    """The spans of one name: calls, host seconds, the resolved stream ms
    (None until an event pair is recorded), the start / end event pairs not
    yet resolved, and the enclosing span of its first call."""

    __slots__ = ("calls", "host_s", "stream_ms", "pending", "parent")

    def __init__(self, parent: Optional[str]) -> None:
        self.calls = 0
        self.host_s = 0.0
        self.stream_ms: Optional[float] = None
        self.pending: List[tuple] = []
        self.parent = parent

    def resolve(self, wait: bool) -> None:
        """Adds the pending pairs' elapsed ms: all of them (waiting for the
        device), or only those whose end the device has passed."""
        done = 0
        for start, end in self.pending:
            if not wait and not end.query():
                break
            end.synchronize()
            self.stream_ms += start.elapsed_time(end)
            done += 1
        del self.pending[:done]


_SPANS: Dict[str, _Totals] = {}
_LOCK = threading.Lock()
_OPEN = threading.local()  # .stack: the names of this thread's open spans
_PENDING_MAX = 256  # resolve finished pairs beyond this many, without waiting


def _open_spans() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _event(stream):
    """A timing event recorded on `stream`."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class annotate:
    """A named span: `with annotate("sgm.aggregate"): ...`.

    With no profiler session running (torch.profiler, trace(),
    torch.autograd.profiler.emit_nvtx()) it returns at once: no
    record_function, no NVTX call, no CUDA event. Under a session it is a
    `record_function` range, so it lands in the trace on the clock of the
    card's kernels (emit_nvtx() turns such ranges into NVTX ranges for
    Nsight), and the span's calls, host seconds between its edges, stream
    ms between a pair of timing events on the current stream (where CUDA is
    initialised) and the enclosing span of this thread add up under its
    name (span_totals()). Spans opened on another thread have no parent
    from this one. torch.profiler sees the thread that started it and
    PyTorch's own threads: a span on another Python thread (a capture
    thread) counts only under a session that thread sees.
    """

    __slots__ = ("name", "_range", "_parent", "_stream", "_start", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = None

    def __enter__(self) -> "annotate":
        if not _profiler_enabled():
            return self
        stack = _open_spans()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        # the stream is looked up once: it costs as much as an event record
        self._stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None
        self._start = None if self._stream is None else _event(self._stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is None:
            return False
        host_s = time.perf_counter() - self._t0
        end = None if self._start is None else _event(self._stream)
        self._range.__exit__(*exc)
        self._range = None
        _open_spans().pop()
        with _LOCK:
            tot = _SPANS.get(self.name)
            if tot is None:
                tot = _SPANS[self.name] = _Totals(self._parent)
            tot.calls += 1
            tot.host_s += host_s
            if end is not None:
                tot.stream_ms = tot.stream_ms or 0.0
                tot.pending.append((self._start, end))
                if len(tot.pending) > _PENDING_MAX:
                    tot.resolve(wait=False)
        return False


def span_totals() -> Dict[str, dict]:
    """{name: {"calls", "host_ms", "stream_ms", "parent"}} of the spans
    closed under a profiler session since the last reset_spans(). host_ms
    is the time the host spent between the span's edges (under the
    profiler, an upper bound of the program's enqueue time); stream_ms the
    time between its start and end events on the stream, how long the stage
    held the card, idle inside it included (None where no event was
    recorded: CPU runs). parent is the span that enclosed the name's first
    call on its thread (None for a root). Waits for the device's pending
    spans."""
    with _LOCK:
        out = {}
        for name, tot in _SPANS.items():
            tot.resolve(wait=True)
            out[name] = {"calls": tot.calls, "host_ms": tot.host_s * 1e3,
                         "stream_ms": tot.stream_ms, "parent": tot.parent}
        return out


def reset_spans() -> None:
    """Empties the span table."""
    with _LOCK:
        _SPANS.clear()
