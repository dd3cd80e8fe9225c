"""utils/profiling.annotate, the port's one span, and the spans at the stage
boundaries of the four entries the benchmark drives.

With no profiler session running a span is one check: no record_function,
no CUDA event, nothing in the span table. Under torch.profiler it is a
range of the Chrome trace and adds its calls, host ms, stream ms (None on
the CPU) and parent to span_totals(). The entries (DepthPipeline.process
on the kernel path's plain versions, batched_depth on a 2-shard in-process
mesh, tsdf.integrate, integrate_frames_exact on 2 shards) emit their span
trees and compute the same bits with the profiler on as off.
"""
import json
import threading

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.calib import stereo
from recon3d_tpu_torch.calib.npz import StereoParams
from recon3d_tpu_torch.camera.fake import FakeStereoCamera
from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.depth import DepthPipeline
from recon3d_tpu_torch.fusion import tsdf
from recon3d_tpu_torch.parallel import batch, fusion
from recon3d_tpu_torch.parallel.mesh import make_mesh
from recon3d_tpu_torch.utils import profiling
from recon3d_tpu_torch.utils.profiling import annotate, span_totals
from recon3d_tpu_torch.utils.types import CameraIntrinsics

W, H, D = 128, 48, 16
MCFG = StereoMatcherConfig(num_disparities=D, block_size=5, speckle_window_size=20,
                           backend="cuda")
WCFG = WLSConfig(iterations=2)
INTR = CameraIntrinsics(fx=70.0, fy=70.0, cx=39.5, cy=29.5)
R_VOL = 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """2 torch threads: the suite runs six workers on a shared host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _parents():
    return {name: s["parent"] for name, s in span_totals().items()}


def _untimed(span):
    """Stream ms is None where CUDA is not initialised (CPU runs); elsewhere
    the events time the current stream even for CPU work."""
    return (span["stream_ms"] is None) == (not torch.cuda.is_initialized())


def _pipeline():
    K1 = np.array([[80.0, 0.0, W / 2 + 1.5], [0.0, 80.5, H / 2 - 1.0], [0, 0, 1]], np.float32)
    K2 = np.array([[79.0, 0.0, W / 2 - 2.0], [0.0, 79.5, H / 2 + 0.5], [0, 0, 1]], np.float32)
    dist = np.array([[-0.05, 0.01, 0.0, 0.0, 0.0]], np.float32)
    R = np.eye(3, dtype=np.float32)
    T = np.array([[-0.05], [0.0005], [0.0]], np.float32)
    rect = stereo.stereo_rectify(K1, dist, K2, dist, (W, H), R, T, device="cpu")
    params = StereoParams(mtx1=K1, dist1=dist, mtx2=K2, dist2=dist, R=R, T=T,
                          **{k: v.numpy() for k, v in rect._asdict().items()})
    pipe = DepthPipeline(params, (W, H), MCFG, WCFG, device="cpu")
    assert pipe.plans is not None
    return pipe


def _gray_pairs(n):
    cam = FakeStereoCamera(width=W, height=H, focal=80.0, baseline=0.05)
    pairs = [cam.render(k)[:2] for k in range(n)]
    return (torch.tensor(np.stack([p[0] for p in pairs]), dtype=torch.float32),
            torch.tensor(np.stack([p[1] for p in pairs]), dtype=torch.float32))


def _frames(n):
    """n posed 60x80 frames of a tilted plane 0.4-0.6 m away, seen from
    cameras shifted along x, with colour."""
    g = torch.Generator().manual_seed(3)
    v, u = torch.meshgrid(torch.arange(60.0), torch.arange(80.0), indexing="ij")
    depths = torch.stack([0.45 + 0.002 * u + 0.001 * v + 0.01 * k for k in range(n)])
    colors = torch.randint(0, 256, (n, 60, 80, 3), generator=g, dtype=torch.uint8)
    exts = torch.eye(4).repeat(n, 1, 1)
    exts[:, 0, 3] = torch.arange(n) * 0.01
    return depths, colors, exts


def _volume():
    return tsdf.make_volume(R_VOL, voxel_size=0.6 / R_VOL, sdf_trunc=0.05,
                            origin=(-0.3, -0.3, 0.2), device="cpu")


def _run_depth():
    pipe = _pipeline()
    ls, rs = _gray_pairs(1)
    return pipe.process(ls[0], rs[0])


def _run_batch():
    ls, rs = _gray_pairs(2)
    return batch.batched_depth(ls, rs, make_mesh(2, ("frame",), device="cpu"), MCFG, WCFG)


def _run_integrate():
    d, c, e = _frames(1)
    v = tsdf.integrate(_volume(), d[0], INTR, e[0], color=c[0], depth_trunc=1.0)
    return v.tsdf, v.weight, v.color


def _run_integrate_exact():
    d, c, e = _frames(2)
    v = fusion.integrate_frames_exact(_volume(), d, e, INTR,
                                      make_mesh(2, ("frame",), device="cpu"), colors=c,
                                      depth_trunc=1.0)
    return v.tsdf, v.weight, v.color


ENTRIES = {
    "depth": (_run_depth, {
        "depth.process": None, "depth.rectify": "depth.process", "depth.sgm": "depth.process",
        "sgm.aggregate": "depth.sgm", "sgm.speckle": "depth.sgm", "depth.wls": "depth.process",
        "depth.output": "depth.process"}),
    "batch": (_run_batch, {
        "batch.depth": None, "depth.sgm": "batch.depth", "sgm.aggregate": "depth.sgm",
        "sgm.speckle": "depth.sgm", "depth.wls": "batch.depth"}),
    "integrate": (_run_integrate, {
        "tsdf.integrate": None, "tsdf.project": "tsdf.integrate",
        "tsdf.sample": "tsdf.integrate"}),
    "integrate_exact": (_run_integrate_exact, {
        "fusion.integrate_exact": None, "fusion.weights": "fusion.integrate_exact",
        "fusion.affine": "fusion.integrate_exact", "tsdf.project": "fusion.weights",
        "tsdf.sample": "fusion.weights"}),
}
CALLS = {"batch": {"batch.depth": 1, "depth.sgm": 2, "depth.wls": 2},
         "integrate_exact": {"fusion.integrate_exact": 1, "tsdf.project": 4, "tsdf.sample": 4}}


@pytest.fixture(scope="module")
def entry_runs():
    """Each entry once without and once under the profiler: (the outputs
    of both, the span table of the traced run)."""
    runs = {}
    for name, (fn, _) in ENTRIES.items():
        profiling.reset_spans()
        plain = fn()
        assert span_totals() == {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            traced = fn()
        runs[name] = (plain, traced, span_totals())
    profiling.reset_spans()
    return runs


def test_no_profiler_no_range_no_event_no_table(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    with annotate("outer"):
        with annotate("inner"):
            x = torch.ones(4).sum()
    assert float(x) == 4.0
    assert span_totals() == {}
    assert not profiling._open_spans()


def test_nested_spans_under_the_profiler(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with annotate("outer"):
                torch.ones(32, 32).sum()
                with annotate("inner"):
                    (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
                with annotate("inner"):
                    torch.zeros(8).add_(1)
    tot = span_totals()
    assert set(tot) == {"outer", "inner"}
    assert tot["outer"]["calls"] == 3 and tot["inner"]["calls"] == 6
    assert tot["outer"]["parent"] is None and tot["inner"]["parent"] == "outer"
    assert tot["inner"]["host_ms"] > 0 and tot["outer"]["host_ms"] >= tot["inner"]["host_ms"]
    assert _untimed(tot["outer"]) and _untimed(tot["inner"])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {n: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                        if e.get("name") == n and e.get("ph") == "X")
              for n in ("outer", "inner")}
    assert len(ranges["outer"]) == 3 and len(ranges["inner"]) == 6
    for a, b in ranges["inner"]:
        assert sum(1 for o0, o1 in ranges["outer"] if o0 <= a and b <= o1) == 1


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_emits_its_span_tree(entry_runs, entry):
    _, _, totals = entry_runs[entry]
    assert {n: s["parent"] for n, s in totals.items()} == ENTRIES[entry][1]
    assert all(s["calls"] >= 1 and s["host_ms"] > 0 and _untimed(s) for s in totals.values())
    for name, calls in CALLS.get(entry, {}).items():
        assert totals[name]["calls"] == calls, name


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_is_bitwise_the_same_under_the_profiler(entry_runs, entry):
    plain, traced, _ = entry_runs[entry]
    a, b = list(profiling._tensors(plain)), list(profiling._tensors(traced))
    assert len(a) == len(b) >= 2
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_stage_timer_stage_opens_a_span():
    t = profiling.StageTimer()
    with t.stage("quiet"):
        pass
    assert span_totals() == {} and t.counts["quiet"] == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with t.stage("odometry"):
            with annotate("odometry.solve"):
                torch.ones(4).sum()
    assert _parents() == {"odometry": None, "odometry.solve": "odometry"}
    assert t.counts["odometry"] == 1


def test_span_on_another_thread_has_no_parent_from_this_one(monkeypatch):
    """torch.profiler sees only the thread that started it (and PyTorch's
    own threads), so a session that sees both threads is stood in for."""
    def capture():
        with annotate("capture"):
            pass

    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    with annotate("main.stage"):
        worker = threading.Thread(target=capture)
        worker.start()
        worker.join()
        with annotate("main.inner"):
            pass
    assert _parents() == {"main.stage": None, "main.inner": "main.stage", "capture": None}


def test_a_raising_span_closes_and_trace_resets_the_table(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with annotate("fails"):
                raise ValueError("inside")
        with annotate("after"):
            pass
    assert _parents() == {"fails": None, "after": None}
    assert span_totals()["fails"]["calls"] == 1 and not profiling._open_spans()
    with profiling.trace(str(tmp_path)):
        assert span_totals() == {}
        with annotate("region"):
            pass
    assert set(span_totals()) == {"region"}
    profiling.reset_spans()
    assert span_totals() == {}


@pytest.mark.cuda
def test_stream_ms_times_the_card():
    """On the card a span's stream ms is the time between its events: a
    span around a device sleep reads what a pair of events just outside it
    reads, and its host ms far less (the sleep is queued, not waited for).
    Pairs past the pending limit are resolved as they finish."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: stream time is read from CUDA events")
    x = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    outer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.profiler.profile():
        for _ in range(profiling._PENDING_MAX + 2):
            with annotate("tiny"):
                x.add_(1)
        outer[0].record()
        with annotate("sleep"):
            torch.cuda._sleep(50_000_000)
        outer[1].record()
    tot = span_totals()
    assert tot["tiny"]["calls"] == profiling._PENDING_MAX + 2
    assert 0 < tot["tiny"]["stream_ms"] < 100
    assert float(x) == profiling._PENDING_MAX + 3
    around = outer[0].elapsed_time(outer[1])
    assert 5 < tot["sleep"]["stream_ms"] <= around < tot["sleep"]["stream_ms"] + 1.0
    assert tot["sleep"]["host_ms"] < tot["sleep"]["stream_ms"]
