"""The per-layer readers of the program's spans (source `program_span`): each
reads recon3d_tpu_torch.utils.profiling.span_totals() a traced frame, and is
silent (None) where the program has no span table (a commit before it), where
its span never ran, or, for stream times, where no event timed it (the CPU).
A small traced cell on the CPU prints the host-time readers."""
import time
import types

import pytest
import torch

from portbench.harness import run_cell
from portbench.registry import Registry
from portbench.tests.small_cells import small
from recon3d_tpu_torch.utils import profiling


def _span(host_ms, stream_ms, parent=None, calls=4):
    return {"calls": calls, "host_ms": host_ms, "stream_ms": stream_ms, "parent": parent}


DEPTH = {
    "depth.process": _span(40.0, 36.0),
    "pointcloud.backproject": _span(4.0, 2.0),
    "depth.rectify": _span(1.0, 0.8, "depth.process"),
    "depth.sgm": _span(20.0, 22.0, "depth.process"),
    "sgm.aggregate": _span(8.0, 16.0, "depth.sgm"),
    "sgm.speckle": _span(10.0, 6.0, "depth.sgm"),
    "depth.wls": _span(6.0, 4.0, "depth.process"),
    "depth.output": _span(2.0, 1.0, "depth.process"),
}
FUSION = {
    "tsdf.integrate": _span(60.0, 112.0),
    "tsdf.project": _span(30.0, 40.0, "tsdf.integrate"),
    "tsdf.sample": _span(5.0, 4.0, "tsdf.integrate"),
}
FRAMES = 4
# reader: (planted table, the value it reads a frame, the span whose absence silences it)
READERS = {
    "depth.host_ms": (DEPTH, (40.0 + 4.0) / FRAMES, None),
    "rectify.span_ms": (DEPTH, 0.8 / FRAMES, "depth.rectify"),
    "sgm.span_ms": (DEPTH, 16.0 / FRAMES, "sgm.aggregate"),
    "speckle.span_ms": (DEPTH, 6.0 / FRAMES, "sgm.speckle"),
    "wls.span_ms": (DEPTH, 4.0 / FRAMES, "depth.wls"),
    "fusion.host_ms": (FUSION, 60.0 / FRAMES, None),
    "integrate.project_ms": (FUSION, 40.0 / FRAMES, "tsdf.project"),
    "integrate.sample_ms": (FUSION, 4.0 / FRAMES, "tsdf.sample"),
    "integrate.update_ms": (FUSION, (112.0 - 40.0 - 4.0) / FRAMES, "tsdf.sample"),
}
for _twin in ("depth.host_ms", "sgm.span_ms", "speckle.span_ms", "wls.span_ms"):
    READERS[_twin + ".batch"] = READERS[_twin]
VIEW = types.SimpleNamespace(frames=FRAMES)


@pytest.fixture(scope="module")
def reg():
    return Registry()


def _plant(monkeypatch, table):
    monkeypatch.setattr(profiling, "span_totals", lambda: {k: dict(v) for k, v in table.items()})


def test_every_span_reader_is_in_the_benchmark(reg):
    spans = {m["name"] for m in reg.bench["per_layer"] if m["source"] == "program_span"}
    assert spans == set(READERS)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_a_frame_of_the_planted_table(reg, monkeypatch, name):
    table, want, _ = READERS[name]
    _plant(monkeypatch, table)
    assert reg.metric(name).read(VIEW) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_without_the_span_table(reg, monkeypatch, name):
    monkeypatch.delattr(profiling, "span_totals")
    assert reg.metric(name).read(VIEW) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_where_its_span_never_ran(reg, monkeypatch, name):
    table, _, span = READERS[name]
    _plant(monkeypatch, {} if span is None else {k: v for k, v in table.items() if k != span})
    assert reg.metric(name).read(VIEW) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_stream_readers_are_silent_on_the_cpu(reg, monkeypatch, name):
    table, want, _ = READERS[name]
    _plant(monkeypatch, {k: dict(v, stream_ms=None) for k, v in table.items()})
    value = reg.metric(name).read(VIEW)
    assert value == (pytest.approx(want) if ".host_ms" in name else None)


@pytest.mark.parametrize("name", ["stereo1080.stream", "rgbd640.integrate"])
def test_a_small_traced_cell_prints_its_host_time(reg, name):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell, cfg = small(reg, name)
        profiling.reset_spans()
        res = run_cell(reg, name, 2 ** 31 + 7, 0.2, True, "cpu", time.perf_counter(),
                       cell=cell, cfg=cfg)
    finally:
        torch.set_num_threads(n)
        profiling.reset_spans()
    host = "depth.host_ms" if name.startswith("stereo") else "fusion.host_ms"
    assert res["correct"] and res["metrics"][host]["value"] > 0
    spans = {m["name"] for m in reg.per_layer(name) if m["source"] == "program_span"}
    assert spans & set(res["metrics"]) == {host}  # stream times are the card's
