"""utils/profiling.py and the timing half of utils/logging.py on the CPU: the
mirror of tests/test_pipelines.py's test_stage_timer_summary, the sync of a
nest of CPU tensors (nothing to wait for), and trace / annotate /
torch_trace writing a Chrome trace that holds the annotated region."""
import glob
import json
import os

import torch

from recon3d_tpu_torch.utils import logging as rlog
from recon3d_tpu_torch.utils import profiling


def test_stage_timer_summary():
    t = profiling.StageTimer()
    with t.stage("a"):
        x = torch.arange(8) * 2
        t.sync(x)
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    s = t.summary()
    assert "a" in s and "b" in s
    assert t.counts["a"] == 2 and t.totals["a"] > 0
    t.reset()
    assert not t.totals and not t.counts


def test_sync_walks_nests_and_skips_cpu_tensors():
    from recon3d_tpu_torch.utils.types import RGBDImage

    nest = ((torch.ones(3), [torch.zeros(2)]), RGBDImage(torch.ones(2, 2, 3), torch.ones(2, 2)))
    assert len(list(profiling._tensors(nest))) == 4
    profiling.StageTimer().sync(nest)  # CPU tensors: returns at once
    profiling.StageTimer().sync(None)


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_and_annotate_write_a_chrome_trace(tmp_path, capsys):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir, with_perfetto=True) as prof:
        with profiling.annotate("fuse_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    assert any(e.get("name") == "fuse_region" for e in _events(files[0]))
    assert any(k.key == "fuse_region" for k in prof.key_averages())
    assert files[0] in capsys.readouterr().out


def test_logging_stage_timer_and_torch_trace(tmp_path):
    t = rlog.StageTimer()
    with t.stage("integrate"):
        pass
    with t.stage("integrate"):
        pass
    assert rlog.StageTimer is profiling.StageTimer
    assert t.counts["integrate"] == 2
    row = next(r for r in t.summary().splitlines() if r.startswith("integrate"))
    assert row.split()[2] == "2"
    with rlog.torch_trace(None):  # no directory: no trace
        pass
    with rlog.torch_trace(str(tmp_path)):
        with profiling.annotate("odometry"):
            torch.ones(4).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1 and any(e.get("name") == "odometry" for e in _events(files[0]))
