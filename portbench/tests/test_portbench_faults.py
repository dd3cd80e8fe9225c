"""A run of each cell with its timed path broken underneath comes out not
correct: for each fault the cell can have, the harness (past its look for
a card) drives set-up, the window and the check at the CPU sizes of
small_cells.py."""
import dataclasses
import time

import pytest
import torch

import recon3d_tpu_torch.depth.sgm_cuda as sgm_cuda
import recon3d_tpu_torch.depth.wls_cuda as wls_cuda
import recon3d_tpu_torch.fusion.tsdf as tsdf
import recon3d_tpu_torch.parallel.batch as batch
import recon3d_tpu_torch.parallel.fusion as pfusion
from recon3d_tpu_torch.parallel.mesh import Mesh, make_mesh
from portbench.harness import run_cell
from portbench.registry import Registry
from portbench.tests.small_cells import small


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name):
    reg = Registry()
    cell, cfg = small(reg, name)
    return run_cell(reg, name, 2 ** 31 + 99, 6.0, False, "cpu", time.perf_counter(), cell=cell,
                    cfg=cfg)


def _altered_wls(monkeypatch):
    orig = wls_cuda.wls_refine_cuda
    monkeypatch.setattr(wls_cuda, "wls_refine_cuda", lambda *a, **k: orig(*a, **k) + 1.0)


def _altered_sgm(monkeypatch):
    orig = sgm_cuda.sgm_disparity_cuda

    def shifted(*a, **k):
        d, v = orig(*a, **k)
        return torch.where(v, d + 1.0, d), v

    monkeypatch.setattr(sgm_cuda, "sgm_disparity_cuda", shifted)


def _half_batch(monkeypatch):
    orig = batch.batched_depth

    def half(lefts, rights, mesh, *a, **k):
        n = lefts.shape[0] // 2
        d, v, mean = orig(lefts[:n], rights[:n], make_mesh(mesh.n // 2, device=mesh.device), *a,
                          **k)
        return torch.cat([d, d]), torch.cat([v, v]), mean

    monkeypatch.setattr(batch, "batched_depth", half)


def _no_psum(monkeypatch):
    monkeypatch.setattr(Mesh, "psum", lambda self, xs: next(iter(xs.values())))


def _unchanged_state(monkeypatch, module, attr):
    monkeypatch.setattr(module, attr, lambda vol, *a, **k: vol)


def _altered_volume(monkeypatch, module, attr):
    orig = getattr(module, attr)

    def altered(*a, **k):
        v = orig(*a, **k)
        return dataclasses.replace(v, tsdf=torch.where(v.weight > 0, v.tsdf + 0.01, v.tsdf))

    monkeypatch.setattr(module, attr, altered)


def _half_backlog(monkeypatch):
    orig = pfusion.integrate_frames_exact

    def half(vol, depths, exts, intr, mesh, colors=None, **k):
        n = depths.shape[0] // 2
        return orig(vol, depths[:n], exts[:n], intr, make_mesh(mesh.n // 2, device=mesh.device),
                    colors=None if colors is None else colors[:n], **k)

    monkeypatch.setattr(pfusion, "integrate_frames_exact", half)


def _no_gather(monkeypatch):
    def own_only(self, xs):
        first = xs[min(xs)]
        return [first] + [torch.zeros_like(first) for _ in range(self.n - 1)]

    monkeypatch.setattr(Mesh, "all_gather", own_only)


FAULTS = {
    "stream.answer_altered": ("stereo1080.stream", _altered_wls),
    "replay4.half_batch": ("stereo1080.replay4", _half_batch),
    "replay4.exchange_left_out": ("stereo1080.replay4", _no_psum),
    "replay4.answer_altered": ("stereo1080.replay4", _altered_sgm),
    "integrate.state_unchanged": ("rgbd640.integrate",
                                  lambda mp: _unchanged_state(mp, tsdf, "integrate")),
    "integrate.answer_altered": ("rgbd640.integrate",
                                 lambda mp: _altered_volume(mp, tsdf, "integrate")),
    "backlog4.state_unchanged": ("rgbd640.backlog4",
                                 lambda mp: _unchanged_state(mp, pfusion,
                                                             "integrate_frames_exact")),
    "backlog4.half_batch": ("rgbd640.backlog4", _half_backlog),
    "backlog4.exchange_left_out": ("rgbd640.backlog4", _no_gather),
    "backlog4.answer_altered": ("rgbd640.backlog4",
                                lambda mp: _altered_volume(mp, pfusion, "integrate_frames_exact")),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    name, plant = FAULTS[fault]
    plant(monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0
