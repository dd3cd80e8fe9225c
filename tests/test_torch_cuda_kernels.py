"""On-card checks of the port's kernels against their plain versions at
shapes chip_smoke.py does not drive: the fused warp (K1, one launch a
remap) and its one-pass form on unaligned shapes and at 1080p with taps
that wrap, D = 256, wide and
tall volumes (K5 and K11's helix walkers wrapping round three times), 3, 4
and 8 directions, a nonzero min_disparity, K2 at block sizes 1 to 11 with and
without its downward path, K6 on ragged and clamped planes (bitwise),
DepthPipeline on the card against
itself on the CPU, backend 'auto' on the card, K7 (bitwise, overflow
included) and K8 (bitwise, both variants) on small grids, on hand-made
tables (holes between occupied slots, empty, full), at C = 1 to 32 with
edge tiles and at scan_post's sparse G = 128, the grid
normals on the card against the CPU, K9 on any shape, the TSDF fuse
kernel against fusion/tsdf.py's plain path on the card (bitwise: both modes,
uint8, float32 and no color, empty and partly fused volumes, voxels behind
the camera and near z = 0, integrate_frames and the sharded exact
integrate, R = 256 and R not a multiple of 4), the fusion and
meshing slice on the card against the CPU (bitwise), K10-K12 on small
shards (both directions, dead rows below h_real, the public mirrors leaving
acc as it was), K5 and K11 identical over ten launches, the public
aggregate_and_finalize leaving v1 as it was and its fuse_bwd variant (K3
then K4), K4 and K12 bitwise over
their options (D = 16 / 160 / 256, flat, clamped and 320-row volumes), the
row-sharded frame on
the card against the single-device kernel path and batched_depth against
compute_disparity. A CUDA kernel has no
CPU mode, so these tests are marked `cuda` and skip without a card. On a
machine with one (no JAX needed):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_kernels.py

All SGM arithmetic is integer-valued f32 and the warp reproduces one
rounding per operation, so kernel and plain version agree bitwise; the
disparity bar is the SGM one, valid equal and |delta| < 1e-4.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from tests import _grid_tables
from recon3d_tpu_torch.camera.fake import FakeStereoCamera, SyntheticRGBDCamera
from recon3d_tpu_torch.config import StereoMatcherConfig
from recon3d_tpu_torch.depth import (DepthPipeline, compute_disparity, sgm_cuda, sgm_sharded,
                                     wls_cuda)
from recon3d_tpu_torch.fusion import marching, tsdf
from recon3d_tpu_torch.mesh import ops as mesh_ops
from recon3d_tpu_torch.ops import (grid_knn, grid_knn_cuda, project_sample, project_sample_cuda,
                                   tsdf_fuse_cuda, warp)
from recon3d_tpu_torch.parallel import fusion as pfusion
from recon3d_tpu_torch.parallel import batch
from recon3d_tpu_torch.parallel.mesh import make_mesh
from recon3d_tpu_torch.pointcloud import normals
from recon3d_tpu_torch.utils.types import CameraIntrinsics, PointCloud

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _pair(H, W, seed=1):
    gl, gr, _, _ = FakeStereoCamera(width=W, height=H, focal=0.6 * W,
                                    baseline=0.05).render(seed)
    return gl.astype(np.float32), gr.astype(np.float32)


@pytest.mark.parametrize("H,W,shift", [(61, 133, 0.0), (64, 256, 20.0), (200, 96, -7.5)])
def test_k1_matches_plain_on_any_shape(dev, H, W, shift):
    """The fused K1 (one launch a remap) and its one-pass form, on odd
    shapes (the scalar path) and aligned ones."""
    mx, my = chip_smoke.synthetic_maps(H, W)
    plan = warp.build_remap_plan(mx + np.float32(shift), my, device=dev)
    img = torch.rand((H, W), generator=torch.Generator().manual_seed(H), dtype=torch.float32)
    img = (img * 255).to(dev)
    before, passes = warp.remap_two_pass_cuda.launches, warp.resample_pass.launches
    out = warp.remap_two_pass_cuda(img, plan)
    torch.cuda.synchronize()
    assert warp.remap_two_pass_cuda.launches == before + 1
    assert warp.resample_pass.launches == passes
    assert torch.equal(out, warp.remap_two_pass(img, plan))
    t = warp.resample_pass(img, plan.vy, plan.v_coarse, plan.v_coarse_bits, plan.v_resid_bound, 0)
    args = (plan.hx, plan.h_coarse, plan.h_coarse_bits, plan.h_resid_bound, 1, plan.valid)
    assert torch.equal(t, warp.resample_pass_plain(img, plan.vy, plan.v_coarse,
                                                   plan.v_coarse_bits, plan.v_resid_bound, 0))
    assert torch.equal(warp.resample_pass(t, *args), warp.resample_pass_plain(t, *args))
    assert warp.resample_pass.launches == passes + 2


@pytest.mark.parametrize("shift", [0.0, 20.5, -20.5])
def test_k1_fused_matches_plain_at_1080p(dev, shift):
    """The fused K1 at the headline's 1080p plan, shifted so that the right
    or the left edge samples beyond the source (wrapped taps, masked)."""
    H, W = 1080, 1920
    mx, my = chip_smoke.synthetic_maps(H, W)
    plan = warp.build_remap_plan(mx + np.float32(shift), my, device=dev)
    rng = np.random.RandomState(3)
    img = torch.tensor((rng.rand(H, W) * 255).astype(np.float32), device=dev)
    out = warp.remap_two_pass_cuda(img, plan)
    assert torch.equal(out, warp.remap_two_pass(img, plan))
    assert bool((out[~plan.valid] == 0).all()) and float(plan.valid.float().mean()) > 0.9


@pytest.mark.parametrize("H,W,D,bs,md", [(64, 384, 16, 5, 0), (192, 128, 160, 5, 0),
                                         (192, 120, 160, 11, 3), (192, 133, 160, 11, 3),
                                         (40, 130, 32, 1, 0), (40, 130, 32, 3, 5),
                                         (72, 200, 256, 5, 2), (384, 128, 16, 5, 0),
                                         (384, 100, 256, 3, 1)])
def test_k2_k5_k14_match_plain(dev, H, W, D, bs, md):
    """K2 on a warped (non-integer) pair, with and without the downward
    path, K5 both ways (one launch a call) and K14 both scans, on wide
    volumes and tall ones (WP < HP: K5's walkers wrap round the width, three
    times at HP = 3 WP), with DP = 128 and 256, block sizes 1 to 11,
    min_disparity > 0 and widths that are not a multiple of K2's strip."""
    gl, gr = _pair(H, W)
    mx, my = chip_smoke.synthetic_maps(H, W)
    plan = warp.build_remap_plan(mx, my, device=dev)
    gl = warp.remap_two_pass_cuda(torch.tensor(gl, device=dev), plan)
    gr = warp.remap_two_pass_cuda(torch.tensor(gr, device=dev), plan)
    assert not torch.equal(gl, gl.round())
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    p1, p2 = 200.0, 3200.0
    planes = sgm_cuda.prefilter_planes(gl, gr, 63)
    cost, v1 = sgm_cuda.cost_fwd_down(gl, gr, D, md, bs, 63, p1, p2, HP, WP, DP, True,
                                      planes=planes)
    cost_q, v1_q = sgm_cuda.cost_fwd_down_plain(planes, HP, WP, DP, D, md, bs, p1, p2)
    assert torch.equal(cost, cost_q) and torch.equal(v1, v1_q)
    cost_n, v1_n = sgm_cuda.cost_fwd_down(gl, gr, D, md, bs, 63, p1, p2, HP, WP, DP, False,
                                          planes=planes)
    assert torch.equal(cost_n, cost_q)
    assert torch.equal(v1_n, sgm_cuda.cost_fwd_down_plain(planes, HP, WP, DP, D, md, bs, p1, p2,
                                                          False)[1])
    for vertical in ("down", "up"):
        before = sgm_cuda.diag_accumulate.launches
        out = sgm_cuda.diag_accumulate(cost, v1.clone(), p1, p2, vertical)
        torch.cuda.synchronize()
        assert sgm_cuda.diag_accumulate.launches == before + 1
        ref = sgm_cuda.diag_accumulate_plain(cost, v1.clone(), p1, p2, vertical)
        assert torch.equal(out, ref), vertical
    fwd = sgm_cuda.fwd_scan(cost, p1, p2)
    assert torch.equal(fwd, sgm_cuda.fwd_scan_plain(cost, p1, p2))
    assert torch.equal(fwd, v1_n)
    down = sgm_cuda.down_accumulate(cost, fwd.clone(), p1, p2)
    assert torch.equal(down, sgm_cuda.down_accumulate_plain(cost, fwd.clone(), p1, p2))
    assert torch.equal(down, v1)


def _k6_planes(n, m, axis, seed, clamp):
    """WLS-like planes of one solve along `axis`; with `clamp`, one index
    of every line has diag = wl = 0, so its den hits the 1e-12 clamp."""
    g = torch.Generator().manual_seed(seed)
    w_edge = torch.rand((n, m), generator=g) * 40.0
    w_edge.select(axis, 0).zero_()
    conf = (torch.rand((n, m), generator=g) > 0.3).to(torch.float32)
    u = torch.rand((n, m), generator=g) * 120.0
    wl, wr, diag, rhs = wls_cuda.solve_planes(w_edge, conf, u, 37.5, axis)
    if clamp:
        i = n // 2 if axis == 0 else m // 2
        wl.select(axis, i).zero_()
        diag.select(axis, i).zero_()
    return wl, wr, diag, rhs


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n,m,clamp", [(1, 7, False), (7, 1, False), (37, 65, False),
                                       (37, 65, True), (1080, 1920, False),
                                       (1088, 1920, True)])
def test_k6_matches_plain_bitwise(dev, axis, n, m, clamp):
    """K6 against its plain version on the card, bitwise: ragged tiles
    (1080 = 33 x 32 + 24 lines or steps), single-line and single-step
    planes, and lines whose den is clamped to 1e-12."""
    planes = [t.to(dev) for t in _k6_planes(n, m, axis, n * 7 + m, clamp)]
    if clamp:
        i = n // 2 if axis == 0 else m // 2
        den = planes[2].select(axis, i)
        assert bool((den == 0).all())
    before = wls_cuda.tridiag_solve.launches
    out = wls_cuda.tridiag_solve(*planes, axis)
    torch.cuda.synchronize()
    assert wls_cuda.tridiag_solve.launches == before + 1
    ref = wls_cuda.tridiag_solve_plain(*planes, axis)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("num_directions,min_disparity", [(3, 0), (4, 4), (8, 0), (8, 6)])
def test_sgm_kernel_path_matches_cpu(dev, num_directions, min_disparity):
    gl, gr = _pair(96, 256, seed=2)
    kw = dict(num_disparities=48, min_disparity=min_disparity, block_size=5, p2=3200.0,
              num_directions=num_directions)
    d_k, v_k = sgm_cuda.sgm_disparity_cuda(torch.tensor(gl, device=dev),
                                           torch.tensor(gr, device=dev), **kw)
    d_q, v_q = sgm_cuda.sgm_disparity_cuda(torch.tensor(gl), torch.tensor(gr), **kw)
    assert torch.equal(v_k.cpu(), v_q) and v_q.float().mean() > 0.5
    assert float((d_k.cpu() - d_q).abs()[v_q].max()) < 1e-4


def test_depth_pipeline_on_card_matches_cpu(dev):
    """DepthPipeline.process on the card against the same pipeline on the
    CPU (plain versions), before WLS (its float32 solve is ill-conditioned
    on textured guides, and exp() rounds otherwise on the two devices)."""
    H, W = 144, 256  # the bench rig scaled by 2 / 15
    params = chip_smoke.pipeline_rig()
    s = W / chip_smoke.W
    for K in (params.mtx1, params.mtx2):
        K[:2] *= s
    for P in (params.P1, params.P2):
        P[:2] *= s
    cfg = StereoMatcherConfig.tuned(num_disparities=32, backend="cuda")
    on_card = DepthPipeline(params, (W, H), cfg, with_wls=False, device=dev)
    on_cpu = DepthPipeline(params, (W, H), cfg, with_wls=False, device="cpu")
    assert on_card.plans is not None
    # both build their maps on the host: the same plans on either device
    for p_k, p_q in zip(on_card.plans, on_cpu.plans):
        for k in ("vy", "hx", "valid", "v_coarse", "h_coarse"):
            assert torch.equal(getattr(p_k, k).cpu(), getattr(p_q, k)), k
    left, right = _pair(H, W, seed=3)
    d_k, z_k, vis_k = on_card.process(left, right)
    d_q, z_q, vis_q = on_cpu.process(left, right)
    valid = d_q > 0
    assert torch.equal(d_k.cpu() > 0, valid) and valid.float().mean() > 0.3
    assert float((d_k.cpu() - d_q).abs()[valid].max()) < 1e-4
    assert z_k.shape == (H, W) and vis_k.shape == (H, W, 3)


def test_auto_backend_takes_the_kernel_path_on_the_card(dev):
    """backend 'auto' (the default) launches the kernels for CUDA tensors."""
    gl, gr = _pair(64, 256, seed=4)
    before = sgm_cuda.cost_fwd_down.launches
    d, v = compute_disparity(torch.tensor(gl, device=dev), torch.tensor(gr, device=dev),
                             StereoMatcherConfig(num_disparities=32), with_wls=False)
    torch.cuda.synchronize()
    assert sgm_cuda.cost_fwd_down.launches == before + 1 and d.is_cuda


def _unit_cube(n, seed, scale=1.0, device="cpu"):
    rng = np.random.RandomState(seed)
    pts = torch.tensor((rng.rand(n, 3) * scale).astype(np.float32), device=device)
    return pts, torch.tensor(rng.rand(n) > 0.05, device=device)


@pytest.mark.parametrize("n,G,C,r,scale", [(5000, 16, 8, 0.05, 0.8), (20000, 24, 16, 0.04, 0.8),
                                           (40000, 16, 4, 0.05, 0.01)])
def test_k7_matches_plain_bitwise(dev, n, G, C, r, scale):
    """K7 against its plain version on the card, the last cloud far over
    capacity (overflow > 0.99)."""
    pts, valid = _unit_cube(n, 13, scale, dev)
    before = grid_knn_cuda.pack_cells.launches
    pk, slot, ov = grid_knn_cuda.bin_points_packed_cuda(pts, valid, r, G, C)
    torch.cuda.synchronize()
    assert grid_knn_cuda.pack_cells.launches == before + 1
    pk_q, slot_q, ov_q = grid_knn._bin_points_packed(pts, valid, r, G, C)
    assert torch.equal(pk, pk_q) and torch.equal(slot, slot_q) and float(ov) == float(ov_q)
    pk_c, _, ov_c = grid_knn._bin_points_packed(pts.cpu(), valid.cpu(), r, G, C)
    assert torch.equal(pk.cpu(), pk_c) and float(ov) == float(ov_c)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,G,C,r", [(3000, 16, 8, 0.05), (60000, 20, 32, 0.05)])
def test_k8_matches_plain(dev, fused, n, G, C, r):
    """K8 against its plain version on the card: count exact, and the
    kernel adds in the plain version's order with one rounding an
    operation, so the moments and normals agree bitwise."""
    pts, valid = _unit_cube(n, 7, 0.7, dev)
    pk, _, _ = grid_knn_cuda.bin_points_packed_cuda(pts, valid, r, G, C)
    r2 = float(torch.tensor(r, dtype=torch.float32) ** 2)
    before = grid_knn_cuda.core_call.launches
    out = grid_knn_cuda.core_call(pk, r2, G, C, fused)
    torch.cuda.synchronize()
    assert grid_knn_cuda.core_call.launches == before + 1
    ref = grid_knn.core_plain(pk, r2, G, C, fused)
    cnt = 3 if fused else 0
    assert torch.equal(out[:, cnt], ref[:, cnt]) and float(out[:, cnt].max()) > 3
    assert torch.equal(out, ref), float((out - ref).abs().max())


def _k8_both(pk, G, C, r2):
    """K8's two variants on the card against core_plain, bitwise, one launch
    each."""
    for fused in (False, True):
        before = grid_knn_cuda.core_call.launches
        out = grid_knn_cuda.core_call(pk, r2, G, C, fused)
        torch.cuda.synchronize()
        assert grid_knn_cuda.core_call.launches == before + 1
        ref = grid_knn.core_plain(pk, r2, G, C, fused)
        assert torch.equal(out, ref), (fused, float((out - ref).abs().max()))


@pytest.mark.parametrize("G,C,kind", [(6, 8, "holes"), (5, 3, "empty"), (6, 8, "full"),
                                      (5, 1, "holes"), (7, 16, "full")])
def test_k8_hand_made_tables(dev, G, C, kind):
    """Tables with holes between occupied slots (and stray coordinates in
    the empty ones), an all-empty table (every row the empty-slot row) and
    full ones; C = 1 and odd G."""
    pk = torch.tensor(_grid_tables.table(G, C, kind, seed=G * C), device=dev)
    _k8_both(pk, G, C, _grid_tables.R2)


@pytest.mark.parametrize("C", [1, 3, 8, 16, 32])
def test_k8_capacities(dev, C):
    """Every capacity the staging handles differently: a cell a lane group
    (C = 1, 3, 8, 16), a whole warp (32); edge tiles cut by G = 11."""
    pk = torch.tensor(_grid_tables.table(11, C, "holes", seed=C), device=dev)
    assert 11 % grid_knn_cuda.k8_tile(11, C)[0] != 0
    _k8_both(pk, 11, C, _grid_tables.R2)


def test_k8_at_the_scan_post_shape(dev):
    """G = 128, C = 8 with 1500 occupied cells: nearly every tile empty."""
    pk = torch.tensor(_grid_tables.sparse_table(128, 8, 1500, seed=5), device=dev)
    _k8_both(pk, 128, 8, _grid_tables.R2)


def test_grid_normals_on_card_match_cpu(dev):
    """estimate_normals above the switch on the card (K7 + K8) against the
    same call on the CPU (plain versions), surface-like cloud."""
    rng = np.random.RandomState(21)
    xy = rng.rand(40000, 2).astype(np.float32) * 0.7
    z = 0.03 * np.sin(8 * xy[:, 0]) + 0.002 * rng.randn(40000).astype(np.float32)
    pts = np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float32)
    pc = PointCloud(points=torch.tensor(pts), valid=torch.ones(40000, dtype=torch.bool))
    kw = dict(radius=0.03, grid_size=24, cell_capacity=32)
    on_cpu = normals.estimate_normals(pc, **kw).normals
    on_card = normals.estimate_normals(PointCloud(points=pc.points.to(dev),
                                                  valid=pc.valid.to(dev)), **kw).normals
    dots = (on_card.cpu() * on_cpu).sum(1).abs()
    assert float(dots.median()) > 0.99999 and float((dots > 0.999).float().mean()) > 0.99


@pytest.mark.parametrize("C,H,W,shape", [(4, 480, 640, (64, 64, 64)), (1, 37, 53, (5, 7, 3))])
def test_k9_matches_plain(dev, C, H, W, shape):
    """K9 against the plain gather on the card, indices over the whole
    image (no window): a copy, so bitwise; one launch a call."""
    g = torch.Generator().manual_seed(C * H)
    imgs = torch.rand((C, H, W), generator=g).to(dev)
    vc = torch.randint(0, H, shape, generator=g, dtype=torch.int32).to(dev)
    uc = torch.randint(0, W, shape, generator=g, dtype=torch.int32).to(dev)
    before = project_sample_cuda.sample_images_cuda.launches
    out = project_sample.sample_images_at(vc, uc, imgs)
    torch.cuda.synchronize()
    assert project_sample_cuda.sample_images_cuda.launches == before + 1
    assert out.shape == (C, *shape)
    assert torch.equal(out, project_sample.sample_images_plain(vc, uc, imgs))
    with pytest.raises(ValueError, match="CUDA"):
        project_sample_cuda.sample_images_cuda(vc.cpu(), uc.cpu(), imgs.cpu())


def test_fusion_slice_on_card_matches_cpu(dev):
    """integrate (the fuse kernel on the card) x 3 -> extract_point_cloud and
    extract_triangle_mesh -> smooth -> cleanup -> normals on the card
    against the same calls on the CPU (plain versions): bitwise, as every
    operation rounds once on both and the sums run in index order."""
    cam = SyntheticRGBDCamera(160, 120, fx=130.0, fy=130.0, n_frames=3)
    cam.open()
    intr = CameraIntrinsics(130.0, 130.0, 79.5, 59.5)
    vols = {d: tsdf.make_volume(48, 0.02, 0.06, origin=(-0.48, -0.48, 0.9), device=d)
            for d in ("cpu", dev)}
    before = tsdf_fuse_cuda.fuse_voxels_cuda.launches
    k9_before = project_sample_cuda.sample_images_cuda.launches
    for k in range(3):
        c, depth = cam.grab()
        for d in vols:
            vols[d] = tsdf.integrate(vols[d], torch.tensor(depth, device=d),
                                     intr, torch.tensor(cam.true_pose(k), device=d),
                                     color=torch.tensor(c, device=d))
    assert tsdf_fuse_cuda.fuse_voxels_cuda.launches == before + 3
    assert project_sample_cuda.sample_images_cuda.launches == k9_before
    for name in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(vols[dev], name).cpu(), getattr(vols["cpu"], name)), name
    pcs = {d: tsdf.extract_point_cloud(v, capacity=1 << 14) for d, v in vols.items()}
    for name in ("points", "colors", "valid"):
        assert torch.equal(getattr(pcs[dev], name).cpu(), getattr(pcs["cpu"], name)), name
    meshes = {}
    for d, v in vols.items():
        m = marching.extract_triangle_mesh(v)
        m = mesh_ops.compute_vertex_normals(mesh_ops.cleanup(
            mesh_ops.filter_smooth_laplacian(m, 5)))
        meshes[d] = m
    for f in ("vertices", "triangles", "vertex_valid", "triangle_valid", "vertex_colors",
              "vertex_normals"):
        assert torch.equal(getattr(meshes[dev], f).cpu(), getattr(meshes["cpu"], f)), f
    assert int(meshes["cpu"].triangle_valid.sum()) > 5000


FUSE_INTR = CameraIntrinsics(130.3, 129.7, 79.5, 59.5)  # fx, fy not float32-exact


def _fuse_frame(g, dev, kind, H=120, W=160):
    """A random depth frame (a tenth of it 0, a twentieth beyond depth_trunc
    2.9) and its color: uint8, float32 or None."""
    d = g.uniform(0.2, 3.5, (H, W)).astype(np.float32)
    d[g.random((H, W)) < 0.1] = 0.0
    d[g.random((H, W)) < 0.05] = 3.2
    c = {"u8": lambda: g.integers(0, 256, (H, W, 3), dtype=np.uint8),
         "f32": lambda: g.random((H, W, 3)).astype(np.float32), None: lambda: None}[kind]()
    return torch.tensor(d, device=dev), None if c is None else torch.tensor(c, device=dev)


def _fuse_pose(g, dev, straddle=False):
    """camera_from_world: a random rotation and a shift that puts the volume
    in front of the camera or, straddling, across its plane z = 0."""
    k = torch.tensor(g.uniform(-0.4, 0.4, 3))
    K = torch.zeros((3, 3), dtype=torch.float64)
    K[0, 1], K[0, 2], K[1, 2] = -k[2], k[1], -k[0]
    T = torch.eye(4, dtype=torch.float64)
    T[:3, :3] = torch.linalg.matrix_exp(K - K.T)
    T[:3, 3] = torch.tensor(g.uniform(-0.2, 0.2, 3)) + torch.tensor(
        [0.0, 0.0, -0.35 if straddle else 0.4], dtype=torch.float64)
    return T.to(torch.float32).to(dev)


def _fuse_volume(g, dev, R, fused, weight_max):
    """An empty volume, or a partly fused one: weights 0 to weight_max, a
    fifth of them at weight_max, tsdf in [-1, 1], colors in [0, 1]."""
    vol = tsdf.make_volume(R, 0.05, 0.07, origin=(-0.4, -0.4, 0.0), device=dev)
    if not fused:
        return vol
    w = torch.tensor(g.integers(0, int(weight_max) + 2, (R, R, R)).astype(np.float32))
    return tsdf.TSDFVolume(
        tsdf=torch.tensor(g.uniform(-1, 1, (R, R, R)).astype(np.float32), device=dev),
        weight=torch.clamp(w, max=weight_max).to(dev),
        color=torch.tensor(g.random((R, R, R, 3)).astype(np.float32), device=dev),
        origin=vol.origin, voxel_size=vol.voxel_size, sdf_trunc=vol.sdf_trunc)


def _plain_path(monkeypatch, fn):
    """fn() with fusion/tsdf.py's plain version on the card's tensors."""
    with monkeypatch.context() as m:
        m.setattr(tsdf, "_on_card", lambda *a: False)
        return fn()


def _assert_fused_equal(a, b, names=("tsdf", "weight", "color")):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), name


@pytest.mark.parametrize("R", [64, 13])
@pytest.mark.parametrize("kind", ["u8", "f32", None])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("straddle", [False, True])
def test_fuse_kernel_integrate_matches_plain(dev, monkeypatch, R, kind, fused, straddle):
    """integrate through the fuse kernel (fold mode, one launch) against the
    plain path on the card, bitwise: uint8, float32 and no color; an empty
    and a partly fused volume with weights at weight_max; volumes in front
    of the camera and across z = 0 (voxels behind it, |u| saturating near
    it); depth 0 and beyond depth_trunc; R a multiple of 4 (16-byte loads)
    and not (one voxel a thread)."""
    g = np.random.default_rng([R, int(fused), int(straddle), len(str(kind))])
    vol = _fuse_volume(g, dev, R, fused, 4.0)
    depth, color = _fuse_frame(g, dev, kind)
    pose = _fuse_pose(g, dev, straddle)
    run = lambda: tsdf.integrate(vol, depth, FUSE_INTR, pose, color=color,  # noqa: E731
                                 depth_trunc=2.9, weight_max=4.0)
    before = tsdf_fuse_cuda.fuse_voxels_cuda.launches
    out = run()
    torch.cuda.synchronize()
    assert tsdf_fuse_cuda.fuse_voxels_cuda.launches == before + 1
    plain = _plain_path(monkeypatch, run)
    assert tsdf_fuse_cuda.fuse_voxels_cuda.launches == before + 1
    _assert_fused_equal(out, plain)
    if kind is None:
        assert out.color is vol.color  # no color frame: the volume's color is kept
    if not straddle:
        assert int((out.weight != vol.weight).sum()) > R ** 3 // 200


@pytest.mark.parametrize("kind", ["u8", None])
def test_fuse_kernel_frame_contrib_matches_plain(dev, monkeypatch, kind):
    """_frame_contrib through the fuse kernel (contribution mode) against
    the plain path on the card, bitwise, with and without color."""
    g = np.random.default_rng(7)
    vol = _fuse_volume(g, dev, 48, False, 64.0)
    depth, color = _fuse_frame(g, dev, kind)
    pose = _fuse_pose(g, dev)
    run = lambda: tsdf._frame_contrib(vol, depth, FUSE_INTR, pose, color, 2.9)  # noqa: E731
    before = tsdf_fuse_cuda.fuse_voxels_cuda.launches
    out = run()
    torch.cuda.synchronize()
    assert tsdf_fuse_cuda.fuse_voxels_cuda.launches == before + 1
    plain = _plain_path(monkeypatch, run)
    for name, a, b in zip(("n", "w", "cf"), out, plain):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    assert 0.02 < float(out[1].mean()) < 0.98


def test_fuse_kernel_batched_integrates_match_plain(dev, monkeypatch):
    """integrate_frames (one contribution launch a frame) and
    integrate_frames_exact on 4 in-process shards (two a frame: the weight
    pass and the affine pass) against the plain path on the card, bitwise."""
    g = np.random.default_rng(11)
    vol = _fuse_volume(g, dev, 36, True, 4.0)
    frames = [_fuse_frame(g, dev, "u8") for _ in range(4)]
    depths = torch.stack([d for d, _ in frames])
    colors = torch.stack([c for _, c in frames])
    exts = torch.stack([_fuse_pose(g, dev) for _ in range(4)])

    def copy():
        return dataclasses.replace(vol, tsdf=vol.tsdf.clone(), weight=vol.weight.clone(),
                                   color=vol.color.clone())

    batched = lambda: tsdf.integrate_frames(copy(), depths[:3], FUSE_INTR,  # noqa: E731
                                            exts[:3], colors[:3], 2.9, 4.0)
    mesh = make_mesh(4, ("frame",), device=dev)
    exact = lambda: pfusion.integrate_frames_exact(vol, depths, exts, FUSE_INTR,  # noqa: E731
                                                   mesh, colors=colors, depth_trunc=2.9,
                                                   weight_max=4.0)
    for run, launches in ((batched, 3), (exact, 8)):
        before = tsdf_fuse_cuda.fuse_voxels_cuda.launches
        out = run()
        torch.cuda.synchronize()
        assert tsdf_fuse_cuda.fuse_voxels_cuda.launches == before + launches
        _assert_fused_equal(out, _plain_path(monkeypatch, run))
        assert bool((out.weight != vol.weight).any())


def test_fuse_kernel_at_256_matches_plain(dev, monkeypatch):
    """FusionConfig()'s 256^3 volume, three SyntheticRGBDCamera(640, 480)
    frames with uint8 color: integrate with with_changed_z, then
    integrate_donated, each through the fuse kernel against the plain path
    on the card, bitwise (the changed-z profile equal)."""
    from recon3d_tpu_torch.config import FusionConfig

    fc = FusionConfig()
    cam = SyntheticRGBDCamera(640, 480, n_frames=3)
    cam.open()
    intr = CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy)
    frames = [cam.grab() for _ in range(3)]
    poses = [torch.tensor(cam.true_pose(k), dtype=torch.float32, device=dev) for k in range(3)]

    def run(donate):
        vol = tsdf.make_volume(fc.grid_resolution, fc.voxel_size, fc.sdf_trunc,
                               origin=(-0.512, -0.512, 1.0), device=dev)
        zs = []
        for (c, d), pose in zip(frames, poses):
            args = (vol, torch.tensor(d, device=dev), intr, pose)
            kw = dict(color=torch.tensor(c, device=dev), depth_trunc=fc.depth_trunc,
                      with_changed_z=True, changed_weight_min=2.0)
            vol, z = (tsdf.integrate_donated if donate else tsdf.integrate)(*args, **kw)
            zs.append(z)
        return vol, torch.stack(zs)

    for donate in (False, True):
        before = tsdf_fuse_cuda.fuse_voxels_cuda.launches
        out, zs = run(donate)
        torch.cuda.synchronize()
        assert tsdf_fuse_cuda.fuse_voxels_cuda.launches == before + 3
        plain, plain_zs = _plain_path(monkeypatch, lambda: run(donate))
        _assert_fused_equal(out, plain)
        assert torch.equal(zs, plain_zs)
        assert bool((out.weight > 0).any()) and bool(zs[-1].any())


@pytest.mark.parametrize("H,W,D", [(64, 256, 128), (128, 128, 256), (384, 128, 128),
                                   (384, 120, 256)])
def test_k10_k11_k12_match_plain(dev, H, W, D):
    """The carry scans both ways on a shard whose last 8 rows are dead (real
    cost below h_real), with carries from a real scan of another frame, and
    the finalize of the result; K11's walkers wrap round the width (three
    times at HP = 3 WP), DP 128 and 256. The public mirrors leave acc and
    carry_in as they were and count one launch a call."""
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    p1, p2, h_real = 200.0, 3200.0, H - 8
    vols = []
    for seed in (1, 2):
        gl, gr = _pair(H, W, seed)
        planes = sgm_cuda.prefilter_planes(torch.tensor(gl, device=dev),
                                           torch.tensor(gr, device=dev), 63)
        vols.append(sgm_cuda.cost_fwd_down(None, None, D, 0, 5, 63, p1, p2, HP, WP, DP, False,
                                           planes=planes))
    (cost, v1), (cost_b, v1_b) = vols
    zero = torch.zeros((2, WP, DP), device=dev)
    carries = {"vscan_carry": sgm_cuda.vscan_carry(cost_b, v1_b.clone(), zero[0], p1, p2,
                                                   False, H)[1],
               "diag_carry": sgm_cuda.diag_carry(cost_b, v1_b.clone(), zero, p1, p2, False,
                                                 H)[1]}
    S = v1.clone()
    for name, carry in carries.items():
        assert float(carry.max()) > 0
        for reverse in (False, True):
            before = getattr(sgm_cuda, name).launches
            acc, carry_before = v1.clone(), carry.clone()
            out_k, cout_k = getattr(sgm_cuda, name)(cost, acc, carry, p1, p2, reverse, h_real)
            torch.cuda.synchronize()
            assert getattr(sgm_cuda, name).launches == before + 1
            assert torch.equal(acc, v1) and torch.equal(carry, carry_before)
            out_q, cout_q = getattr(sgm_cuda, name + "_plain")(cost, v1.clone(), carry, p1, p2,
                                                              reverse, h_real)
            assert torch.equal(out_k, out_q) and torch.equal(cout_k, cout_q), (name, reverse)
            S = getattr(sgm_cuda, name)(cost, S, carry, p1, p2, reverse, h_real)[0]
    S_in = S.clone()
    d_k, v_k = sgm_cuda.wta_finalize(S, D, 10, 1, True, w_real=W)
    d_q, v_q = sgm_cuda.wta_finalize(S.cpu(), D, 10, 1, True, w_real=W)
    assert torch.equal(S, S_in)
    assert torch.equal(v_k.cpu(), v_q) and torch.equal(d_k.cpu(), d_q)


def test_k5_k11_identical_over_ten_launches(dev):
    """K5 and K11 add the two crossing paths with unordered reductions; on
    integer-valued volumes every order gives the same bits, so ten launches
    on the same inputs agree exactly (and with the plain versions). Both
    refuse penalties that are not whole numbers of x2 cost units."""
    H, W, D, p1, p2 = 320, 600, 128, 200.0, 3200.0
    gl, gr = (torch.tensor(a, device=dev) for a in _pair(H, W, seed=7))
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    cost, v1 = sgm_cuda.cost_fwd_down(gl, gr, D, 0, 5, 63, p1, p2, HP, WP, DP)
    v3 = sgm_cuda.bwd_accumulate(cost, v1, p1, p2)
    carry = sgm_cuda.diag_carry(cost, v3, torch.zeros((2, WP, DP), device=dev), p1, p2, False,
                                HP)[1]
    for vertical in ("down", "up"):
        outs = [sgm_cuda.diag_accumulate(cost, v3.clone(), p1, p2, vertical) for _ in range(10)]
        assert all(torch.equal(o, outs[0]) for o in outs[1:]), vertical
        assert torch.equal(outs[0], sgm_cuda.diag_accumulate_plain(cost, v3.clone(), p1, p2,
                                                                   vertical))
    for reverse in (False, True):
        outs = [sgm_cuda.diag_carry(cost, v3, carry, p1, p2, reverse, H - 8) for _ in range(10)]
        assert all(torch.equal(o, outs[0][0]) and torch.equal(c, outs[0][1])
                   for o, c in outs[1:]), reverse
        ref = sgm_cuda.diag_carry_plain(cost, v3.clone(), carry, p1, p2, reverse, H - 8)
        assert torch.equal(outs[0][0], ref[0]) and torch.equal(outs[0][1], ref[1])
    # a penalty that is not a whole number of x2 units would make the order count
    with pytest.raises(ValueError):
        sgm_cuda.diag_accumulate(cost, v3.clone(), 200.25, p2)
    with pytest.raises(ValueError):
        sgm_cuda.diag_carry(cost, v3, carry, p1, 3200.25, False, H)


@pytest.mark.parametrize("num_directions", [3, 4, 8])
def test_aggregate_and_finalize_on_card_leaves_v1_intact(dev, num_directions):
    """The public aggregate_and_finalize leaves the caller's v1 as it was,
    equal bit for bit to the frame's in-place entry and its launches
    counted; fuse_bwd (4 and 3 directions) is K3 then K4, bitwise equal to
    fuse_bwd=False; with 8 directions it is refused."""
    H, W, D, p1, p2 = 104, 256, 64, 200.0, 3200.0
    gl, gr = (torch.tensor(a, device=dev) for a in _pair(H, W, seed=9))
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    final_dir = "up" if num_directions >= 4 else "down"
    cost, v1 = sgm_cuda.cost_fwd_down(gl, gr, D, 0, 5, 63, p1, p2, HP, WP, DP,
                                      num_directions >= 4)
    v1_in = v1.clone()
    args = (cost, p1, p2, D, 10, 1, True, W)
    ref = sgm_cuda._aggregate_and_finalize_(*args, v1.clone(), final_dir, num_directions == 8)
    for fuse_bwd in (False, True):
        if fuse_bwd and num_directions == 8:
            with pytest.raises(ValueError):
                sgm_cuda.aggregate_and_finalize(*args, v1=v1, with_diag=True, fuse_bwd=True)
            continue
        before = (sgm_cuda.bwd_accumulate.launches, sgm_cuda.vfinalize.launches,
                  sgm_cuda.diag_accumulate.launches)
        d, v = sgm_cuda.aggregate_and_finalize(*args, v1=v1, final_dir=final_dir,
                                               with_diag=num_directions == 8, fuse_bwd=fuse_bwd)
        torch.cuda.synchronize()
        after = (sgm_cuda.bwd_accumulate.launches, sgm_cuda.vfinalize.launches,
                 sgm_cuda.diag_accumulate.launches)
        assert after == (before[0] + 1, before[1] + 1,
                         before[2] + (2 if num_directions == 8 else 0))
        assert torch.equal(v1, v1_in)
        assert torch.equal(d, ref[0]) and torch.equal(v, ref[1])


def _k4_volumes(case, dev):
    """(cost, v3, w_real, D, P2) of one K4 / K12 case on the card (P1 200)."""
    if case == "flat":  # zero cost and v3: S is 0 everywhere, every d ties
        return (torch.zeros((64, 256, 128), dtype=torch.int16, device=dev),
                torch.zeros((64, 256, 128), device=dev), 200, 16, 3200.0)
    # P2 3200 = 128 * 5^2, accurate()'s; 2400 = 96 * 5^2, tuned()'s
    H, W, D, p2, dirs = {"D16": (40, 200, 16, 3200.0, 4), "D160": (40, 200, 160, 3200.0, 4),
                         "D256": (24, 200, 256, 3200.0, 4), "clamp": (24, 100, 16, 3200.0, 8),
                         "shard320": (320, 1900, 128, 2400.0, 4)}[case]
    gl, gr = (torch.tensor(a, device=dev) for a in _pair(H, W, seed=H + D))
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    cost, v = sgm_cuda.cost_fwd_down(gl, gr, D, 0, 5, 63, 200.0, p2, HP, WP, DP)
    v = sgm_cuda.bwd_accumulate(cost, v, 200.0, p2)
    if dirs == 8:
        for vertical in ("down", "up"):
            v = sgm_cuda.diag_accumulate(cost, v, 200.0, p2, vertical)
    return cost, v, W, D, p2


@pytest.mark.parametrize("final_dir", ["up", "down"])
@pytest.mark.parametrize("case", ["D16", "D160", "D256", "flat", "clamp", "shard320"])
def test_k4_k12_match_plain_bitwise(dev, case, final_dir):
    """K4 against vfinalize_plain and K12 against wta_finalize_plain on
    S = v3 + L_vert, torch.equal on disp and valid, for uniqueness 0 / 10,
    disp12_max_diff -1 / 0 / 1 and subpixel off / on: DP = 128 and 256 with
    d_real < DP, w_real < WP, a flat S (d0 = 0 by the packed tie rule), an
    8-direction S past the pack clamp and a 320-row shard. K4 leaves v3 as
    it was; each wrapper counts one launch a call."""
    cost, v3, w_real, D, p2 = _k4_volumes(case, dev)
    p1 = 200.0
    v3_in = v3.clone()
    S = sgm_cuda._scan_plain(cost, v3, torch.empty_like(v3), 0, final_dir == "up", 2 * p1,
                             2 * p2)
    S_in = S.clone()
    if case == "flat":
        assert bool((S == 0).all())
    if case == "clamp" and final_dir == "up":  # the 8-direction S
        assert float(S.max()) > 2.0 ** 24 / 128 - 1
    for ur, md, sub in itertools.product((0, 10), (-1, 0, 1), (False, True)):
        args = (D, ur, md, sub, w_real)
        before = sgm_cuda.vfinalize.launches
        d_k, v_k = sgm_cuda.vfinalize(cost, v3, p1, p2, *args, final_dir)
        torch.cuda.synchronize()
        assert sgm_cuda.vfinalize.launches == before + 1
        assert torch.equal(v3, v3_in)
        d_q, v_q = sgm_cuda.vfinalize_plain(cost, v3, p1, p2, *args, final_dir)
        assert torch.equal(v_k, v_q) and torch.equal(d_k, d_q), ("K4", ur, md, sub)
        before = sgm_cuda.wta_finalize.launches
        d_k, v_k = sgm_cuda.wta_finalize(S, *args)
        torch.cuda.synchronize()
        assert sgm_cuda.wta_finalize.launches == before + 1
        assert torch.equal(S, S_in)
        d_q, v_q = sgm_cuda.wta_finalize_plain(S, *args)
        assert torch.equal(v_k, v_q) and torch.equal(d_k, d_q), ("K12", ur, md, sub)


@pytest.mark.parametrize("num_directions,H", [(3, 128), (4, 104), (8, 104)])
def test_rowsharded_on_card_matches_single_device(dev, num_directions, H):
    gl, gr = (torch.tensor(a, device=dev) for a in _pair(H, 256, seed=5))
    kw = dict(num_disparities=64, block_size=5, p2=3200.0, num_directions=num_directions)
    before = sgm_cuda.vscan_carry.launches
    d_s, v_s = sgm_sharded.sgm_disparity_cuda_rowsharded(
        gl, gr, make_mesh(4, ("row",), device=dev), **kw)
    torch.cuda.synchronize()
    assert sgm_cuda.vscan_carry.launches == before + 4 * (1 if num_directions == 3 else 2)
    d_1, v_1 = sgm_cuda.sgm_disparity_cuda(gl, gr, **kw)
    assert torch.equal(v_s, v_1) and torch.equal(d_s, d_1)
    assert float(v_1.float().mean()) > 0.5


def test_batched_depth_on_card_matches_compute_disparity(dev):
    ls, rs = zip(*(_pair(96, 256, seed=k) for k in range(4)))
    ls, rs = torch.tensor(np.stack(ls), device=dev), torch.tensor(np.stack(rs), device=dev)
    cfg = StereoMatcherConfig.tuned(num_disparities=64, backend="cuda")
    disp, valid, mean = batch.batched_depth(ls, rs, make_mesh(2, ("frame",), device=dev), cfg)
    for k in range(4):
        d1, v1 = compute_disparity(ls[k], rs[k], cfg)
        assert torch.equal(disp[k], d1) and torch.equal(valid[k], v1)
    d, v = disp.double(), valid
    assert abs(float(mean) - float(d[v].sum() / v.sum())) <= 1e-5 * float(mean)
