"""Port parity for registration/features.py and registration/ransac.py
against the JAX package on the CPU, on the JAX tests' global-registration
scene (tests/test_registration.py:205-220: a 1000-point surface under a
large pose, normals radius 0.25, FPFH radius 0.4 / 50 neighbors). Bars and
the largest differences measured:
  compute_fpfh: rtol 1e-4 / atol 1e-4 on at least 99.9 % of the entries
  (measured: all 66000 within, largest difference 4.9e-4 of values up to
  ~200). The 0.1 % allowed (33 entries a cloud) are bin-edge flips: an
  angle within a rounding of a bin edge moves one count between adjacent
  bins, changing two entries of the point by 100 / count;
  match_features (mutual and not): indices and mask equal, both packages
  fed the same features;
  RANSAC, both fed the JAX package's own draws (PRNGKey(1), split,
  categorical, as ransac.py:161-168): the chosen transform atol 1e-4
  (measured 3.0e-7); per-trial scores equal except on trials whose 3x3
  cross-covariance is near-singular (second singular value under 1e-3 of
  the first: the SVD's free directions) or with a scoring point within
  1e-5 of the inlier threshold (a rounding of the transform moves it
  across; the scoring subset repeats points, so one such point changes
  the count by its multiplicity): 6 of 8192 trials differ, 2 and 4;
  registration_ransac_fpfh with the port's own CPU generator: the pose
  within 5e-3 and fitness > 0.95 (the JAX test's bar);
  fgr_core and registration_fgr_fpfh: transform atol 1e-4 (measured
  1.2e-7);
  multiscale_icp point-to-point: transform atol 1e-4 (measured 8.9e-7);
  point-to-plane: atol 5e-4 (measured 2.8e-4). Looser than 1e-4: at voxel
  0.05 29 of the 794 target points have one neighbor within the normals'
  radius, whose covariance has rank 1 and whose normal is any vector
  across the line; estimate_normals picks another one in each package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.pointcloud.normals import estimate_normals as jestimate_normals
from recon3d_tpu.registration import features as jfeatures
from recon3d_tpu.registration import ransac as jransac
from recon3d_tpu.registration import se3 as jse3
from recon3d_tpu.utils import types as jtypes
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.registration import features, ransac


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pose(rvec, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(rvec, jnp.float32)))
    T[:3, 3] = t
    return T


def _port(jpc):
    return convert.point_cloud({k: None if getattr(jpc, k) is None else np.asarray(getattr(jpc, k))
                                for k in ("points", "valid", "colors", "normals")}, device="cpu")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(5)
    xy = rng.rand(1000, 2) * 2 - 1
    pts = np.column_stack([xy, 0.3 * np.sin(2.0 * xy[:, 0])
                           + 0.2 * np.cos(3.0 * xy[:, 1])]).astype(np.float32)
    T_true = _pose([0.3, -0.5, 0.8], [0.4, -0.3, 0.5])
    js = jestimate_normals(jtypes.PointCloud.from_numpy(pts), radius=0.25, max_nn=30)
    jt = jestimate_normals(jtypes.PointCloud.from_numpy(pts @ T_true[:3, :3].T + T_true[:3, 3]),
                           radius=0.25, max_nn=30)
    fs = jfeatures.compute_fpfh(js, radius=0.4, max_nn=50)
    ft = jfeatures.compute_fpfh(jt, radius=0.4, max_nn=50)
    return dict(js=js, jt=jt, ps=_port(js), pt=_port(jt), fs=np.asarray(fs), ft=np.asarray(ft),
                T_true=T_true)


def test_fpfh_matches_jax(scene):
    for p, f in (("ps", "fs"), ("pt", "ft")):
        got = features.compute_fpfh(scene[p], radius=0.4, max_nn=50).numpy()
        ref = scene[f]
        off = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
        assert off.sum() <= 0.001 * off.size, f"{off.sum()} entries off (bin-edge flips)"
        assert np.abs(got[~off] - ref[~off]).max() <= 1e-4 + 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("mutual", [True, False])
def test_match_features_matches_jax(scene, mutual):
    js, jt = scene["js"], scene["jt"]
    a_i, a_ok = jfeatures.match_features(jnp.asarray(scene["fs"]), js.valid,
                                         jnp.asarray(scene["ft"]), jt.valid, mutual=mutual)
    b_i, b_ok = features.match_features(torch.tensor(scene["fs"]), scene["ps"].valid,
                                        torch.tensor(scene["ft"]), scene["pt"].valid,
                                        mutual=mutual)
    np.testing.assert_array_equal(b_i.numpy(), np.asarray(a_i))
    np.testing.assert_array_equal(b_ok.numpy(), np.asarray(a_ok))
    assert int(b_ok.sum()) > 300


def _jax_trials(src, tgt, ok, picks, score_idx, thr):
    """The JAX package's per-trial scores (ransac.py:172-186's one_trial)."""
    s_sub, t_sub = jnp.asarray(src)[score_idx], jnp.asarray(tgt)[score_idx]

    def one(pick):
        s, t = jnp.asarray(src)[pick], jnp.asarray(tgt)[pick]
        ds = jnp.linalg.norm(s[:, None, :] - s[None, :, :], axis=-1)
        dt = jnp.linalg.norm(t[:, None, :] - t[None, :, :], axis=-1)
        ratio = jnp.minimum(ds, dt) / jnp.maximum(jnp.maximum(ds, dt), 1e-12)
        edges_ok = jnp.all(ratio[jnp.triu_indices(3, 1)] > 0.9)
        T = jransac._kabsch3(s, t)
        err = jnp.linalg.norm(jse3.apply(T, s_sub) - t_sub, axis=-1)
        return jnp.where(edges_ok, jnp.sum((err < thr).astype(jnp.float32)), -1.0), T

    return jax.jit(lambda p: jax.lax.map(one, p, batch_size=4096))(picks)


def test_ransac_trials_match_jax(scene):
    js, jt = scene["js"], scene["jt"]
    s2t, ok = jfeatures.match_features(jnp.asarray(scene["fs"]), js.valid,
                                       jnp.asarray(scene["ft"]), jt.valid)
    src, tgt, ok = np.asarray(js.points), np.asarray(jt.points)[np.asarray(s2t)], np.asarray(ok)
    thr, trials = 0.05, 8192
    # the JAX package's own draws (ransac.py:161-168)
    logits = jnp.where(ok, 0.0, -1e30)
    k_samp, k_score = jax.random.split(jax.random.PRNGKey(1))
    picks = np.asarray(jax.random.categorical(k_samp, logits, shape=(trials, 3)))
    score_idx = np.asarray(jax.random.categorical(k_score, logits, shape=(2048,)))
    T_ref = np.asarray(jransac.ransac_from_correspondences(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ok), thr, num_trials=trials, seed=1))
    j_scores, j_Ts = (np.asarray(v) for v in _jax_trials(src, tgt, ok, picks, score_idx, thr))
    np.testing.assert_array_equal(j_Ts[np.argmax(j_scores)], T_ref)

    scores, Ts = ransac._ransac_trials(torch.tensor(src), torch.tensor(tgt), torch.tensor(picks),
                                       torch.tensor(score_idx), thr)
    np.testing.assert_allclose(Ts[torch.argmax(scores)].numpy(), T_ref, rtol=0, atol=1e-4)
    differ = np.nonzero(scores.numpy() != j_scores)[0]
    # which of those are near-singular or hold a point on the threshold
    s64, t64 = src[picks[differ]].astype(np.float64), tgt[picks[differ]].astype(np.float64)
    S = np.einsum("tni,tnj->tij", t64 - t64.mean(1, keepdims=True),
                  s64 - s64.mean(1, keepdims=True))
    sv = np.linalg.svd(S, compute_uv=False)
    singular = sv[:, 1] < 1e-3 * sv[:, 0]
    T64 = j_Ts[differ].astype(np.float64)
    moved = np.einsum("tij,sj->tsi", T64[:, :3, :3], src[score_idx]) + T64[:, None, :3, 3]
    err = np.linalg.norm(moved - tgt[score_idx][None], axis=-1)
    on_edge = (np.abs(err - thr) < 1e-5).any(1)
    assert len(differ) <= 0.002 * trials and (singular | on_edge).all(), (
        f"{len(differ)} trials differ: {int(singular.sum())} near-singular, "
        f"{int(on_edge.sum())} on the threshold, {differ[~(singular | on_edge)]} neither")


def test_ransac_fpfh_recovers_pose_with_own_draws(scene):
    fs, ft = (features.compute_fpfh(scene[k], radius=0.4, max_nn=50) for k in ("ps", "pt"))
    res = ransac.registration_ransac_fpfh(scene["ps"], scene["pt"], fs, ft, distance_threshold=0.05,
                                          num_trials=8192, seed=1)
    assert np.abs(res.transformation.numpy() - scene["T_true"]).max() < 5e-3
    assert float(res.fitness) > 0.95
    # the draws depend on the seed alone
    ok = torch.rand(500, generator=torch.Generator().manual_seed(0)) > 0.3
    a = ransac.draw_trials(ok, 64, 3, 32, seed=7)
    b = ransac.draw_trials(ok, 64, 3, 32, seed=7)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and bool(ok[a[0]].all())


def test_fgr_matches_jax(scene):
    js, jt = scene["js"], scene["jt"]
    s2t, ok = jfeatures.match_features(jnp.asarray(scene["fs"]), js.valid,
                                       jnp.asarray(scene["ft"]), jt.valid)
    src, tgt = np.asarray(js.points), np.asarray(jt.points)[np.asarray(s2t)]
    a = jransac.fgr_core(jnp.asarray(src), jnp.asarray(tgt), ok, 0.05)
    b = ransac.fgr_core(torch.tensor(src), torch.tensor(tgt), torch.tensor(np.asarray(ok)), 0.05)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-4)
    a = jransac.registration_fgr_fpfh(js, jt, jnp.asarray(scene["fs"]), jnp.asarray(scene["ft"]),
                                      max_corr_distance=0.05)
    b = ransac.registration_fgr_fpfh(scene["ps"], scene["pt"], torch.tensor(scene["fs"]),
                                     torch.tensor(scene["ft"]), max_corr_distance=0.05)
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), rtol=0,
                               atol=1e-4)
    assert float(b.fitness) == float(a.fitness)


@pytest.mark.parametrize("method,atol", [("point_to_point", 1e-4), ("point_to_plane", 5e-4)])
def test_multiscale_icp_matches_jax(scene, method, atol):
    T0 = scene["T_true"].copy()
    T0[:3, 3] += 0.02
    kw = dict(voxel_sizes=(0.15, 0.05), iterations=(20, 15), method=method)
    a = jransac.multiscale_icp(scene["js"], scene["jt"], init=jnp.asarray(T0), **kw)
    b = ransac.multiscale_icp(scene["ps"], scene["pt"], init=torch.tensor(T0), **kw)
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), rtol=0,
                               atol=atol)
    assert np.abs(b.transformation.numpy() - scene["T_true"]).max() < 5e-3
