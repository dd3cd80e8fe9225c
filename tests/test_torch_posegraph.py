"""Port parity for registration/posegraph.py (and convert.pose_graph)
against the JAX package on the CPU, on the JAX tests' loop-closure and
bad-closure graphs (tests/test_registration.py:264-322) and a scanner chain
whose loop edge disagrees by the scene's free rotation. Bars and the
largest differences measured: node poses atol 1e-4 (measured 6.6e-7),
final line-process weights rtol 1e-4 (measured 8.8e-7), cost rtol 1e-4,
the same edges pruned; the Jacobian is torch.func.jacfwd's, the JAX
package's jax.jacfwd's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.registration import posegraph as jposegraph
from recon3d_tpu.registration import se3 as jse3
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.registration import posegraph


def _pose(rvec, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(rvec, jnp.float32)))
    T[:3, 3] = t
    return T


def loop_closure_graph():
    """Six poses on a circle, noisy odometry edges, an exact uncertain loop
    closure and initial poses perturbed by 0.05-sigma twists."""
    rng = np.random.RandomState(0)
    n = 6
    true = [_pose([0, 0, 2 * np.pi * i / n], [np.cos(2 * np.pi * i / n),
                                               np.sin(2 * np.pi * i / n), 0.0]).astype(np.float64)
            for i in range(n)]
    g = jposegraph.PoseGraph()
    g.add_node(np.eye(4))
    info = np.eye(6) * 100.0
    for i in range(1, n):
        rel = np.linalg.inv(true[i - 1]) @ true[i]
        noise = np.asarray(jse3.se3_exp(jnp.asarray(rng.randn(6) * 0.01, jnp.float32)))
        g.add_node(true[i] @ np.asarray(jse3.se3_exp(jnp.asarray(rng.randn(6) * 0.05,
                                                                 jnp.float32))))
        g.add_edge(i, i - 1, rel @ noise, info, uncertain=False)
    g.add_edge(n - 1, 0, np.linalg.inv(true[0]) @ true[n - 1], info, uncertain=True)
    return g


def bad_closure_graph():
    g = jposegraph.PoseGraph()
    for i in range(4):
        T = np.eye(4)
        T[0, 3] = i * 0.1
        g.add_node(T)
    info = np.eye(6) * 100.0
    rel = np.eye(4)
    rel[0, 3] = 0.1
    for i in range(1, 4):
        g.add_edge(i, i - 1, rel, info, uncertain=False)
    bad = np.eye(4)
    bad[1, 3] = 5.0  # an absurd loop closure
    g.add_edge(3, 0, bad, info, uncertain=True)
    return g


def scanner_chain_graph(free_angle=0.0):
    """Scanner3D's graph on 4 SyntheticRGBDCamera frames (step 0.01):
    sequential edges (certain) and the loop edge (2, 0) (uncertain) at the
    true relative poses, each edge's information that of ~1,900 scene
    points (the plane z = 1.8 and the sphere's near cap). With free_angle,
    edge (1, 0) turns by that angle about the plane's normal through the
    sphere's center: a motion neither surface shows, so a registration of
    the pair can land anywhere along it, and the chain then disagrees
    with the loop edge by that angle."""
    def cam_from_world(k):
        ang = 0.01 * k
        c, s_ = np.cos(ang), np.sin(ang)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s_], [0, 1, 0], [-s_, 0, c]]
        T[0, 3], T[1, 3] = 0.01 * k, 0.0025 * k
        return T

    u = np.linspace(-0.6, 0.6, 36)
    plane = np.stack(np.meshgrid(u, u, [1.8]), -1).reshape(-1, 3)
    a = np.linspace(0.0, 2 * np.pi, 40, endpoint=False)
    cap = np.concatenate([np.stack([0.3 * np.sin(t) * np.cos(a), 0.3 * np.sin(t) * np.sin(a),
                                    1.2 - 0.3 * np.cos(t) + 0 * a], -1)
                          for t in np.linspace(0.1, 1.2, 15)])
    q = np.concatenate([plane, cap])
    hat = np.zeros((len(q), 3, 3))
    hat[:, 0, 1], hat[:, 0, 2], hat[:, 1, 2] = -q[:, 2], q[:, 1], -q[:, 0]
    hat -= hat.transpose(0, 2, 1)
    J = np.concatenate([np.broadcast_to(np.eye(3), hat.shape), -hat], 2)
    info = np.einsum("nij,nik->jk", J, J)
    free = np.eye(4)
    c_, s_ = np.cos(free_angle), np.sin(free_angle)
    free[:3, :3] = [[c_, -s_, 0], [s_, c_, 0], [0, 0, 1]]
    free[:3, 3] = np.array([0.0, 0.0, 1.2]) - free[:3, :3] @ np.array([0.0, 0.0, 1.2])
    g = jposegraph.PoseGraph()
    g.add_node(np.eye(4))
    world_from_prev = np.eye(4)
    for i in range(1, 4):
        T = cam_from_world(i - 1) @ np.linalg.inv(cam_from_world(i))
        if i == 1:
            T = free @ T
        world_from_prev = world_from_prev @ T
        g.add_node(world_from_prev)
        g.add_edge(i, i - 1, T, info, uncertain=False)
    g.add_edge(2, 0, cam_from_world(0) @ np.linalg.inv(cam_from_world(2)), info, uncertain=True)
    return g


GRAPHS = {"loop_closure": (loop_closure_graph, dict(max_iterations=40)),
          "bad_closure": (bad_closure_graph, dict(max_iterations=30, mu=0.01)),
          "scanner_chain_free_rotation": (lambda: scanner_chain_graph(0.0567), {})}


def _port_graph(g):
    return convert.pose_graph(g.nodes, [dataclasses.asdict(e) for e in g.edges])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_global_optimization_matches_jax(name):
    make, kw = GRAPHS[name]
    g = make()
    a = jposegraph.global_optimization(g, **kw)
    b = posegraph.global_optimization(_port_graph(g), device="cpu", **kw)
    assert len(b.nodes) == len(a.nodes)
    for x, y in zip(b.nodes, a.nodes):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)
    assert [(e.source, e.target) for e in b.edges] == [(e.source, e.target) for e in a.edges]
    if name == "bad_closure":
        assert len(b.edges) == 3  # the bad closure pruned


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_optimize_weights_and_cost_match_jax(name):
    make, kw = GRAPHS[name]
    g = make()
    arrays = (np.stack(g.nodes), [e.source for e in g.edges], [e.target for e in g.edges],
              np.stack([e.transformation for e in g.edges]),
              np.stack([e.information for e in g.edges]), [e.uncertain for e in g.edges])
    dtypes = (jnp.float32, jnp.int32, jnp.int32, jnp.float32, jnp.float32, bool)
    a = jposegraph._optimize(*(jnp.asarray(np.asarray(x), d) for x, d in zip(arrays, dtypes)), **kw)
    tdt = (torch.float32, torch.int32, torch.int32, torch.float32, torch.float32, torch.bool)
    b = posegraph._optimize(*(torch.as_tensor(np.asarray(x), dtype=d) for x, d in zip(arrays, tdt)),
                            **kw)
    np.testing.assert_allclose(b.poses.numpy(), np.asarray(a.poses), rtol=0, atol=1e-4)
    np.testing.assert_allclose(b.edge_weights.numpy(), np.asarray(a.edge_weights), rtol=1e-4)
    np.testing.assert_allclose(float(b.cost), float(a.cost), rtol=1e-4)


@pytest.mark.parametrize("angle, kept", [(0.0, 4), (0.0567, 3)])
def test_a_loop_edge_off_by_the_free_rotation_is_pruned(angle, kept):
    """The 4-frame pose graph of the registration phase kept its loop edge
    (2, 0) on the host CPU (weight 0.95) and pruned it on the card (7.6e-5):
    the two runs' pair (1, 0) landed 0.0567 rad apart about the plane's
    normal, the rotation the scene leaves free. The solver is not the
    cause: on one graph the card's weights equal the host's (chip_smoke.py's
    offline phase). Here both packages keep the loop edge of the true chain
    and prune it once edge (1, 0) turns by that angle, with weights far
    from the 0.25 threshold either way."""
    g = scanner_chain_graph(angle)
    b = posegraph.global_optimization(_port_graph(g), device="cpu")
    a = jposegraph.global_optimization(g)
    assert len(b.edges) == len(a.edges) == kept
    tdt = (torch.float32, torch.int32, torch.int32, torch.float32, torch.float32, torch.bool)
    arrays = (np.stack(g.nodes), [e.source for e in g.edges], [e.target for e in g.edges],
              np.stack([e.transformation for e in g.edges]),
              np.stack([e.information for e in g.edges]), [e.uncertain for e in g.edges])
    w = posegraph._optimize(*(torch.as_tensor(np.asarray(x), dtype=d)
                              for x, d in zip(arrays, tdt))).edge_weights
    assert w[3] > 0.9 if kept == 4 else w[3] < 0.01, float(w[3])


def test_pose_graph_conversion_and_trivial_graphs():
    g = loop_closure_graph()
    p = _port_graph(g)
    assert len(p.nodes) == len(g.nodes) and len(p.edges) == len(g.edges)
    for a, b in zip(p.edges, g.edges):
        assert (a.source, a.target, a.uncertain) == (b.source, b.target, b.uncertain)
        np.testing.assert_array_equal(a.transformation, b.transformation)
    single = posegraph.PoseGraph()
    single.add_node(np.eye(4))
    assert posegraph.global_optimization(single, device="cpu") is single
