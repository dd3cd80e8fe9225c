"""Port parity for registration/posegraph.py (and convert.pose_graph)
against the JAX package on the CPU, on the JAX tests' loop-closure and
bad-closure graphs (tests/test_registration.py:264-322). Bars and the
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


GRAPHS = {"loop_closure": (loop_closure_graph, dict(max_iterations=40)),
          "bad_closure": (bad_closure_graph, dict(max_iterations=30, mu=0.01))}


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
