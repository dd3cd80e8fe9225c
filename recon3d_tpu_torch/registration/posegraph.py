"""Pose graph construction and global optimization (twin of
recon3d_tpu/registration/posegraph.py).

Replaces o3d.pipelines.registration.PoseGraph + global_optimization with
LevenbergMarquardt (test/mini1.py:307-341, check2.py:111-179): nodes are
absolute poses, edges carry measured relative transforms, 6x6 information
matrices and an `uncertain` flag (loop closures; odometry edges are
certain). The optimizer is LM over node twists (node 0 pinned), with
Open3D-style line-process weights on uncertain edges so bad loop closures
switch off rather than distort the trajectory.

All edges are evaluated as batched tensor ops and the Jacobian comes from
forward-mode differentiation (torch.func.jacfwd); the normal equations are a
dense (6V x 6V) solve (graphs of tens of fragments). The LM sweeps run a
fixed count with no host read; edge pruning happens on the host after.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from recon3d_tpu_torch.registration import se3


@dataclasses.dataclass
class PoseGraphEdge:
    source: int
    target: int
    transformation: np.ndarray  # (4, 4) measured T_target_from_source
    information: np.ndarray  # (6, 6)
    uncertain: bool = False


@dataclasses.dataclass
class PoseGraph:
    """Mirrors o3d PoseGraph: nodes[i] is world_from_node_i."""

    nodes: List[np.ndarray] = dataclasses.field(default_factory=list)
    edges: List[PoseGraphEdge] = dataclasses.field(default_factory=list)

    def add_node(self, pose: np.ndarray) -> int:
        self.nodes.append(np.asarray(pose, np.float64))
        return len(self.nodes) - 1

    def add_edge(self, source: int, target: int, transformation, information,
                 uncertain: bool = False) -> None:
        self.edges.append(PoseGraphEdge(source, target,
                                        np.asarray(transformation, np.float64),
                                        np.asarray(information, np.float64), uncertain))


class OptimizeResult(NamedTuple):
    poses: torch.Tensor  # (V, 4, 4)
    cost: torch.Tensor
    edge_weights: torch.Tensor  # (E,) final line-process weights


def _optimize(poses0, edge_src, edge_tgt, edge_T, edge_info, edge_uncertain,
              max_iterations: int = 50, mu: float = 0.1) -> OptimizeResult:
    """LM over node twists; line-process weights on uncertain edges.

    Residual per edge: log(T_meas^-1 (X_tgt^-1 X_src)) weighted by
    sqrt(info); uncertain edges are further scaled by sqrt(w_e) with
    w_e = (mu / (mu + r^T Lambda r))^2, recomputed each sweep (Geman-McClure
    line process, Choi / Zhou / Koltun's robust reconstruction)."""
    V = poses0.shape[0]
    E = edge_src.shape[0]
    dev = poses0.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    sqrt_info = torch.linalg.cholesky_ex(edge_info + 1e-9 * eye6[None].expand(E, 6, 6)).L
    src, tgt = edge_src.long(), edge_tgt.long()
    pin = torch.ones((V, 1), dtype=torch.float32, device=dev)
    pin[0] = 0.0  # node 0 pinned

    def edge_errors(xis):
        X = se3.se3_exp(xis) @ poses0
        rel = se3.inverse(X[tgt]) @ X[src]
        return se3.se3_log(se3.inverse(edge_T) @ rel)

    def edge_residuals(xis, weights):
        wr = torch.einsum("eij,ej->ei", sqrt_info, edge_errors(xis))
        return wr * torch.sqrt(weights)[:, None]

    def weights_of(xis):
        err = edge_errors(xis)
        maha = torch.einsum("ei,eij,ej->e", err, edge_info, err)
        w = (mu / (mu + maha)) ** 2
        return torch.where(edge_uncertain, w, 1.0)

    xis = torch.zeros((V, 6), dtype=torch.float32, device=dev)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    for _ in range(max_iterations):
        w = weights_of(xis)

        def res_flat(x_flat):
            return edge_residuals(x_flat.reshape(V, 6) * pin, w).reshape(-1)

        x_flat = xis.reshape(-1)
        r = res_flat(x_flat)
        J = torch.func.jacfwd(res_flat)(x_flat)
        A = J.T @ J
        g = J.T @ r
        diag = torch.clamp(torch.diagonal(A), min=1e-9)
        dx = -torch.linalg.solve_ex(A + lam * torch.diag(diag), g).result
        new_flat = x_flat + dx
        new_r = res_flat(new_flat)
        improved = torch.sum(new_r * new_r) < torch.sum(r * r)
        xis = torch.where(improved, new_flat, x_flat).reshape(V, 6) * pin
        lam = torch.where(improved, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e8))
    w = weights_of(xis)
    r = edge_residuals(xis, w)
    poses = se3.se3_exp(xis) @ poses0
    return OptimizeResult(poses=poses, cost=0.5 * torch.sum(r * r), edge_weights=w)


def global_optimization(graph: PoseGraph, max_iterations: int = 50,
                        edge_prune_threshold: float = 0.25, mu: float = 0.1,
                        device="cuda") -> PoseGraph:
    """o3d global_optimization(LevenbergMarquardt) (mini1.py:323-341).

    Returns a new PoseGraph with the optimized node poses; uncertain edges
    whose final line-process weight fell below edge_prune_threshold are
    dropped (Open3D's edge pruning). The solve runs on `device`."""
    if len(graph.nodes) < 2 or not graph.edges:
        return graph

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    res = _optimize(put(np.stack(graph.nodes)), put([e.source for e in graph.edges], torch.int32),
                    put([e.target for e in graph.edges], torch.int32),
                    put(np.stack([e.transformation for e in graph.edges])),
                    put(np.stack([e.information for e in graph.edges])),
                    put([e.uncertain for e in graph.edges], torch.bool),
                    max_iterations=max_iterations, mu=mu)
    out = PoseGraph()
    for p in res.poses.cpu().numpy():
        out.add_node(p)
    w = res.edge_weights.cpu().numpy()
    for e, wi in zip(graph.edges, w):
        if e.uncertain and wi < edge_prune_threshold:
            continue
        out.add_edge(e.source, e.target, e.transformation, e.information, e.uncertain)
    return out
