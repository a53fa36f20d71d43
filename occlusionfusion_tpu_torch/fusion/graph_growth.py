"""Deformation-graph growth: extend the graph onto newly observed surface
(port of ``occlusionfusion_tpu/fusion/graph_growth.py``).

Candidate surface points farther than ``node_coverage`` from every node
are sampled into new nodes (the port's greedy ``native.sample_nodes``),
wired to their euclidean neighbours, given the transform of their nearest
old node, and refined by a few ARAP-only Gauss-Newton iterations with the
old nodes frozen (``solvers.gauss_newton.solve``). The node arrays are
padded to the node cap, so growth flips padding slots to valid and no
shape changes. The 1- and 9-neighbour queries are ``ops.knn.knn_torch``,
the port of the XLA search the JAX package runs here (kernel K1 takes
k = 4 only and keeps the skinning calls).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from occlusionfusion_tpu_torch.fusion import warpfield as W
from occlusionfusion_tpu_torch.graph import native
from occlusionfusion_tpu_torch.ops.knn import knn_torch
from occlusionfusion_tpu_torch.solvers.gauss_newton import (
    GNConfig,
    GNProblem,
    solve,
)


class GrowthResult(NamedTuple):
    warp: W.WarpFieldState
    node_count: int
    edges: torch.Tensor
    edge_weights: torch.Tensor
    n_new: int


def find_unreachable(points, point_valid, warp: W.WarpFieldState,
                     node_coverage: float):
    """Points farther than ``node_coverage`` from every valid node."""
    d2, _ = knn_torch(points, warp.node_positions, 1, valid=warp.node_valid)
    return point_valid & (d2[:, 0] > node_coverage * node_coverage)


def grow_graph(
    warp: W.WarpFieldState,
    node_count: int,
    edges: torch.Tensor,  # [CAP, K] -1 padded
    edge_weights: torch.Tensor,  # [CAP, K]
    new_surface_points: np.ndarray,  # candidate vertices (host)
    new_point_valid: np.ndarray,
    node_coverage: float,
    num_neighbors: int = 8,
    arap_iters: int = 4,
) -> GrowthResult:
    """New nodes on the unreachable candidates, with euclidean k-NN edges
    (weights exp(-d^2 / 2 coverage^2), normalized), the nearest old
    node's transform, then ARAP refinement of the new nodes only."""
    dev = warp.node_positions.device
    cap = warp.node_positions.shape[0]
    unreachable = find_unreachable(
        torch.as_tensor(np.asarray(new_surface_points, np.float32),
                        device=dev),
        torch.as_tensor(np.asarray(new_point_valid, bool), device=dev),
        warp, node_coverage,
    ).cpu().numpy()
    if not unreachable.any():
        return GrowthResult(warp, node_count, edges, edge_weights, 0)
    candidates = new_surface_points[unreachable]
    new_ids = native.sample_nodes(candidates.astype(np.float32), None,
                                  node_coverage,
                                  max_nodes=cap - node_count)
    n_new = len(new_ids)
    if n_new == 0:
        return GrowthResult(warp, node_count, edges, edge_weights, 0)
    new_nodes = candidates[new_ids]
    new_nodes_t = torch.as_tensor(new_nodes.astype(np.float32), device=dev)

    nodes_np = warp.node_positions.cpu().numpy().copy()
    nodes_np[node_count:node_count + n_new] = new_nodes
    valid_np = warp.node_valid.cpu().numpy().copy()
    valid_np[node_count:node_count + n_new] = True
    total = node_count + n_new

    # euclidean k-NN edges of the new nodes (self dropped)
    edges_np = edges.cpu().numpy().copy()
    ew_np = edge_weights.cpu().numpy().copy()
    d2, idx = knn_torch(new_nodes_t,
                        torch.as_tensor(nodes_np[:total], device=dev),
                        min(num_neighbors + 1, total))
    d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
    sigma2 = 2.0 * node_coverage ** 2
    for i in range(n_new):
        row = node_count + i
        sel = [(j, dd) for j, dd in zip(idx[i], d2[i]) if j != row][
            :num_neighbors]
        ids = np.asarray([j for j, _ in sel], np.int32)
        ws = np.exp(-np.asarray([dd for _, dd in sel]) / sigma2)
        edges_np[row, :len(ids)] = ids
        ew_np[row, :len(ids)] = (ws / max(ws.sum(), 1e-12)).astype(
            np.float32)

    # warm start: the nearest old node's transform
    _, idx_old = knn_torch(new_nodes_t, warp.node_positions, 1,
                           valid=warp.node_valid)
    nearest = idx_old[:, 0].long()
    R = warp.rotations.clone()
    t = warp.translations.clone()
    R[node_count:total] = R[nearest]
    t[node_count:total] = t[nearest]
    new_warp = W.WarpFieldState(
        node_positions=torch.as_tensor(nodes_np, device=dev),
        node_valid=torch.as_tensor(valid_np, device=dev),
        rotations=R, translations=t,
    )
    edges_t = torch.as_tensor(edges_np, device=dev)
    ew_t = torch.as_tensor(ew_np, device=dev)

    # ARAP refinement of the new nodes only, the data term off
    solve_mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    solve_mask[node_count:total] = True
    zeros3 = torch.zeros((8, 3), dtype=torch.float32, device=dev)
    problem = GNProblem(
        source_points=zeros3,
        point_anchors=torch.zeros((8, 4), dtype=torch.int32, device=dev),
        point_weights=torch.zeros((8, 4), dtype=torch.float32, device=dev),
        target_points=zeros3,
        point_valid=torch.zeros(8, dtype=torch.float32, device=dev),
        nodes=new_warp.node_positions,
        node_valid=new_warp.node_valid,
        edges=edges_t,
        edge_weights=ew_t,
        motion_targets=torch.zeros((cap, 3), dtype=torch.float32,
                                   device=dev),
        motion_confidence=torch.zeros(cap, dtype=torch.float32, device=dev),
        solve_node_mask=solve_mask,
    )
    res = solve(problem,
                GNConfig(iters=arap_iters, cg_iters=24, w_point=0.0,
                         w_arap=1.0),
                init_rotations=new_warp.rotations,
                init_translations=new_warp.translations)
    new_warp = new_warp._replace(rotations=res.rotations,
                                 translations=res.translations)
    return GrowthResult(new_warp, total, edges_t, ew_t, n_new)
