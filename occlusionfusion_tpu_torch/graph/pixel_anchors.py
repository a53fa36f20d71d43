"""Pixel anchors: per-pixel skinning tables for image-space solvers (port
of ``occlusionfusion_tpu/graph/pixel_anchors.py``).

Every valid pixel of a depth frame gets up to K anchor nodes and
normalized Gaussian weights. The euclidean variant skins the point image
through ``geometry/skinning.py`` (kernel K1 on CUDA tensors); the
geodesic variant runs the native library's per-vertex Dijkstra through
the depth mesh and maps the result back through its vertex map.
"""

from __future__ import annotations

import numpy as np
import torch

from occlusionfusion_tpu_torch.device import resolve_device
from occlusionfusion_tpu_torch.geometry.skinning import skinning_weights
from occlusionfusion_tpu_torch.graph import native


def pixel_anchors_euclidean(point_image, nodes, node_valid,
                            node_coverage: float, k: int = 4, device=None):
    """[H, W, 3] point image -> (anchors [H, W, k] int32 (-1 invalid),
    weights [H, W, k]) as numpy arrays; the skinning runs on ``device``
    (the card by default)."""
    dev = resolve_device(device)
    H, W, _ = point_image.shape
    pts = torch.as_tensor(np.ascontiguousarray(point_image, np.float32),
                          device=dev).reshape(-1, 3)
    nodes_t = torch.as_tensor(np.ascontiguousarray(nodes, np.float32),
                              device=dev)
    valid_t = (None if node_valid is None else
               torch.as_tensor(np.asarray(node_valid, bool), device=dev))
    anchors, weights, reachable = skinning_weights(
        pts, nodes_t, valid_t, node_coverage, k=k, require_all_anchors=True,
        norm_eps=1e-6)
    ok = (reachable & (pts[:, 2] > 0))[:, None]
    anchors = torch.where(ok, anchors, torch.full_like(anchors, -1))
    weights = torch.where(ok, weights, torch.zeros_like(weights))
    return (anchors.cpu().numpy().reshape(H, W, k),
            weights.cpu().numpy().reshape(H, W, k))


def pixel_anchors_geodesic(point_image: np.ndarray, max_triangle_edge: float,
                           node_vertex_ids: np.ndarray, node_coverage: float,
                           k: int = 4, influence_sigmas: float = 4.0):
    """Geodesic pixel anchors through the depth mesh (host only): returns
    (anchors [H, W, k], weights [H, W, k], mesh (verts, faces, vertex_map))."""
    H, W, _ = point_image.shape
    verts, faces, vmap = native.mesh_from_depth(point_image,
                                                max_triangle_edge)
    anchors_v, dists_v = native.geodesic_anchors(
        verts, faces, node_vertex_ids, k=k,
        max_influence=influence_sigmas * node_coverage,
    )
    w_v = np.exp(-np.square(dists_v) / (2.0 * node_coverage**2))
    w_v[anchors_v < 0] = 0.0
    s = w_v.sum(-1, keepdims=True)
    w_v = np.where(s > 0, w_v / (s + 1e-6), 0.0)
    anchors = -np.ones((H * W, k), np.int32)
    weights = np.zeros((H * W, k), np.float32)
    flat_map = vmap.reshape(-1)
    has_vertex = flat_map >= 0
    anchors[has_vertex] = anchors_v[flat_map[has_vertex]]
    weights[has_vertex] = w_v[flat_map[has_vertex]]
    return (anchors.reshape(H, W, k), weights.reshape(H, W, k),
            (verts, faces, vmap))
