"""Embedded-deformation graph builder, host side (port's own copy of the
mesh route of ``occlusionfusion_tpu/graph/edgraph.py``).

erode mesh -> greedy node sampling at node_coverage -> k=8 geodesic
edges -> drop under-connected nodes -> connected components -> the
4-level pyramid the motion-completion net consumes (coverage doubles per
level, neighbour counts [8, 6, 4, 3]). After graph growth the pyramid is
rebuilt from the nodes alone with euclidean neighbours
(``build_pyramid_from_nodes``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from occlusionfusion_tpu_torch.graph import native

PYRAMID_KS = (8, 6, 4, 3)


@dataclass
class GraphConfig:
    node_coverage: float = 0.05  # meters
    num_neighbors: int = 8
    min_neighbors: int = 2
    erosion_iterations: int = 4
    erosion_min_neighbors: int = 4
    max_triangle_edge: float = 0.05
    max_nodes: int = 4096


@dataclass
class GraphData:
    nodes: np.ndarray  # [N, 3]
    node_indices: np.ndarray  # [N] vertex ids in the source mesh
    edges: np.ndarray  # [N, 8] int32, -1 padded
    edge_weights: np.ndarray  # [N, 8]
    edge_distances: np.ndarray  # [N, 8] geodesic, inf padded
    clusters: np.ndarray  # [N] int32 component id
    cluster_sizes: np.ndarray  # [C]
    pyramid: Dict[str, np.ndarray] = field(default_factory=dict)
    vertices: np.ndarray | None = None
    faces: np.ndarray | None = None


def _edge_weights(dists: np.ndarray, node_coverage: float) -> np.ndarray:
    w = np.exp(-np.square(dists) / (2.0 * node_coverage**2))
    w[~np.isfinite(dists)] = 0.0
    s = w.sum(-1, keepdims=True)
    return np.where(s > 0, w / np.maximum(s, 1e-12), 0.0).astype(np.float32)


def _cleanup_edges(edges: np.ndarray, min_neighbors: int):
    """Iteratively drop nodes with fewer than min_neighbors valid edges."""
    n = edges.shape[0]
    valid = np.ones(n, bool)
    changed = True
    while changed:
        changed = False
        e = np.where(edges >= 0, edges, 0)
        counts = ((edges >= 0) & valid[e]).sum(-1)
        newly_invalid = valid & (counts < min_neighbors)
        if newly_invalid.any():
            valid[newly_invalid] = False
            changed = True
    cleaned = edges.copy()
    e = np.where(cleaned >= 0, cleaned, 0)
    cleaned[(cleaned >= 0) & ~valid[e]] = -1
    return cleaned, valid


def build_graph_from_mesh(vertices: np.ndarray, faces: np.ndarray,
                          config: GraphConfig) -> GraphData:
    keep = native.erode_mesh(
        vertices, faces, config.erosion_iterations,
        config.erosion_min_neighbors,
    )
    if not keep.any():  # tiny meshes: erosion can eat everything
        keep = np.ones(vertices.shape[0], bool)
    node_vertex_ids = native.sample_nodes(
        vertices, keep, config.node_coverage, config.max_nodes
    )
    edges, dists = native.geodesic_edges(
        vertices, faces, node_vertex_ids, k=config.num_neighbors
    )
    edges, valid = _cleanup_edges(edges, config.min_neighbors)
    remap = -np.ones(len(valid), np.int32)
    remap[valid] = np.arange(valid.sum(), dtype=np.int32)
    node_vertex_ids = node_vertex_ids[valid]
    edges = edges[valid]
    dists = dists[valid]
    edges = np.where(edges >= 0, remap[np.where(edges >= 0, edges, 0)], -1)
    dists = np.where(edges >= 0, dists, np.inf).astype(np.float32)

    clusters, sizes = native.compute_clusters(edges)
    data = GraphData(
        nodes=vertices[node_vertex_ids].astype(np.float32),
        node_indices=node_vertex_ids,
        edges=edges.astype(np.int32),
        edge_weights=_edge_weights(dists, config.node_coverage),
        edge_distances=dists,
        clusters=clusters,
        cluster_sizes=sizes,
        vertices=vertices.astype(np.float32),
        faces=faces.astype(np.int32),
    )
    data.pyramid = build_graph_pyramid(data, config)
    return data


def build_graph_from_depth(point_image: np.ndarray,
                           config: GraphConfig) -> GraphData:
    """Depth route: triangulate the [H, W, 3] point image, then build."""
    verts, faces, _ = native.mesh_from_depth(point_image,
                                             config.max_triangle_edge)
    return build_graph_from_mesh(verts, faces, config)


_LATTICE_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                    (1, 0), (1, 1))


def build_regular_graph(point_image: np.ndarray, nodes_x: int, nodes_y: int,
                        max_depth_diff: float = 0.1) -> GraphData:
    """Regular-grid graph over a depth frame: nodes on a uniform pixel
    lattice at valid depth, 8-connected lattice edges, pruned where the
    depth gap exceeds ``max_depth_diff``; the weights' coverage is the
    median edge length."""
    H, W, _ = point_image.shape
    ys = np.linspace(0, H - 1, nodes_y).round().astype(int)
    xs = np.linspace(0, W - 1, nodes_x).round().astype(int)
    grid_pts = point_image[np.ix_(ys, xs)]  # [ny, nx, 3]
    valid = grid_pts[..., 2] > 0
    ids = -np.ones((nodes_y, nodes_x), np.int32)
    ids[valid] = np.arange(valid.sum(), dtype=np.int32)
    n = int(valid.sum())
    edges = -np.ones((n, 8), np.int32)
    dists = np.full((n, 8), np.inf, np.float32)
    for gy, gx in zip(*np.nonzero(valid)):
        a, slot = ids[gy, gx], 0
        for dy, dx in _LATTICE_OFFSETS:
            ny_, nx_ = gy + dy, gx + dx
            if not (0 <= ny_ < nodes_y and 0 <= nx_ < nodes_x):
                continue
            b = ids[ny_, nx_]
            if b < 0 or (abs(grid_pts[gy, gx, 2] - grid_pts[ny_, nx_, 2])
                         > max_depth_diff):
                continue
            edges[a, slot] = b
            dists[a, slot] = np.linalg.norm(grid_pts[gy, gx]
                                            - grid_pts[ny_, nx_])
            slot += 1
    coverage = float(np.nanmedian(dists[np.isfinite(dists)])) if n else 0.05
    clusters, sizes = native.compute_clusters(edges)
    return GraphData(
        nodes=grid_pts[valid].astype(np.float32),
        node_indices=np.flatnonzero(valid.reshape(-1)).astype(np.int32),
        edges=edges,
        edge_weights=_edge_weights(dists, coverage or 0.05),
        edge_distances=dists,
        clusters=clusters,
        cluster_sizes=sizes,
    )


def _greedy_subsample(old_nodes: np.ndarray, coverage: float):
    """Greedy subsample with nearest-accepted up-map."""
    down_idx: list[int] = []
    up_idx: list[int] = []
    for i in range(old_nodes.shape[0]):
        if not down_idx:
            up_idx.append(0)
            down_idx.append(i)
            continue
        d = np.linalg.norm(old_nodes[down_idx] - old_nodes[i], axis=1)
        nearest = int(np.argmin(d))
        up_idx.append(nearest)
        if d[nearest] < coverage:
            continue
        down_idx.append(i)
    return down_idx, up_idx


def build_graph_pyramid(data: GraphData, config: GraphConfig):
    """4-level pyramid (nn_index_l{0..3}, down_sample_idx{1..3},
    up_sample_idx{1..3})."""
    pyd: Dict[str, np.ndarray] = {"nn_index_l0": data.edges.astype(np.int16)}
    old_nodes = data.nodes
    node_vertex_ids = data.node_indices
    coverage = config.node_coverage
    for level in range(1, 4):
        coverage *= 2.0
        down_idx, up_idx = _greedy_subsample(old_nodes, coverage)
        node_vertex_ids = node_vertex_ids[down_idx]
        edges, _ = native.geodesic_edges(
            data.vertices, data.faces, node_vertex_ids, k=PYRAMID_KS[level]
        )
        pyd[f"down_sample_idx{level}"] = np.asarray(down_idx, np.int16)
        pyd[f"up_sample_idx{level}"] = np.asarray(up_idx, np.int16)
        pyd[f"nn_index_l{level}"] = edges.astype(np.int16)
        old_nodes = old_nodes[down_idx]
    return pyd


def _euclidean_knn_edges(points: np.ndarray, k: int) -> np.ndarray:
    """[n, k] nearest-neighbour table (self excluded), -1 padded, each row
    ordered by distance."""
    n = points.shape[0]
    out = -np.ones((n, k), np.int32)
    if n <= 1:
        return out
    d = np.linalg.norm(points[:, None] - points[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    k_eff = min(k, n - 1)
    idx = np.argpartition(d, k_eff - 1, axis=1)[:, :k_eff]
    order = np.argsort(np.take_along_axis(d, idx, axis=1), axis=1)
    out[:, :k_eff] = np.take_along_axis(idx, order, axis=1).astype(np.int32)
    return out


def build_pyramid_from_nodes(nodes: np.ndarray, node_coverage: float,
                             edges: np.ndarray | None = None,
                             ks=PYRAMID_KS) -> Dict[str, np.ndarray]:
    """The pyramid rebuilt without a source mesh (growth keyframes): level
    0 is the live graph's edge table (or euclidean k-NN without one), the
    coarser levels euclidean k-NN over the greedy-subsampled node sets,
    coverage doubling per level."""
    l0 = edges if edges is not None else _euclidean_knn_edges(nodes, ks[0])
    pyd: Dict[str, np.ndarray] = {"nn_index_l0": l0.astype(np.int16)}
    old_nodes = nodes
    coverage = node_coverage
    for level in range(1, 4):
        coverage *= 2.0
        down_idx, up_idx = _greedy_subsample(old_nodes, coverage)
        sub = old_nodes[down_idx]
        pyd[f"down_sample_idx{level}"] = np.asarray(down_idx, np.int16)
        pyd[f"up_sample_idx{level}"] = np.asarray(up_idx, np.int16)
        pyd[f"nn_index_l{level}"] = _euclidean_knn_edges(
            sub, ks[level]).astype(np.int16)
        old_nodes = sub
    return pyd
