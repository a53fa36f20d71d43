"""Warp-field cost terms of N-ICP (port of
``occlusionfusion_tpu/solvers/losses.py``).

ARAP, landmark, truncated chamfer, confidence-weighted motion,
silhouette, projective depth and temporal smoothness, on static-shape
padded tensors with validity masks, differentiable by autograd. The
chamfer cost takes its random subsample as index tensors (the JAX
package draws it from a PRNG key inside the cost), so a caller can hand
it the JAX package's own indices and a captured solve draws nothing.
"""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch.ops.knn import knn_torch


def arap_cost(
    rotations: torch.Tensor,  # [N, 3, 3]
    translations: torch.Tensor,  # [N, 3] (pivoted)
    nodes: torch.Tensor,  # [N, 3]
    edges: torch.Tensor,  # [N, K] int, -1 padded
    edge_weights: torch.Tensor,  # [N, K], 0 on padding
) -> torch.Tensor:
    """sum_ij w_ij || R_i (g_j - g_i) + g_i + t_i - (g_j + t_j) ||^2."""
    e = torch.clamp(edges, min=0).long()
    g_i = nodes[:, None]
    g_j = nodes[e]
    t_j = translations[e]
    rotated = torch.einsum("nij,nkj->nki", rotations, g_j - g_i)
    resid = rotated + g_i + translations[:, None] - g_j - t_j
    per_edge = torch.sum(resid * resid, dim=-1)
    w = torch.where(edges >= 0, edge_weights, torch.zeros_like(edge_weights))
    return torch.sum(w * per_edge)


def landmark_cost(
    warped: torch.Tensor,  # [P, 3]
    targets: torch.Tensor,  # [M, 3]
    src_idx: torch.Tensor,  # [L] into warped
    tgt_idx: torch.Tensor,  # [L] into targets
    mask: torch.Tensor | None = None,  # [L] bool gate or float weights
) -> torch.Tensor:
    """Sum over correspondences of the squared distance; ``mask`` is a
    gate (bool) or continuous correspondence weights (float)."""
    diff = warped[src_idx.long()] - targets[tgt_idx.long()]
    sq = torch.sum(diff * diff, dim=-1)
    if mask is not None:
        sq = sq * mask.to(sq.dtype)
    return torch.sum(sq)


def truncated_chamfer_cost(
    src: torch.Tensor,  # [P, 3]
    tgt: torch.Tensor,  # [Q, 3]
    src_idx: torch.Tensor,  # [S] subsample of src
    tgt_idx: torch.Tensor,  # [T] subsample of tgt
    src_valid: torch.Tensor | None = None,  # [P] bool
    tgt_valid: torch.Tensor | None = None,  # [Q] bool
    trunc: float = 0.3,
) -> torch.Tensor:
    """Symmetric chamfer over the subsamples src[src_idx], tgt[tgt_idx]:
    each side's squared distance to its nearest valid point of the other
    (``knn_torch``, k = 1), zeroed at or beyond ``trunc`` and where the
    side's own point is invalid, summed."""
    s, t = src[src_idx.long()], tgt[tgt_idx.long()]
    sv = src_valid[src_idx.long()] if src_valid is not None else None
    tv = tgt_valid[tgt_idx.long()] if tgt_valid is not None else None
    d2_st = knn_torch(s, t, 1, valid=tv)[0][:, 0]
    d2_ts = knn_torch(t, s, 1, valid=sv)[0][:, 0]
    zero = torch.zeros((), dtype=d2_st.dtype, device=d2_st.device)
    d2_st = torch.where(d2_st < trunc, d2_st, zero)
    d2_ts = torch.where(d2_ts < trunc, d2_ts, zero)
    if sv is not None:
        d2_st = torch.where(sv, d2_st, zero)
    if tv is not None:
        d2_ts = torch.where(tv, d2_ts, zero)
    return torch.sum(d2_st) + torch.sum(d2_ts)


def motion_cost(
    nodes: torch.Tensor,  # [N, 3]
    translations: torch.Tensor,  # [N, 3]
    target_locations: torch.Tensor,  # [N, 3] predicted deformed positions
    confidence: torch.Tensor,  # [N]
    node_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """mean(conf^2 * ||g + t - target||^2) over the valid nodes' entries
    (the paper's confidence^2 form)."""
    resid = nodes + translations - target_locations
    per = confidence[:, None] ** 2 * (resid * resid)
    if node_valid is None:
        return torch.sum(per) / per.numel()
    per = torch.where(node_valid[:, None], per, torch.zeros_like(per))
    denom = torch.clamp(torch.sum(node_valid) * 3, min=1)
    return torch.sum(per) / denom


def silhouette_cost(src_mask: torch.Tensor,
                    tgt_mask: torch.Tensor) -> torch.Tensor:
    """Share of the pixels outside the target silhouette that the source
    silhouette covers. As in the JAX package the source mask is a
    boolean splat cast to f32, so this cost has no gradient: its weight
    changes the loss and the early stop, never a node (ROADMAP F15)."""
    outside = torch.where(~tgt_mask, src_mask.to(torch.float32),
                          torch.zeros((), device=src_mask.device))
    denom = torch.clamp(torch.sum(~tgt_mask), min=1)
    return torch.sum(outside * outside) / denom


def projective_depth_cost(src_depth: torch.Tensor,
                          tgt_depth: torch.Tensor) -> torch.Tensor:
    """Mean squared depth difference over the pixels both maps observe."""
    both = (src_depth > 0) & (tgt_depth > 0)
    err = torch.where(both, (src_depth - tgt_depth) ** 2,
                      torch.zeros((), device=src_depth.device))
    return torch.sum(err) / torch.clamp(torch.sum(both), min=1)


def smoothness_cost(current: torch.Tensor,
                    previous: torch.Tensor) -> torch.Tensor:
    """mean((x - x_prev)^2) temporal smoothness."""
    return torch.mean((current - previous) ** 2)
