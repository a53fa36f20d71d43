"""Warp-field cost terms of N-ICP (port of
``occlusionfusion_tpu/solvers/losses.py``).

ARAP, landmark, confidence-weighted motion and temporal smoothness, on
static-shape padded tensors with validity masks, differentiable by
autograd. The truncated chamfer, silhouette and projective-depth terms
are not ported: their weights are 0 by default, and ``nicp.solve``
raises when one is set.
"""

from __future__ import annotations

import torch


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


def smoothness_cost(current: torch.Tensor,
                    previous: torch.Tensor) -> torch.Tensor:
    """mean((x - x_prev)^2) temporal smoothness."""
    return torch.mean((current - previous) ** 2)
