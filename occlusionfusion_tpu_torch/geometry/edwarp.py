"""Embedded-deformation warp (port of ``occlusionfusion_tpu/geometry/edwarp.py``).

y = sum_k w_k (R_k (x - g_k) + g_k + t_k), the pivoted form, as gathers
and a batched product. Padded anchors carry zero weight.
"""

from __future__ import annotations

import torch


def ed_warp(
    points: torch.Tensor,  # [P, 3]
    node_positions: torch.Tensor,  # [N, 3]
    node_rotations: torch.Tensor,  # [N, 3, 3]
    node_translations: torch.Tensor,  # [N, 3]
    anchors: torch.Tensor,  # [P, K]
    anchor_weights: torch.Tensor,  # [P, K]
) -> torch.Tensor:
    """[P, 3] warped points."""
    a = anchors.long()
    g = node_positions[a]  # [P, K, 3]
    R = node_rotations[a]  # [P, K, 3, 3]
    t = node_translations[a]
    local = points[:, None, :] - g
    rotated = torch.einsum("pkij,pkj->pki", R, local)
    return torch.sum(anchor_weights[..., None] * (rotated + g + t), dim=1)
