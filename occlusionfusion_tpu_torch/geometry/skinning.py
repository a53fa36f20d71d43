"""Skinning weights from the k nearest graph nodes (port of
``occlusionfusion_tpu/geometry/skinning.py``): Gaussian weights
exp(-d^2 / (2 sigma^2)), and a point is reachable only when all k anchors
lie within CUTOFF_SIGMAS sigma; rows are renormalized. These are the
settings ``fusion/warpfield.py`` skins with. The k-NN is ``ops/knn.py``
(kernel K1 on CUDA)."""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch.ops.knn import knn

CUTOFF_SIGMAS = 4.0
NORM_EPS = 1e-6


def skinning_weights(
    points: torch.Tensor,
    node_positions: torch.Tensor,
    node_valid: torch.Tensor | None,
    node_coverage: float,
    k: int = 4,
):
    """Returns anchors [P, k] int32, weights [P, k] f32, reachable [P] bool."""
    dists2, anchors = knn(points, node_positions, k=k, valid=node_valid)
    sigma2 = node_coverage * node_coverage
    in_range = dists2 <= (CUTOFF_SIGMAS * node_coverage) ** 2
    w = torch.where(
        in_range, torch.exp(-dists2 / (2.0 * sigma2)), torch.zeros_like(dists2)
    )
    total = torch.sum(w, dim=-1, keepdim=True)
    reachable = torch.all(in_range, dim=-1)
    w = torch.where(reachable[..., None], w / (total + NORM_EPS),
                    torch.zeros_like(w))
    return anchors, w, reachable
