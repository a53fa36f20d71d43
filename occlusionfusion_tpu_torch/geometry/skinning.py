"""Skinning weights from the k nearest graph nodes (port of
``occlusionfusion_tpu/geometry/skinning.py``): Gaussian weights
exp(-d^2 / (2 sigma^2)) with sigma = node_coverage, anchors beyond
``cutoff_sigmas`` sigma dropped, rows renormalized. The k-NN is
``ops/knn.py`` (kernel K1 on CUDA)."""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch.ops.knn import knn


def skinning_weights(
    points: torch.Tensor,
    node_positions: torch.Tensor,
    node_valid: torch.Tensor | None,
    node_coverage: float,
    k: int = 4,
    cutoff_sigmas: float = 4.0,
    require_all_anchors: bool = False,
    norm_eps: float = 1e-12,
):
    """Returns anchors [P, k] int32, weights [P, k] f32, reachable [P] bool.

    A point is reachable when any anchor survives the cutoff, or with
    ``require_all_anchors`` only when all k do (the warp field's
    contract); ``norm_eps`` is added to the weight sum."""
    dists2, anchors = knn(points, node_positions, k=k, valid=node_valid)
    sigma2 = node_coverage * node_coverage
    in_range = dists2 <= (cutoff_sigmas * node_coverage) ** 2
    w = torch.where(
        in_range, torch.exp(-dists2 / (2.0 * sigma2)), torch.zeros_like(dists2)
    )
    total = torch.sum(w, dim=-1, keepdim=True)
    if require_all_anchors:
        reachable = torch.all(in_range, dim=-1)
    else:
        reachable = total[..., 0] > 1e-12
    w = torch.where(reachable[..., None], w / (total + norm_eps),
                    torch.zeros_like(w))
    return anchors, w, reachable
