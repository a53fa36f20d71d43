"""Gauss-Newton problem types (port of the parts of
``occlusionfusion_tpu/solvers/gauss_newton.py`` the dense solver uses).

Only the isotropic point-to-point data term (the JAX ``point3d``) and the
Cholesky linear solver are ported. The normal equations are always
assembled by blocks: kernels K3 and K4 on CUDA tensors (the JAX
``assembly="blocks_pallas_full"``), their twins on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GNConfig(NamedTuple):
    iters: int = 10
    lm_damping: float = 1e-4
    w_point: float = 1.0
    w_arap: float = 2.0
    w_motion: float = 0.0
    linear_solver: str = "cholesky"


class GNProblem(NamedTuple):
    """Static-shape problem data (padded + masked)."""

    source_points: torch.Tensor  # [P, 3]
    point_anchors: torch.Tensor  # [P, K]
    point_weights: torch.Tensor  # [P, K]
    target_points: torch.Tensor  # [P, 3]
    point_valid: torch.Tensor  # [P] f32 correspondence weights in [0, 1]
    nodes: torch.Tensor  # [N, 3]
    node_valid: torch.Tensor  # [N]
    edges: torch.Tensor  # [N, K_e] -1 padded
    edge_weights: torch.Tensor  # [N, K_e]
    motion_targets: torch.Tensor  # [N, 3]
    motion_confidence: torch.Tensor  # [N]
    solve_node_mask: torch.Tensor  # [N] True = free


class GNResult(NamedTuple):
    rotations: torch.Tensor
    translations: torch.Tensor
    warped_points: torch.Tensor
    residual_history: torch.Tensor  # [iters] total squared residual
    valid: torch.Tensor  # 0-d bool: every iteration finite


def check_config(config: GNConfig) -> None:
    if config.linear_solver != "cholesky":
        raise NotImplementedError(
            f"linear_solver={config.linear_solver!r} is not ported "
            "(cholesky only)"
        )


def data_residual_rows(warped, targets, point_valid, sw: float):
    """Weighted point3d data residual [P, 3]: sw * pv * (warped - y), with
    sw = sqrt(w_point); the point weight pv enters once."""
    return sw * point_valid[:, None] * (warped - targets)
