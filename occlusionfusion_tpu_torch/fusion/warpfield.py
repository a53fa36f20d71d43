"""Warp field: per-node transforms and skinning tables (port of
``occlusionfusion_tpu/fusion/warpfield.py``).

Node transforms are pivoted: y = R (x - g) + g + t. The origin form
t' = t + g - R g is used only at the LBS kernel boundary (ops/lbs.py).
Unreachable points (not every anchor within coverage) pass through
undeformed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp, ed_warp_normals
from occlusionfusion_tpu_torch.geometry.skinning import skinning_weights

GRAPH_K = 4  # anchors per point


class SkinTable(NamedTuple):
    anchors: torch.Tensor  # [P, K] int32
    weights: torch.Tensor  # [P, K] f32
    valid: torch.Tensor  # [P] bool


class WarpFieldState(NamedTuple):
    node_positions: torch.Tensor  # [N, 3] canonical
    node_valid: torch.Tensor  # [N] bool
    rotations: torch.Tensor  # [N, 3, 3] canonical -> current
    translations: torch.Tensor  # [N, 3] pivoted

    @property
    def deformed_nodes(self) -> torch.Tensor:
        return self.node_positions + self.translations


def create_warpfield(node_positions, node_valid) -> WarpFieldState:
    n = node_positions.shape[0]
    dev = node_positions.device
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(n, 3, 3)
    return WarpFieldState(
        node_positions=node_positions.to(torch.float32),
        node_valid=node_valid.to(torch.bool),
        rotations=eye.contiguous(),
        translations=torch.zeros((n, 3), dtype=torch.float32, device=dev),
    )


def skin(state: WarpFieldState, points, node_coverage: float) -> SkinTable:
    """4-anchor Gaussian skinning table; every anchor must lie within
    4 * node_coverage, weights normalized with +1e-6."""
    anchors, weights, valid = skinning_weights(
        points, state.node_positions, state.node_valid, node_coverage,
        k=GRAPH_K, require_all_anchors=True, norm_eps=1e-6,
    )
    return SkinTable(anchors=anchors, weights=weights, valid=valid)


def deform_points(state: WarpFieldState, points, table: SkinTable):
    """Warp points; unreachable points pass through unchanged."""
    warped = ed_warp(
        points, state.node_positions, state.rotations, state.translations,
        table.anchors, table.weights,
    )
    return torch.where(table.valid[:, None], warped, points)


def deform_normals(state: WarpFieldState, normals, table: SkinTable):
    """Rotate normals; unreachable points keep theirs."""
    rotated = ed_warp_normals(normals, state.rotations, table.anchors,
                              table.weights)
    return torch.where(table.valid[:, None], rotated, normals)


def update_transforms(state: WarpFieldState, rotations, translations):
    return state._replace(rotations=rotations, translations=translations)


def to_origin_form(state: WarpFieldState):
    """Pivoted (R, t) -> origin-relative t' = -R g + g + t."""
    g = state.node_positions
    Rg = torch.einsum("nij,nj->ni", state.rotations, g)
    return state.rotations, state.translations + g - Rg


def from_origin_form(node_positions, rotations, translations_origin):
    """Origin-relative t' -> pivoted t = t' - g + R g."""
    Rg = torch.einsum("nij,nj->ni", rotations, node_positions)
    return rotations, translations_origin - node_positions + Rg


def left_compose_rigid(state: WarpFieldState, R, t) -> WarpFieldState:
    """A global rigid (R [3, 3], t [3]) applied after the warp (pose-graph
    re-anchoring): y = R_n (x - g) + g + t_n composes to R_n' = R R_n,
    t_n' = R (g + t_n) + t - g."""
    g = state.node_positions
    new_R = torch.einsum("ij,njk->nik", R, state.rotations)
    new_t = (g + state.translations) @ R.T + t - g
    return state._replace(rotations=new_R, translations=new_t)
