"""The fused per-frame fusion step (port of
``occlusionfusion_tpu/fusion/fused_step.py``).

One frame: deform the model, projective correspondences and node
visibility, optionally PWC flow correspondences weighted by MaskNet,
per-node motion observations, motion completion, the dense Gauss-Newton
warp solve, then the voxel LBS warp (kernel K2 on CUDA) and the TSDF
integrate. The graph-dependent tables are device-resident constants
between keyframes. Nothing in the step reads a value back to the host,
so frames queue on the card back to back.

Ported: ``solver="gn_dense"`` with projective correspondences, the
motion GNN and flow in the JAX defaults' mode (fill, dense lift, MaskNet
weights at full resolution); ``FusionConfig`` (``fusion/pipeline.py``)
rejects the settings of the branches not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch.fusion import tsdf as T
from occlusionfusion_tpu_torch.fusion import warpfield as W
from occlusionfusion_tpu_torch.fusion.correspondence import (
    node_motion_observations,
    projective_correspondences,
)
from occlusionfusion_tpu_torch.fusion.motion_runner import (
    LEVEL_SIZES,
    MotionRunnerState,
    _unpack_pyramid,
    motion_step,
)
from occlusionfusion_tpu_torch.fusion.flow_correspondence import (
    flow_correspondences,
    sample_weight_field,
)
from occlusionfusion_tpu_torch.geometry.camera import (
    Intrinsics,
    backproject_depth,
    bilinear_sample,
)
from occlusionfusion_tpu_torch.ops.lbs import lbs_warp
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig, GNProblem
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import solve_dense


class FusionTables(NamedTuple):
    """Device-resident per-graph constants (rebuilt at keyframes only)."""

    vox_points: torch.Tensor  # [V, 3]
    vox_anchors: torch.Tensor  # [V, K]
    vox_weights: torch.Tensor  # [V, K]
    vox_valid: torch.Tensor  # [V]
    model_points: torch.Tensor  # [P, 3]
    model_valid: torch.Tensor  # [P]
    point_anchors: torch.Tensor  # [P, K]
    point_weights: torch.Tensor  # [P, K]
    point_valid: torch.Tensor  # [P]
    nodes: torch.Tensor  # [N, 3]
    node_valid: torch.Tensor  # [N]
    edges: torch.Tensor  # [N, K_e]
    edge_weights: torch.Tensor  # [N, K_e]
    pyramid_ints: torch.Tensor  # packed pyramid (motion_runner layout)
    n_nodes: torch.Tensor  # 0-d int32


class FusionStepState(NamedTuple):
    tsdf: T.TSDFState
    rotations: torch.Tensor  # [N, 3, 3] canonical -> current
    translations: torch.Tensor  # [N, 3]
    motion: MotionRunnerState
    # the previous frame's RGB-XYZ image [6, H, W], the flow source (None
    # unless the step runs flow)
    prev_rgbxyz: torch.Tensor = None


# MaskNet weight a flow correspondence must exceed (the JAX package's
# default flow_mask_threshold)
FLOW_MASK_THRESHOLD = 0.35


class FusedStepConfig(NamedTuple):
    tsdf: T.TSDFConfig
    gn: GNConfig
    max_depth_diff: float = 0.1
    use_motion_model: bool = True
    # pyramid padding buckets; must equal level_sizes_for(node cap)
    motion_levels: tuple = LEVEL_SIZES
    # PWC flow + MaskNet correspondences, "fill" mode: flow targets only
    # for points without a projective target, where the sampled MaskNet
    # weight exceeds FLOW_MASK_THRESHOLD
    use_flow: bool = False


def _rgbxyz_image(depth, color, intr: Intrinsics):
    """[6, H, W]: RGB in 0..1, then the camera-space point image (the
    PWC/MaskNet input)."""
    xyz = backproject_depth(depth, intr)
    return torch.cat([color.permute(2, 0, 1) / 255.0, xyz.permute(2, 0, 1)])


@torch.no_grad()
def fused_register_frame(
    config: FusedStepConfig,
    state: FusionStepState,
    tables: FusionTables,
    motion_net,
    depth: torch.Tensor,  # [H, W]
    color: torch.Tensor,  # [H, W, 3]
    intr: Intrinsics,
    flow_net=None,
    mask_net=None,
):
    """One frame. Returns (state, info [6] f32: final_loss,
    n_correspondences, n_visible_nodes, mean_conf, solve_valid,
    n_flow_filled). With ``config.use_flow`` the PWC ``flow_net`` and
    ``mask_net`` are required and ``state.prev_rgbxyz`` holds the
    previous frame."""
    warp = W.WarpFieldState(
        node_positions=tables.nodes,
        node_valid=tables.node_valid,
        rotations=state.rotations,
        translations=state.translations,
    )
    point_table = W.SkinTable(
        tables.point_anchors, tables.point_weights, tables.point_valid
    )

    # 1. deform model + nodes
    deformed_pts = W.deform_points(warp, tables.model_points, point_table)
    deformed_nodes = warp.deformed_nodes

    # 2. correspondences + visibility
    targets, corr_valid = projective_correspondences(
        deformed_pts, tables.model_valid & tables.point_valid, depth, intr,
        max_depth_diff=config.max_depth_diff,
    )
    node_visible, _ = T.check_visibility(
        deformed_nodes, depth, intr, config.tsdf.trunc_margin
    )
    node_visible = node_visible & tables.node_valid
    corr_weight = corr_valid.to(torch.float32)

    # 2b. flow correspondences: PWC prev -> current lifted to per-pixel
    # targets, sampled at the deformed points' projections, MaskNet-gated
    # and -weighted; they fill only points without a projective target
    cur_rgbxyz = state.prev_rgbxyz
    flow_ok = torch.zeros_like(corr_valid)
    if config.use_flow:
        cur_rgbxyz = _rgbxyz_image(depth, color, intr)
        z = torch.clamp(deformed_pts[:, 2], min=1e-6)
        u = deformed_pts[:, 0] / z * intr.fx + intr.cx
        v = deformed_pts[:, 1] / z * intr.fy + intr.cy
        h_im, w_im = depth.shape
        inb = (u >= 0) & (u <= w_im - 1) & (v >= 0) & (v <= h_im - 1)
        _, flow_targets, flow_valid, flow_weights = flow_correspondences(
            flow_net, state.prev_rgbxyz, cur_rgbxyz, mask_net
        )
        uv = torch.stack([u, v], dim=-1)
        sampled = bilinear_sample(flow_targets, uv)
        vsamp = bilinear_sample(
            flow_valid[..., None].to(torch.float32), uv
        )[:, 0]
        wsamp = sample_weight_field(flow_weights, u, v)
        flow_ok = (
            inb & (vsamp > 0.5) & (deformed_pts[:, 2] > 0)
            & (wsamp > FLOW_MASK_THRESHOLD) & ~corr_valid
        )
        corr_weight = torch.where(
            flow_ok, torch.clamp(wsamp, 0.0, 1.0), corr_weight
        )
        targets = torch.where(flow_ok[:, None], sampled, targets)
        corr_valid = corr_valid | flow_ok

    # 3. per-node motion observations
    node_motion, node_observed = node_motion_observations(
        deformed_pts, targets, corr_valid, tables.point_anchors,
        tables.point_weights, deformed_nodes, node_visible,
    )

    # 4. motion completion
    if config.use_motion_model and motion_net is not None:
        pyramid = _unpack_pyramid(tables.pyramid_ints, config.motion_levels)
        motion_state, (completed, conf) = motion_step(
            motion_net, state.motion, deformed_nodes, node_motion,
            node_observed, tables.n_nodes, pyramid,
            n0_cap=config.motion_levels[0],
        )
        motion_targets = deformed_nodes + completed
        motion_conf = conf[:, 0]
    else:
        motion_state = state.motion
        motion_targets = deformed_nodes + node_motion
        motion_conf = node_observed.to(torch.float32)

    # 5. warp solve, warm started at the current transforms
    problem = GNProblem(
        source_points=tables.model_points,
        point_anchors=tables.point_anchors,
        point_weights=tables.point_weights,
        target_points=targets,
        point_valid=corr_weight,
        nodes=tables.nodes,
        node_valid=tables.node_valid,
        edges=tables.edges,
        edge_weights=tables.edge_weights,
        motion_targets=motion_targets,
        motion_confidence=motion_conf,
        solve_node_mask=tables.node_valid,
    )
    result = solve_dense(
        problem, config.gn, init_rotations=state.rotations,
        init_translations=state.translations,
    )

    # 6. integrate through the updated warp
    new_warp = warp._replace(
        rotations=result.rotations, translations=result.translations
    )
    # kernel K2 on CUDA tensors, its twin on CPU tensors (the JAX
    # lbs_impl="auto" choice, made here from the device)
    warped_vox = lbs_warp(
        tables.vox_points, tables.vox_anchors, tables.vox_weights,
        tables.vox_valid, new_warp,
    )
    new_tsdf = T.integrate(
        config.tsdf, state.tsdf, warped_vox, tables.vox_valid, depth, color,
        intr,
    )

    info = torch.stack([
        result.residual_history[-1],
        torch.sum(corr_valid).to(torch.float32),
        torch.sum(node_visible).to(torch.float32),
        torch.sum(motion_conf) / torch.clamp(
            torch.sum(tables.node_valid), min=1
        ).to(torch.float32),
        result.valid.to(torch.float32),
        torch.sum(flow_ok).to(torch.float32),
    ])
    new_state = FusionStepState(
        tsdf=new_tsdf,
        rotations=result.rotations,
        translations=result.translations,
        motion=motion_state,
        prev_rgbxyz=cur_rgbxyz,
    )
    return new_state, info
