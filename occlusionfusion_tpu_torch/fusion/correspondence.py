"""Projective data association, per-node motion observations and the
freezing of match-starved graph components (port of
``occlusionfusion_tpu/fusion/correspondence.py``)."""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch.geometry.camera import Intrinsics


def projective_correspondences(
    deformed_points: torch.Tensor,  # [P, 3]
    point_valid: torch.Tensor,  # [P]
    depth_im: torch.Tensor,  # [H, W]
    intr: Intrinsics,
    max_depth_diff: float = 0.1,
):
    """(targets [P, 3], valid [P]) by same-surface-gated bilinear depth
    association at each deformed point's projection."""
    z = deformed_points[:, 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, torch.ones_like(z))
    u = deformed_points[:, 0] / zs * intr.fx + intr.cx
    v = deformed_points[:, 1] / zs * intr.fy + intr.cy
    targets, dvalid = depth_association_at_pixels(
        u, v, z, depth_im, intr, max_depth_diff
    )
    valid = point_valid & ok & dvalid
    targets = torch.where(valid[:, None], targets, deformed_points)
    return targets, valid


def depth_association_at_pixels(u, v, z_ref, depth_im, intr: Intrinsics,
                                max_depth_diff: float):
    """Bilinear blend of the four pixels around (u, v) whose depth is
    within ``max_depth_diff`` of ``z_ref``; returns the target
    backprojected at (u, v) and its validity."""
    H, W = depth_im.shape
    # clamp before the int cast (the result only feeds in-bounds tests)
    x0 = torch.clamp(torch.floor(u), -(2.0**30), 2.0**30).to(torch.int32)
    y0 = torch.clamp(torch.floor(v), -(2.0**30), 2.0**30).to(torch.int32)
    fu = u - x0.to(torch.float32)
    fv = v - y0.to(torch.float32)
    num = torch.zeros_like(z_ref)
    den = torch.zeros_like(z_ref)
    flat = depth_im.reshape(-1)
    for dy, dx, wgt in (
        (0, 0, (1.0 - fu) * (1.0 - fv)),
        (0, 1, fu * (1.0 - fv)),
        (1, 0, (1.0 - fu) * fv),
        (1, 1, fu * fv),
    ):
        cx_ = x0 + dx
        cy_ = y0 + dy
        inb = (cx_ >= 0) & (cx_ < W) & (cy_ >= 0) & (cy_ < H)
        idx = torch.clamp(cy_, 0, H - 1) * W + torch.clamp(cx_, 0, W - 1)
        dc = flat[idx.long()]
        good = inb & (dc > 0) & (torch.abs(dc - z_ref) < max_depth_diff)
        w = torch.where(good, wgt, torch.zeros_like(wgt))
        num = num + w * dc
        den = den + w
    d = num / torch.clamp(den, min=1e-12)
    valid = (den > 1e-6) & (torch.abs(d - z_ref) < max_depth_diff)
    tx = (u - intr.cx) / intr.fx * d
    ty = (v - intr.cy) / intr.fy * d
    return torch.stack([tx, ty, d], dim=-1), valid


def node_motion_observations(
    deformed_points,  # [P, 3]
    targets,  # [P, 3]
    corr_valid,  # [P]
    point_anchors,  # [P, K]
    point_weights,  # [P, K]
    deformed_nodes,  # [N, 3]
    node_visible,  # [N]
):
    """(node_motion [N, 3], observed [N]): skinning-weighted mean
    displacement of the valid correspondences anchored to each node."""
    n = deformed_nodes.shape[0]
    K = point_anchors.shape[1]
    disp = targets - deformed_points
    w = point_weights * corr_valid[:, None].to(point_weights.dtype)
    flat_anchor = point_anchors.reshape(-1).long()
    flat_w = w.reshape(-1)
    flat_disp = torch.repeat_interleave(disp, K, dim=0)
    num = torch.zeros((n, 3), dtype=disp.dtype, device=disp.device)
    num.index_add_(0, flat_anchor, flat_disp * flat_w[:, None])
    den = torch.zeros((n,), dtype=disp.dtype, device=disp.device)
    den.index_add_(0, flat_anchor, flat_w)
    observed = (den > 1e-6) & node_visible
    motion = torch.where(
        observed[:, None],
        num / torch.clamp(den[:, None], min=1e-6),
        torch.zeros_like(num),
    )
    return motion, observed


def cluster_match_filter(
    point_anchors,  # [P, K] node ids
    point_weights,  # [P, K] skinning weights
    corr_weight,  # [P] correspondence weights in [0, 1]
    node_clusters,  # [N] component id per node (-1 padded)
    node_valid,  # [N]
    min_cluster_weight: float,
):
    """Freeze match-starved graph components: each match's skinning
    weights summed onto its anchor nodes, reduced per connected
    component; every node of a component below ``min_cluster_weight`` is
    frozen, and the matches anchored to any frozen node are dropped.
    Returns (node_solve_mask [N] bool, corr_weight' [P])."""
    n = node_clusters.shape[0]
    w = point_weights * corr_weight[:, None]
    anchors = torch.clamp(point_anchors, min=0).long()
    match_w_node = torch.zeros((n,), dtype=w.dtype, device=w.device)
    match_w_node.index_add_(0, anchors.reshape(-1), w.reshape(-1))
    match_w_node = match_w_node * node_valid.to(w.dtype)
    cid = torch.clamp(node_clusters, 0, n - 1).long()
    cluster_w = torch.zeros((n,), dtype=w.dtype, device=w.device)
    cluster_w.index_add_(0, cid, match_w_node)
    cluster_ok = cluster_w >= min_cluster_weight
    node_ok = cluster_ok[cid] & node_valid & (node_clusters >= 0)
    corr_ok = torch.all(node_ok[anchors], dim=1)
    return node_ok, corr_weight * corr_ok.to(corr_weight.dtype)
