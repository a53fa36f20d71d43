"""Ground-truth derivation for neural-tracking training (port of
``occlusionfusion_tpu/ops/gt_helpers.py``): from a source point image,
its ground-truth scene flow and the target point image, (a) the deformed
ground-truth points the warp loss supervises against and (b) the binary
mask-training target, the pixels whose flowed position lands on
observed, depth-consistent target geometry."""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch.geometry.camera import (
    Intrinsics,
    bilinear_sample,
)


def deformed_gt_points(source_xyz, scene_flow):
    """[H, W, 3] source points and flow -> (deformed points [H, W, 3],
    validity [H, W]: source depth > 0); invalid pixels get 0."""
    valid = source_xyz[..., 2] > 0
    out = torch.where(valid[..., None], source_xyz + scene_flow,
                      torch.zeros_like(source_xyz))
    return out, valid


def mask_gt(source_xyz, scene_flow, target_xyz, intr: Intrinsics,
            max_depth_diff: float = 0.05):
    """[H, W] bool: the pixel has depth, its flowed position projects
    inside the image, and the target's depth there (bilinear) is positive
    and within ``max_depth_diff`` of it."""
    H, W, _ = source_xyz.shape
    deformed, src_valid = deformed_gt_points(source_xyz, scene_flow)
    z = torch.clamp(deformed[..., 2], min=1e-6)
    u = deformed[..., 0] / z * intr.fx + intr.cx
    v = deformed[..., 1] / z * intr.fy + intr.cy
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    uv = torch.stack([u, v], dim=-1).reshape(-1, 2)
    tgt_depth = bilinear_sample(target_xyz[..., 2:3], uv).reshape(H, W)
    agree = torch.abs(tgt_depth - deformed[..., 2]) < max_depth_diff
    return src_valid & inb & (tgt_depth > 0) & agree
