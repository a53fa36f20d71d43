"""Optical-flow correspondences (port of
``occlusionfusion_tpu/fusion/flow_correspondence.py``, full resolution
only).

PWC-Net between the previous and the current RGB-XYZ frame, the quarter-
resolution flow upsampled x4 and scaled x20, lifted to per-pixel 3-D
targets by bilinearly sampling the current point image at the flowed
pixels, and weighted per pixel by MaskNet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from occlusionfusion_tpu_torch.geometry.camera import bilinear_sample

FLOW_SCALE = 20.0  # PWC predicts flow / 20 at quarter resolution


def flow_correspondences(pwc, source_rgbxyz, target_rgbxyz, mask_net):
    """source/target RGB-XYZ [6, H, W] -> (flow [H, W, 2] in pixels,
    target_points [H, W, 3], valid [H, W], weights [H, W]).

    A sample is valid where it lands inside the image and both the source
    depth and the sampled target depth are positive; the MaskNet weight is
    0 elsewhere."""
    H, W = source_rgbxyz.shape[1:]
    # PWC's 6-level pyramid needs multiples of 64: zero-pad bottom/right
    Hp = -(-H // 64) * 64
    Wp = -(-W // 64) * 64
    src_p = F.pad(source_rgbxyz, (0, Wp - W, 0, Hp - H))[None]
    tgt_p = F.pad(target_rgbxyz, (0, Wp - W, 0, Hp - H))[None]
    flow_q, feat = pwc(src_p[:, :3], tgt_p[:, :3])
    flow = F.interpolate(flow_q, size=(Hp, Wp), mode="bilinear",
                         align_corners=False)[0] * FLOW_SCALE
    flow = flow[:, :H, :W].permute(1, 2, 0)  # [H, W, 2]
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=flow.device),
        torch.arange(W, dtype=torch.float32, device=flow.device),
        indexing="ij",
    )
    uv = torch.stack([u + flow[..., 0], v + flow[..., 1]], dim=-1)
    target_xyz = target_rgbxyz[3:].permute(1, 2, 0)
    sampled = bilinear_sample(target_xyz, uv.reshape(-1, 2)).reshape(H, W, 3)
    inb = (
        (uv[..., 0] >= 0)
        & (uv[..., 0] <= W - 1)
        & (uv[..., 1] >= 0)
        & (uv[..., 1] <= H - 1)
    )
    valid = inb & (source_rgbxyz[5] > 0) & (sampled[..., 2] > 0)
    weights = mask_net(feat, src_p, tgt_p)[0, 0, :H, :W]
    weights = torch.where(valid, weights, torch.zeros_like(weights))
    return flow, sampled, valid, weights


def sample_weight_field(weights, u, v):
    """The MaskNet weight field [H, W] sampled bilinearly at projected
    points (u, v) [P] (the JAX branch without patchwise NMS)."""
    uv = torch.stack([u, v], dim=-1)
    return bilinear_sample(weights[..., None], uv)[:, 0]
