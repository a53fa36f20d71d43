"""Optical-flow correspondences (port of
``occlusionfusion_tpu/fusion/flow_correspondence.py``; PWC-Net at full
resolution: ``flow_downscale`` is not ported).

PWC-Net between the previous and the current RGB-XYZ frame, weighted per
pixel by MaskNet. Two lifts of the flow to 3-D targets:
``flow_correspondences`` (dense) upsamples the quarter-resolution flow
x4, scales it x20 and samples the current point image at every flowed
pixel; ``flow_targets_at_points`` (sparse) samples the quarter-resolution
flow at the model points' projections only, optionally with the nets in
bfloat16 and MaskNet at 1/N resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from occlusionfusion_tpu_torch.geometry.camera import (
    bilinear_sample,
    resize_bilinear,
)
from occlusionfusion_tpu_torch.models.pwcnet import bf16_copy

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


def flow_targets_at_points(pwc, source_rgbxyz, target_rgbxyz, uv,
                           mask_net=None, bf16: bool = False,
                           mask_downscale: int = 1):
    """Sparse lift: flow targets at the query pixels ``uv`` [P, 2] (the
    model points' projections) only. Returns (targets [P, 3], valid [P],
    weights [P]).

    The quarter-resolution flow is sampled at q = (uv + 0.5) / 4 - 0.5,
    the half-pixel-centre map of ``jax.image.resize``, and scaled x20;
    the current point image is sampled at the flowed pixel uv2. A target
    is valid inside the image, where the source depth sampled at uv and
    the target's z are positive, and where the target's validity field
    sampled at uv2 exceeds 0.5 (that rejects samples that mix the z = 0
    background in at silhouettes). MaskNet's weight, sampled at uv, is 0
    where a target is not valid; without ``mask_net`` the weights are the
    validity.

    ``bf16`` runs PWC-Net and MaskNet in bfloat16 (their bf16 twins, cast
    once; the inputs cast too) and returns to f32 after them.
    ``mask_downscale`` N > 1 runs MaskNet on the padded images and the
    decoder features resized to 1/N (``resize_bilinear``, antialiased as
    in JAX) and samples its weight map at (uv + 0.5) / N - 0.5."""
    H, W = source_rgbxyz.shape[1:]
    Hp = -(-H // 64) * 64
    Wp = -(-W // 64) * 64
    src_p = F.pad(source_rgbxyz, (0, Wp - W, 0, Hp - H))[None]
    tgt_p = F.pad(target_rgbxyz, (0, Wp - W, 0, Hp - H))[None]
    if bf16:
        pwc = bf16_copy(pwc)
        mask_net = bf16_copy(mask_net) if mask_net is not None else None
        src_p = src_p.to(torch.bfloat16)
        tgt_p = tgt_p.to(torch.bfloat16)
    flow_q, feat = pwc(src_p[:, :3], tgt_p[:, :3])  # [1, 2, Hp/4, Wp/4]
    flow_q = flow_q.float()[0].permute(1, 2, 0)
    q = (uv + 0.5) / 4.0 - 0.5
    uv2 = uv + bilinear_sample(flow_q, q) * FLOW_SCALE
    target_xyz = target_rgbxyz[3:].permute(1, 2, 0)
    targets = bilinear_sample(target_xyz, uv2)
    inb = (
        (uv2[:, 0] >= 0) & (uv2[:, 0] <= W - 1)
        & (uv2[:, 1] >= 0) & (uv2[:, 1] <= H - 1)
    )
    sdep = bilinear_sample(source_rgbxyz[5][..., None], uv)[:, 0]
    tvalid = (target_rgbxyz[5] > 0).to(torch.float32)
    tvsamp = bilinear_sample(tvalid[..., None], uv2)[:, 0]
    valid = inb & (sdep > 0) & (targets[:, 2] > 0) & (tvsamp > 0.5)
    if mask_net is None:
        return targets, valid, valid.to(torch.float32)
    s6, t6, mfeat = src_p, tgt_p, feat
    mds = int(mask_downscale)
    if mds > 1:
        s6 = resize_bilinear(s6, (Hp // mds, Wp // mds))
        t6 = resize_bilinear(t6, (Hp // mds, Wp // mds))
        fH, fW = feat.shape[2:]
        mfeat = resize_bilinear(feat, (fH // mds, fW // mds))
    wmap = mask_net(mfeat, s6, t6)[0, 0].float()
    scale_uv = (uv + 0.5) / mds - 0.5 if mds > 1 else uv
    w = bilinear_sample(wmap[..., None], scale_uv)[:, 0]
    return targets, valid, torch.where(valid, w, torch.zeros_like(w))


def sample_weight_field(weights, u, v):
    """The MaskNet weight field [H, W] sampled bilinearly at projected
    points (u, v) [P] (the JAX branch without patchwise NMS)."""
    uv = torch.stack([u, v], dim=-1)
    return bilinear_sample(weights[..., None], uv)[:, 0]
