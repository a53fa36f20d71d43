"""Optical-flow correspondences (port of
``occlusionfusion_tpu/fusion/flow_correspondence.py``).

PWC-Net between the previous and the current RGB-XYZ frame, weighted per
pixel by MaskNet (or, without MaskNet, by the flow's validity). Two lifts
of the flow to 3-D targets: ``flow_correspondences`` (dense) upsamples
the quarter-resolution flow x4, scales it x20 and samples the current
point image at every flowed pixel; ``flow_targets_at_points`` (sparse)
samples the quarter-resolution flow at the model points' projections
only, optionally with the nets in bfloat16 and MaskNet at 1/N
resolution. Both run the nets at 1/``downscale`` resolution when asked
(``FusionConfig.flow_downscale``) and rescale the flow per axis to full
resolution. ``patchwise_max_weights`` is the patchwise non-max
suppression of the weight field (``flow_mask_patch``), which
``sample_weight_field`` then samples at the nearest pixel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from occlusionfusion_tpu_torch.geometry.camera import (
    bilinear_sample,
    resize_bilinear,
)
from occlusionfusion_tpu_torch.models.pwcnet import bf16_copy
from occlusionfusion_tpu_torch.ops.segment_ops import segment_sum

FLOW_SCALE = 20.0  # PWC predicts flow / 20 at quarter resolution


def _padded_inputs(source_rgbxyz, target_rgbxyz, ds: int):
    """Both images resized to 1/ds (``jax.image.resize``'s bilinear) and
    zero-padded bottom/right to multiples of 64 (PWC's 6-level pyramid):
    (src [1, 6, Hp, Wp], tgt, Hd, Wd)."""
    H, W = source_rgbxyz.shape[1:]
    Hd, Wd = H // ds, W // ds
    if ds > 1:
        source_rgbxyz = resize_bilinear(source_rgbxyz, (Hd, Wd))
        target_rgbxyz = resize_bilinear(target_rgbxyz, (Hd, Wd))
    Hp = -(-Hd // 64) * 64
    Wp = -(-Wd // 64) * 64
    src_p = F.pad(source_rgbxyz, (0, Wp - Wd, 0, Hp - Hd))[None]
    tgt_p = F.pad(target_rgbxyz, (0, Wp - Wd, 0, Hp - Hd))[None]
    return src_p, tgt_p, Hd, Wd


def _scale_axes(flow, sx: float, sy: float, dim: int):
    """The flow's x and y components (along ``dim``) times sx and sy, each
    ratio rounded to f32 as JAX's f32 array of them is; no host tensor, so
    a CUDA graph can capture it."""
    fx, fy = flow.unbind(dim)
    return torch.stack([fx * float(np.float32(sx)),
                        fy * float(np.float32(sy))], dim)


def flow_correspondences(pwc, source_rgbxyz, target_rgbxyz, mask_net=None,
                         downscale: int = 1):
    """source/target RGB-XYZ [6, H, W] -> (flow [H, W, 2] in pixels,
    target_points [H, W, 3], valid [H, W], weights [H, W]).

    A sample is valid where it lands inside the image and both the source
    depth and the sampled target depth are positive; the MaskNet weight is
    0 elsewhere, and without ``mask_net`` the weights are the validity.
    ``downscale`` N > 1 runs PWC and MaskNet at 1/N and resizes the flow
    (each axis scaled by its own ratio H / (H // N), W / (W // N)) and
    the weights back to full resolution."""
    H, W = source_rgbxyz.shape[1:]
    ds = int(downscale)
    src_p, tgt_p, Hd, Wd = _padded_inputs(source_rgbxyz, target_rgbxyz, ds)
    Hp, Wp = src_p.shape[2:]
    flow_q, feat = pwc(src_p[:, :3], tgt_p[:, :3])
    flow = F.interpolate(flow_q, size=(Hp, Wp), mode="bilinear",
                         align_corners=False)[0] * FLOW_SCALE
    flow = flow[:, :Hd, :Wd]
    if ds > 1:
        flow = _scale_axes(resize_bilinear(flow, (H, W)), W / Wd, H / Hd, 0)
    flow = flow.permute(1, 2, 0)  # [H, W, 2]
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
    if mask_net is None:
        return flow, sampled, valid, valid.to(torch.float32)
    weights = mask_net(feat, src_p, tgt_p)[0, 0, :Hd, :Wd]
    if ds > 1:
        weights = resize_bilinear(weights, (H, W))
    weights = torch.where(valid, weights, torch.zeros_like(weights))
    return flow, sampled, valid, weights


def patchwise_max_weights(weights, patch_size: int):
    """Patchwise non-max suppression of the weight field [H, W]: in every
    ``patch_size`` square only the pixels at the patch's largest weight
    (within 1e-8) keep it, the rest become 0. A max-pool and a nearest
    repeat, the field zero-padded bottom/right to whole patches."""
    H, W = weights.shape
    p = int(patch_size)
    Hp = -(-H // p) * p
    Wp = -(-W // p) * p
    w = F.pad(weights, (0, Wp - W, 0, Hp - H))
    pooled = F.max_pool2d(w[None, None], p, p)[0, 0]
    up = torch.repeat_interleave(torch.repeat_interleave(pooled, p, 0), p,
                                 1)[:H, :W]
    selected = torch.abs(weights - up) <= 1e-8
    return torch.where(selected, weights, torch.zeros_like(weights))


def flow_targets_at_points(pwc, source_rgbxyz, target_rgbxyz, uv,
                           mask_net=None, bf16: bool = False,
                           mask_downscale: int = 1, downscale: int = 1,
                           return_uv2: bool = False):
    """Sparse lift: flow targets at the query pixels ``uv`` [P, 2] (the
    model points' projections) only. Returns (targets [P, 3], valid [P],
    weights [P]), and with ``return_uv2`` also the flowed pixels uv2
    [P, 2] (advect mode associates depth there).

    The quarter-resolution flow is sampled at q = (uv_d + 0.5) / 4 - 0.5,
    uv_d = (uv + 0.5) / N - 0.5 the pixel on the 1/N grid (``downscale``
    N; uv_d = uv at N = 1), the half-pixel-centre maps of
    ``jax.image.resize``, scaled x20 and, at N > 1, by each axis's ratio
    to full resolution; the current point image is sampled at uv2. A
    target is valid inside the image, where the source depth sampled at
    uv and the target's z are positive, and where the target's validity
    field sampled at uv2 exceeds 0.5 (that rejects samples that mix the
    z = 0 background in at silhouettes). MaskNet's weight, sampled at
    uv_d, is 0 where a target is not valid; without ``mask_net`` the
    weights are the validity.

    ``bf16`` runs PWC-Net and MaskNet in bfloat16 (their bf16 twins, cast
    once; the inputs cast too) and returns to f32 after them.
    ``mask_downscale`` M > 1 runs MaskNet on the padded images and the
    decoder features resized to 1/M (``resize_bilinear``, antialiased as
    in JAX) and samples its weight map at (uv_d + 0.5) / M - 0.5."""
    H, W = source_rgbxyz.shape[1:]
    ds = int(downscale)
    src_p, tgt_p, Hd, Wd = _padded_inputs(source_rgbxyz, target_rgbxyz, ds)
    Hp, Wp = src_p.shape[2:]
    if bf16:
        pwc = bf16_copy(pwc)
        mask_net = bf16_copy(mask_net) if mask_net is not None else None
        src_p = src_p.to(torch.bfloat16)
        tgt_p = tgt_p.to(torch.bfloat16)
    flow_q, feat = pwc(src_p[:, :3], tgt_p[:, :3])  # [1, 2, Hp/4, Wp/4]
    flow_q = flow_q.float()[0].permute(1, 2, 0)
    uv_d = (uv + 0.5) / ds - 0.5 if ds > 1 else uv
    q = (uv_d + 0.5) / 4.0 - 0.5
    fq = bilinear_sample(flow_q, q) * FLOW_SCALE
    if ds > 1:
        fq = _scale_axes(fq, W / Wd, H / Hd, -1)
    uv2 = uv + fq
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
        weights = valid.to(torch.float32)
    else:
        s6, t6, mfeat = src_p, tgt_p, feat
        mds = int(mask_downscale)
        if mds > 1:
            s6 = resize_bilinear(s6, (Hp // mds, Wp // mds))
            t6 = resize_bilinear(t6, (Hp // mds, Wp // mds))
            fH, fW = feat.shape[2:]
            mfeat = resize_bilinear(feat, (fH // mds, fW // mds))
        wmap = mask_net(mfeat, s6, t6)[0, 0].float()
        scale_uv = (uv_d + 0.5) / mds - 0.5 if mds > 1 else uv_d
        w = bilinear_sample(wmap[..., None], scale_uv)[:, 0]
        weights = torch.where(valid, w, torch.zeros_like(w))
    if return_uv2:
        return targets, valid, weights, uv2
    return targets, valid, weights


def sample_weight_field(weights, u, v, nms_active: bool = False):
    """The weight field [H, W] sampled at projected points (u, v) [P]:
    bilinearly, or at the nearest pixel (rounded, clamped into the image)
    once the field is patchwise-NMS'd (``nms_active``), where a bilinear
    sample would shrink the isolated survivors toward their zeroed
    neighbours."""
    if nms_active:
        h, w = weights.shape
        ui = torch.clamp(torch.round(u).to(torch.int64), 0, w - 1)
        vi = torch.clamp(torch.round(v).to(torch.int64), 0, h - 1)
        return weights[vi, ui]
    uv = torch.stack([u, v], dim=-1)
    return bilinear_sample(weights[..., None], uv)[:, 0]


def predicted_node_locations(target_points, valid, pixel_anchors,
                             pixel_weights, num_nodes: int):
    """Per-node predicted target: the skinning-weighted mean of the flow
    targets [H, W, 3] of the valid pixels anchored to each node. Returns
    (locations [N, 3], observed [N])."""
    K = pixel_anchors.shape[-1]
    flat_anchor = pixel_anchors.reshape(-1).long()
    flat_w = (pixel_weights * valid[..., None]).reshape(-1)
    flat_w = torch.where(flat_anchor >= 0, flat_w, torch.zeros_like(flat_w))
    flat_anchor = torch.clamp(flat_anchor, min=0)
    flat_pts = torch.repeat_interleave(target_points.reshape(-1, 3), K, dim=0)
    num = segment_sum(flat_pts * flat_w[:, None], flat_anchor, num_nodes)
    den = segment_sum(flat_w, flat_anchor, num_nodes)
    observed = den > 1e-6
    locations = torch.where(
        observed[:, None], num / torch.clamp(den[:, None], min=1e-6),
        torch.zeros_like(num))
    return locations, observed
