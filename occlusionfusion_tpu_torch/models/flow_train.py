"""Training recipe of the optical-flow stack, PWC-Net + MaskNet (port of
``occlusionfusion_tpu/models/flow_train.py``).

A multi-scale flow loss (per-level robust L1, the published PWC-Net
weighting), the MaskNet BCE head term, and an optimiser step. Flow GT
comes in full-resolution pixels; each decoder level l predicts flow x
1/20 in full-resolution pixel units, so the GT is average-pooled down to
level l (the valid pixels' mean over each 2^l x 2^l window, a window with
none invalid) and the prediction multiplied by 20.

``FlowBatch`` keeps the JAX layouts (images [B, H, W, C], flows
[B, H, W, 2]); the nets take NCHW.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

LEVEL_WEIGHTS = {2: 0.005, 3: 0.01, 4: 0.02, 5: 0.08, 6: 0.32}
FLOW_NORM = 20.0  # decoder outputs are pixel flow / 20


class FlowBatch(NamedTuple):
    im1: torch.Tensor  # [B, H, W, 3] RGB in [0, 1]
    im2: torch.Tensor  # [B, H, W, 3]
    flow_gt: torch.Tensor  # [B, H, W, 2] full-res pixel flow im1 -> im2
    flow_valid: torch.Tensor  # [B, H, W]
    # optional MaskNet supervision: the 6-channel RGB-XYZ images and the
    # mask GT; None trains the flow only
    src_rgbd6: torch.Tensor | None = None
    tgt_rgbd6: torch.Tensor | None = None
    mask_gt: torch.Tensor | None = None  # [B, H, W]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _window_sum(x, k: int):
    """Sum of x [B, H, W, C] over non-overlapping k x k windows (the
    "VALID" ``reduce_window`` add: a partial window at the border is
    dropped)."""
    B, H, W, C = x.shape
    h, w = H // k, W // k
    return x[:, : h * k, : w * k].reshape(B, h, k, w, k, C).sum(dim=(2, 4))


def _downsample_flow(flow, valid, level: int):
    """Full-resolution pixel flow [B, H, W, 2] average-pooled over the
    valid pixels to level ``level`` (still in full-resolution pixels), and
    the pooled validity (a window with a valid pixel)."""
    k = 2**level
    vf = valid[..., None].to(flow.dtype)
    pooled = _window_sum(flow * vf, k)
    count = _window_sum(vf, k)
    return pooled / torch.clamp(count, min=1.0), count[..., 0] > 0.5


def multiscale_flow_loss(flows: dict, flow_gt, flow_valid, eps: float = 1e-3):
    """Sum over levels 2..6 of the weighted robust-L1 EPEs; ``flows``
    {level: [B, 2, h, w]} as ``PWCNet.forward_multiscale`` gives them."""
    total = 0.0
    for lvl, w in LEVEL_WEIGHTS.items():
        gt_l, valid_l = _downsample_flow(flow_gt, flow_valid, lvl)
        pred = flows[lvl].permute(0, 2, 3, 1) * FLOW_NORM
        diff = pred - gt_l
        err = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps * eps)
        m = valid_l.to(torch.float32)
        total = total + w * torch.sum(err * m) / torch.clamp(torch.sum(m),
                                                             min=1.0)
    return total


def masked_bce(p, gt, valid):
    """Masked mean of the BCE of probabilities ``p`` (clipped to
    [1e-6, 1 - 1e-6]) against the binary ``gt`` over ``valid``."""
    p = torch.clamp(p, 1e-6, 1 - 1e-6)
    gt = gt.to(torch.float32)
    bce = -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))
    m = valid.to(torch.float32)
    return torch.sum(bce * m) / torch.clamp(torch.sum(m), min=1.0)


def flow_loss_fn(pwc, mask_net, batch: FlowBatch, lambda_mask: float = 1.0):
    """The multi-scale flow loss, plus ``lambda_mask`` times MaskNet's
    masked BCE over the valid flow pixels when ``mask_net`` is given and
    the batch carries mask supervision."""
    flows, feat = pwc.forward_multiscale(_nchw(batch.im1), _nchw(batch.im2))
    loss = multiscale_flow_loss(flows, batch.flow_gt, batch.flow_valid)
    if mask_net is not None and batch.mask_gt is not None:
        p = mask_net(feat, _nchw(batch.src_rgbd6), _nchw(batch.tgt_rgbd6))
        loss = loss + lambda_mask * masked_bce(p[:, 0], batch.mask_gt,
                                               batch.flow_valid)
    return loss


def make_flow_train_step(pwc, optimizer, mask_net=None,
                         lambda_mask: float = 1.0):
    """``step(batch) -> loss``: one optimiser step of ``flow_loss_fn`` on
    the nets' parameters (MaskNet's too when given)."""

    def train_step(batch: FlowBatch):
        optimizer.zero_grad()
        loss = flow_loss_fn(pwc, mask_net, batch, lambda_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def epe_px(pwc, im1, im2, flow_gt, flow_valid):
    """Full-resolution end-point error in pixels over the valid pixels:
    the level-2 flow upsampled bilinearly (``F.interpolate`` with
    ``align_corners=False``, the half-pixel rule of ``jax.image.resize``;
    an upsampling, so its antialiasing plays no part) and scaled x 20."""
    flows, _ = pwc.forward_multiscale(_nchw(im1), _nchw(im2))
    H, W = im1.shape[1:3]
    up = F.interpolate(flows[2], size=(H, W), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1) * FLOW_NORM
    err = torch.linalg.vector_norm(up - flow_gt, dim=-1)
    m = flow_valid.to(torch.float32)
    return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)
