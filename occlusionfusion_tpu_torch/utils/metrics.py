"""Evaluation metrics on tensors (port of
``occlusionfusion_tpu/utils/metrics.py``): the reference's EPE 2D / 3D,
accuracy at a threshold, NFMR, inlier ratio, registration recall and the
valid-solve ratio, masked and on the tensors' own device, so they can run
inside an evaluation loop without a host read.
"""

from __future__ import annotations

import math

import torch


def _masked_mean(x, mask):
    m = mask.to(torch.float32)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def epe_2d(pred_flow, gt_flow, mask):
    """Mean L2 endpoint error over valid pixels; flows [..., 2]."""
    return _masked_mean(torch.linalg.norm(pred_flow - gt_flow, dim=-1), mask)


def epe_3d(pred, gt, mask):
    """Mean L2 error over valid 3D points (EPE 3D, EPE warp and Graph
    Error 3D, on scene-flow points, warped points or graph nodes)."""
    return _masked_mean(torch.linalg.norm(pred - gt, dim=-1), mask)


def accuracy_at(pred, gt, mask, threshold: float):
    """Fraction of valid points with error below threshold."""
    err = torch.linalg.norm(pred - gt, dim=-1)
    ok = (err < threshold).to(torch.float32) * mask.to(torch.float32)
    return torch.sum(ok) / torch.clamp(
        torch.sum(mask.to(torch.float32)), min=1.0)


def nfmr(pred_flow, gt_flow, mask, threshold: float = 0.04):
    """Non-rigid Feature Matching Recall: fraction of valid points whose
    predicted flow lands within threshold of the ground-truth flow."""
    return accuracy_at(pred_flow, gt_flow, mask, threshold)


def inlier_ratio(warped_src, tgt, match_src, match_tgt, match_valid,
                 threshold: float = 0.04):
    """Fraction of predicted matches within threshold after warping."""
    d = torch.linalg.norm(warped_src[match_src.long()]
                          - tgt[match_tgt.long()], dim=-1)
    ok = (d < threshold).to(torch.float32) * match_valid.to(torch.float32)
    return torch.sum(ok) / torch.clamp(
        torch.sum(match_valid.to(torch.float32)), min=1.0)


def registration_recall(R_pred, t_pred, R_gt, t_gt, rot_thresh_deg=15.0,
                        trans_thresh=0.1):
    """Rigid registration success: rotation geodesic angle and translation
    error under their thresholds (0-d bool)."""
    trace = torch.trace(R_pred.T @ R_gt)
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    ang = torch.arccos(cos) * (180.0 / math.pi)
    terr = torch.linalg.norm(t_pred - t_gt)
    return (ang < rot_thresh_deg) & (terr < trans_thresh)


def valid_solve_ratio(valid_flags):
    """Fraction of frames whose solver produced a usable solution."""
    v = valid_flags.to(torch.float32)
    return torch.sum(v) / max(v.numel(), 1)
