"""Training losses of the neural-tracking stack (DeformLoss) and the Lepard
matcher (focal correspondence loss); port of
``occlusionfusion_tpu/models/deform_loss.py``.

``model/loss.py`` of the reference: DeformLoss (lambdas flow 5, graph 2,
warp 2, mask 1000), RobustL1, BatchGraphL2; ``lepard/models/loss.py``:
the focal correspondence loss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class DeformLossWeights(NamedTuple):
    lambda_flow: float = 5.0
    lambda_graph: float = 2.0
    lambda_warp: float = 2.0
    lambda_mask: float = 1000.0


def _masked_mean(err, mask):
    m = mask.to(torch.float32)
    return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)


def robust_l1(pred, gt, mask, eps: float = 1e-3):
    """Masked mean of sqrt(|pred - gt|^2 + eps^2)."""
    diff = pred - gt
    return _masked_mean(torch.sqrt(torch.sum(diff * diff, dim=-1) + eps * eps),
                        mask)


def graph_l2(pred_translations, gt_translations, node_mask):
    """Masked mean squared node-translation error."""
    diff = pred_translations - gt_translations
    return _masked_mean(torch.sum(diff * diff, dim=-1), node_mask)


def sigmoid_binary_cross_entropy(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``: -labels log sigmoid(x) -
    (1 - labels) log sigmoid(-x), elementwise."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(
        -logits)


def deform_loss(weights: DeformLossWeights, flow_pred, flow_gt, flow_mask,
                node_trans_pred, node_trans_gt, node_mask, warped_pred,
                warped_gt, warp_mask, mask_pred=None, mask_gt=None,
                mask_valid=None):
    """The combined training loss (``model/loss.py:27-71``);
    ``mask_pred`` are MaskNet logits."""
    total = weights.lambda_flow * robust_l1(flow_pred, flow_gt, flow_mask)
    total = total + weights.lambda_graph * graph_l2(
        node_trans_pred, node_trans_gt, node_mask)
    total = total + weights.lambda_warp * robust_l1(warped_pred, warped_gt,
                                                    warp_mask)
    if mask_pred is not None:
        bce = sigmoid_binary_cross_entropy(mask_pred, mask_gt.to(
            mask_pred.dtype))
        total = total + weights.lambda_mask * _masked_mean(bce, mask_valid)
    return total


def focal_correspondence_loss(conf, gt_matches, valid, alpha: float = 0.25,
                              gamma: float = 2.0, neg_weight=None):
    """Focal BCE over the [S, T] match confidences against the binary
    ground truth, over the ``valid`` cells, normalised by the count of
    valid positives; ``neg_weight`` scales the negative term per cell
    (bridge-negative supervision)."""
    conf = torch.clamp(conf, 1e-6, 1 - 1e-6)
    pos = -alpha * ((1 - conf) ** gamma) * torch.log(conf) * gt_matches
    neg = -(1 - alpha) * (conf**gamma) * torch.log(1 - conf) * (
        1 - gt_matches)
    if neg_weight is not None:
        neg = neg * neg_weight
    m = valid.to(torch.float32)
    return torch.sum((pos + neg) * m) / torch.clamp(
        torch.sum(gt_matches * m), min=1.0)
