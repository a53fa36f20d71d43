"""Training step of the motion-completion net (port of
``occlusionfusion_tpu/models/motion_train.py``).

Heteroscedastic Gaussian NLL over node motion: the net predicts (mu [3],
sigma [1]); loss = |mu - gt|^2 / (2 sigma^2) + 3 log sigma over the real
nodes. The JAX package vmaps over the batch; the port loops over the
samples and reduces the same way, the mean of the per-sample losses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from occlusionfusion_tpu_torch.fusion.motion_runner import pyramid_to_torch
from occlusionfusion_tpu_torch.models.motion_complete import (
    PyramidBatch,
    motion_complete_forward,
)


class MotionBatch(NamedTuple):
    """One padded training sample (numpy from the data generators,
    tensors after ``sample_to_torch``)."""

    pos: np.ndarray  # [N0, 3]
    curr_motion: np.ndarray  # [N0, 4]
    history: np.ndarray  # [T, N0, 4]
    history_len: np.ndarray  # scalar
    gt_motion: np.ndarray  # [N0, 3] normalized GT nonrigid motion
    node_mask: np.ndarray  # [N0]
    pyramid: PyramidBatch


def sample_to_torch(sample: MotionBatch, device=None) -> MotionBatch:
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return MotionBatch(
        pos=t(sample.pos).float(), curr_motion=t(sample.curr_motion).float(),
        history=t(sample.history).float(),
        history_len=t(sample.history_len).long(),
        gt_motion=t(sample.gt_motion).float(),
        node_mask=t(sample.node_mask).float(),
        pyramid=pyramid_to_torch(sample.pyramid, device),
    )


def nll_loss(net, batch: MotionBatch) -> torch.Tensor:
    pred = motion_complete_forward(net, batch.pos, batch.curr_motion,
                                   batch.history, batch.history_len,
                                   batch.pyramid)
    mu, sigma = pred[:, :3], torch.clamp(pred[:, 3], min=1e-3)
    sq = torch.sum((mu - batch.gt_motion) ** 2, dim=-1)
    nll = sq / (2.0 * sigma**2) + 3.0 * torch.log(sigma)
    mask = batch.node_mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def batched_loss(net, samples) -> torch.Tensor:
    """The mean of the per-sample losses (JAX: the mean of a vmap)."""
    return torch.mean(torch.stack([nll_loss(net, s) for s in samples]))


def make_train_step(net, optimizer):
    """``step(samples) -> loss``: one optimiser step on the mean loss of
    ``samples`` (MotionBatch tensors on the net's device)."""

    def train_step(samples):
        optimizer.zero_grad()
        loss = batched_loss(net, samples)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
