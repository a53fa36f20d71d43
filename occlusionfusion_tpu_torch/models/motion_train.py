"""Training step of the motion-completion net (port of
``occlusionfusion_tpu/models/motion_train.py``).

Heteroscedastic Gaussian NLL over node motion: the net predicts (mu [3],
sigma [1]); loss = |mu - gt|^2 / (2 sigma^2) + 3 log sigma over the real
nodes. The JAX package vmaps over the batch; the port loops over the
samples and reduces the same way, the mean of the per-sample losses.

``make_data_parallel_train_step`` is the data-parallel step of
``__graft_entry__.py``'s dry run, where the JAX batch is sharded over
``data`` and XLA inserts the gradient psum: each rank's loss over its own
samples, the gradients (and the loss) averaged by one ``all_reduce`` of
one flat buffer, and the optimiser stepped on every rank alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

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


def make_data_parallel_train_step(net, optimizer, mesh_or_group,
                                  axis: str = "data"):
    """``step(samples) -> loss``: one data-parallel optimiser step over a
    process group (or a mesh's ``axis``). Each rank passes its own
    samples; the mean loss and its gradients over each rank's samples
    are averaged over the ranks by one all_reduce of one flat buffer
    [gradients | loss | count | count^2], and every rank steps the same
    replicated parameters. That is the step on the whole batch when
    every rank holds equally many samples; where they do not, every rank
    raises ``ValueError``."""
    group = (mesh_or_group.get_group(axis)
             if hasattr(mesh_or_group, "get_group") else mesh_or_group)
    world = dist.get_world_size(group)
    params = [p for p in net.parameters() if p.requires_grad]

    def train_step(samples):
        if not samples:
            raise ValueError("a rank with no samples")
        optimizer.zero_grad()
        loss = batched_loss(net, samples)
        loss.backward()
        k = float(len(samples))
        flat = torch.cat(
            [(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
             for p in params]
            + [torch.stack([loss.detach(), loss.new_tensor(k),
                            loss.new_tensor(k * k)])])
        dist.all_reduce(flat, group=group)
        total, total_sq = float(flat[-2]), float(flat[-1])
        if total_sq * world != total * total:
            raise ValueError(f"the ranks hold unequal sample counts "
                             f"({total:g} samples over {world} ranks)")
        flat /= world
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p).clone()
            off += p.numel()
        optimizer.step()
        return flat[off].clone()

    return train_step
