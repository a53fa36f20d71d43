"""Correlation cost volume for optical flow (port of
``occlusionfusion_tpu/ops/correlation.py``).

Plain PyTorch, as the JAX package computes it outside any Pallas kernel:
the (2r+1)^2-displacement volume as shift-and-multiply over the padded
second feature map, the mean over channels of f1(x) * f2(x + d). Batched
NCHW (the port's PWC layout); one row of displacements per step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def correlation_volume(f1: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int = 4) -> torch.Tensor:
    """f1, f2 [B, C, H, W] -> [B, (2r+1)^2, H, W]; channel dy*(2r+1)+dx
    holds displacement (dy - r, dx - r), as in the JAX package."""
    B, C, H, W = f1.shape
    r = max_displacement
    f2p = F.pad(f2, (r, r, r, r))
    rows = []
    for dy in range(2 * r + 1):
        band = f2p[:, :, dy : dy + H]  # [B, C, H, W + 2r]
        shifted = torch.stack(
            [band[..., dx : dx + W] for dx in range(2 * r + 1)], dim=1
        )  # [B, 2r+1, C, H, W]
        rows.append(torch.mean(f1[:, None] * shifted, dim=2))
    return torch.cat(rows, dim=1)
