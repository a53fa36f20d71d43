"""Pinhole camera model (port of ``occlusionfusion_tpu/geometry/camera.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    """Pinhole intrinsics as Python floats (or 0-d tensors)."""

    fx: float
    fy: float
    cx: float
    cy: float


def backproject_depth(
    depth: torch.Tensor, intr: Intrinsics, depth_scale: float = 1.0
) -> torch.Tensor:
    """Depth [H, W] -> point image [H, W, 3]; invalid (<= 0) depth gives 0."""
    H, W = depth.shape
    d = depth.to(torch.float32) * depth_scale
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    x = (u - intr.cx) / intr.fx * d
    y = (v - intr.cy) / intr.fy * d
    pts = torch.stack([x, y, d], dim=-1)
    return torch.where((d > 0.0)[..., None], pts, torch.zeros_like(pts))


def project_points(points: torch.Tensor, intr: Intrinsics, eps: float = 1e-8):
    """[..., 3] -> ([..., 2] pixel (u, v), [...] valid: z > eps)."""
    z = points[..., 2]
    valid = z > eps
    zs = torch.where(valid, z, torch.ones_like(z))
    u = points[..., 0] / zs * intr.fx + intr.cx
    v = points[..., 1] / zs * intr.fy + intr.cy
    return torch.stack([u, v], dim=-1), valid
