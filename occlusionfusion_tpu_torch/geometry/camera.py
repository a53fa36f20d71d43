"""Pinhole camera model (port of ``occlusionfusion_tpu/geometry/camera.py``),
bilinear sampling, and the bilinear image resize of ``jax.image.resize``."""

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


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample img [H, W, C] at uv [..., 2] (u = x, v = y) pixel
    coordinates. Out-of-range samples clamp to the border (callers mask
    separately); the upper clamp is W - 1.000001, which rounds to the
    tensor's f32 exactly as the JAX package's clip does."""
    H, W = img.shape[:2]
    u = torch.clamp(uv[..., 0], 0.0, W - 1.000001)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.000001)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    fu = (u - u0.to(u.dtype))[..., None]
    fv = (v - v0.to(v.dtype))[..., None]
    top = img[v0, u0] * (1 - fu) + img[v0, u1] * fu
    bot = img[v1, u0] * (1 - fu) + img[v1, u1] * fu
    return top * (1 - fv) + bot * fv


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] f32 weights of ``jax.image.resize(method="bilinear")``
    along one axis (``jax._src.image.scale.compute_weight_mat`` with its
    triangle kernel and antialiasing): output i samples the input at
    (i + 0.5) n_in / n_out - 0.5, and when downsampling the triangle
    widens by the factor (taps [1, 3, 3, 1] / 8 at x2), each column
    renormalized over the taps inside the input."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
              ) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = torch.abs(sample[None, :] - src[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(
        torch.abs(total) > 1000.0 * float(torch.finfo(torch.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the last two (spatial) axes of ``x`` [..., H, W] to ``size``
    (h, w) as ``jax.image.resize(..., method="bilinear")`` does, with its
    antialiasing when shrinking; an axis whose size does not change is
    left alone. The weights take ``x``'s dtype (bf16 inputs resize in
    bf16, as in JAX). Built from device ops only, so a CUDA graph can
    capture it."""
    H, W = x.shape[-2:]
    h, w = size
    if w != W:
        x = x @ _resize_weights(W, w, x.device).to(x.dtype)
    if h != H:
        x = (x.transpose(-1, -2)
             @ _resize_weights(H, h, x.device).to(x.dtype)).transpose(-1, -2)
    return x
