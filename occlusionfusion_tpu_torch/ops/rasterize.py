"""Point-splat depth / silhouette rasterizer (port of
``occlusionfusion_tpu/ops/rasterize.py``), used by N-ICP's silhouette
and projective-depth costs.

Each point splats its camera depth onto the (2r+1)^2 pixels around its
projection (rounded half to even, as ``jnp.round`` and ``torch.round``
both do); a z-buffer keeps the nearest. JAX's ``segment_min`` over pixel
ids becomes ``scatter_reduce(..., "amin")`` with the same shadow bucket
(pixel H*W) for points off the image or invalid, and ``jnp.minimum``
across the offsets ``torch.minimum``. Their gradients agree: a pixel's
gradient goes to the points whose depth attains its minimum, split
evenly among tied points within one offset (JAX's scatter-min rule,
torch's amin rule) and in halves between tied offsets (both
frameworks' minimum).
"""

from __future__ import annotations

import torch

_FAR = 1e9


def _projections(points, intr, point_valid):
    """(valid [P], z [P], u0 [P], v0 [P]) with the pixel of each point."""
    fx, fy, cx, cy = intr
    z = points[:, 2]
    valid = z > 1e-6
    if point_valid is not None:
        valid = valid & point_valid
    zs = torch.where(valid, z, torch.ones_like(z))
    u0 = torch.round(points[:, 0] / zs * fx + cx).to(torch.int64)
    v0 = torch.round(points[:, 1] / zs * fy + cy).to(torch.int64)
    return valid, z, u0, v0


def _offsets(splat_radius: int):
    r = range(-splat_radius, splat_radius + 1)
    return [(dy, dx) for dy in r for dx in r]


def _pixel(valid, u0, v0, dy, dx, H: int, W: int):
    """(ok [P], flat pixel id with H*W for the shadow bucket)."""
    px, py = u0 + dx, v0 + dy
    ok = valid & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    return ok, torch.where(ok, py * W + px, torch.full_like(px, H * W))


def render_depth(points, intr, image_hw, point_valid=None,
                 splat_radius: int = 1):
    """Splat [P, 3] camera-frame points into a depth map with intrinsics
    ``intr`` (fx, fy, cx, cy: floats or 0-d tensors). Returns (depth
    [H, W], 0 where empty; mask [H, W] bool)."""
    H, W = image_hw
    valid, z, u0, v0 = _projections(points, intr, point_valid)
    far = torch.full((), _FAR, dtype=points.dtype, device=points.device)
    depth = far.expand(H * W)
    for dy, dx in _offsets(splat_radius):
        ok, flat = _pixel(valid, u0, v0, dy, dx, H, W)
        contrib = torch.where(ok, z, far)
        splat = torch.full((H * W + 1,), float("inf"), dtype=points.dtype,
                           device=points.device).scatter_reduce(
            0, flat, contrib, "amin", include_self=True)[: H * W]
        depth = torch.minimum(depth, splat)
    mask = depth < _FAR
    return (torch.where(mask, depth, torch.zeros_like(depth)).reshape(H, W),
            mask.reshape(H, W))


def render_depth_color(points, colors, intr, image_hw, point_valid=None,
                       splat_radius: int = 1):
    """Depth and the colour ([P, 3], 0..255) of the lowest-index point
    whose depth attains each pixel's z-buffer minimum (within 1e-6): the
    hard nearest-point composite. Returns (depth, color [H, W, 3],
    mask)."""
    H, W = image_hw
    depth, mask = render_depth(points, intr, image_hw, point_valid,
                               splat_radius)
    valid, z, u0, v0 = _projections(points, intr, point_valid)
    P = points.shape[0]
    depth_flat = depth.reshape(-1)
    ids = torch.arange(P, device=points.device)
    winner = torch.full((H * W,), P, dtype=torch.int64, device=points.device)
    for dy, dx in _offsets(splat_radius):
        ok, flat = _pixel(valid, u0, v0, dy, dx, H, W)
        at_min = ok & (torch.abs(
            z - depth_flat[torch.clamp(flat, max=H * W - 1)]) < 1e-6)
        cand = torch.where(at_min, ids, torch.full_like(ids, P))
        win = torch.full((H * W + 1,), P, dtype=torch.int64,
                         device=points.device).scatter_reduce(
            0, flat, cand, "amin", include_self=True)[: H * W]
        winner = torch.minimum(winner, win)
    keep = (winner < P) & mask.reshape(-1)
    color = torch.where(keep[:, None], colors[torch.clamp(winner, max=P - 1)],
                        torch.zeros((), dtype=colors.dtype,
                                    device=colors.device))
    return depth, color.reshape(H, W, 3), mask
