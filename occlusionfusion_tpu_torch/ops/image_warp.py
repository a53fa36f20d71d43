"""Image warping (flow, rigid, 3-D) and flow augmentation (port of
``occlusionfusion_tpu/ops/image_warp.py``).

Elementwise and bilinear tensor ops on [H, W, C] images and [H, W, 2]
pixel flows (u, v), as in the JAX module. The flow trainer's
``--augment_rot`` uses ``rotate_image``, ``rotation_flow`` and
``augmented_flow_from_rotation``.
"""

from __future__ import annotations

import math

import torch

from occlusionfusion_tpu_torch.geometry.camera import (
    Intrinsics,
    bilinear_sample,
)


def _grid(H: int, W: int, device):
    """(v, u) pixel coordinate grids [H, W], f32."""
    return torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )


def warp_image_with_flow(image: torch.Tensor, flow: torch.Tensor):
    """Backward-warp [H, W, C] by flow [H, W, 2]: out(x) = image(x +
    flow(x)); out-of-range samples clamp (mask separately)."""
    H, W = image.shape[:2]
    v, u = _grid(H, W, image.device)
    uv = torch.stack([u + flow[..., 0], v + flow[..., 1]], dim=-1)
    return bilinear_sample(image, uv.reshape(-1, 2)).reshape(H, W, -1)


def _reproject(moved, src_z, intr: Intrinsics):
    """Flow [H, W, 2] from the pixel grid to the projections of moved
    [H, W, 3], and its validity (positive depth both sides)."""
    H, W = moved.shape[:2]
    z = moved[..., 2]
    valid = (src_z > 0) & (z > 1e-6)
    zs = torch.where(valid, z, torch.ones_like(z))
    u2 = moved[..., 0] / zs * intr.fx + intr.cx
    v2 = moved[..., 1] / zs * intr.fy + intr.cy
    v, u = _grid(H, W, moved.device)
    flow = torch.stack([u2 - u, v2 - v], dim=-1)
    return torch.where(valid[..., None], flow, torch.zeros_like(flow)), valid


def warp_rigid(point_image, R, t, intr: Intrinsics):
    """The flow [H, W, 2] that (R, t) induces on a point image [H, W, 3],
    and its validity [H, W]."""
    H, W, _ = point_image.shape
    moved = (point_image.reshape(-1, 3) @ R.T + t).reshape(H, W, 3)
    return _reproject(moved, point_image[..., 2], intr)


def warp_3d(point_image, scene_flow, intr: Intrinsics):
    """Per-pixel 3-D scene flow [H, W, 3] reprojected to a 2-D optical
    flow [H, W, 2], and its validity."""
    return _reproject(point_image + scene_flow, point_image[..., 2], intr)


def median_filter_depth(depth, size: int = 5, max_deviation: float = 0.1):
    """Replace depths further than ``max_deviation`` from their window's
    median over valid (> 0) entries (the lower middle of an even count);
    zero depths stay zero."""
    H, W = depth.shape
    r = size // 2
    pad = torch.nn.functional.pad(depth, (r, r, r, r))
    stack = torch.stack([pad[dy : dy + H, dx : dx + W]
                         for dy in range(size) for dx in range(size)], -1)
    valid = stack > 0
    srt = torch.sort(torch.where(valid, stack, torch.full_like(stack, math.inf)),
                     dim=-1).values
    count = torch.sum(valid, dim=-1)
    med = torch.gather(srt, -1, (count // 2)[..., None])[..., 0]
    med = torch.where(count > 0, med, torch.zeros_like(med))
    return torch.where((depth > 0) & (torch.abs(depth - med) > max_deviation),
                       med, depth)


def augment_flow(generator: torch.Generator, flow, mask,
                 max_offset: float = 2.0, noise_sigma: float = 0.5):
    """Global offset U(+-max_offset) plus per-pixel N(0, noise_sigma)
    noise on the valid flow (drawn from ``generator``, on the flow's
    device)."""
    offset = (torch.rand(2, generator=generator, device=flow.device) * 2
              - 1) * max_offset
    noise = torch.randn(flow.shape, generator=generator,
                        device=flow.device) * noise_sigma
    return torch.where(mask[..., None], flow + offset + noise, flow)


def rotation_flow(h: int, w: int, angle, device=None):
    """Dense [H, W, 2] flow of an in-plane rotation about the image centre:
    for the rotated image's pixel p, the flow to its source R(-angle)(p -
    c) + c in the original. ``angle`` is f32 (a float or 0-d tensor)."""
    v, u = _grid(h, w, device)
    a = torch.as_tensor(angle, dtype=torch.float32, device=device)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ca, sa = torch.cos(-a), torch.sin(-a)
    x = u - cx
    y = v - cy
    return torch.stack([ca * x - sa * y + cx - u, sa * x + ca * y + cy - v],
                       dim=-1)


def rotate_image(image, angle):
    """Rotate [H, W, C] by ``angle`` about the centre (bilinear)."""
    return warp_image_with_flow(
        image, rotation_flow(image.shape[0], image.shape[1], angle,
                             image.device))


def compose_flows(flow_ab, flow_bc, valid_bc):
    """flow_bc sampled at p + flow_ab with the reference's corner rule
    (all four corners valid: bilinear; some: the nearest valid corner;
    none: invalid), added to flow_ab. Returns (flow_ac, valid)."""
    H, W = flow_ab.shape[:2]
    v, u = _grid(H, W, flow_ab.device)
    px = u + flow_ab[..., 0]
    py = v + flow_ab[..., 1]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    corners_x = torch.stack([x0, x0, x0 + 1, x0 + 1], -1)
    corners_y = torch.stack([y0, y0 + 1, y0, y0 + 1], -1)
    inb = ((corners_x >= 0) & (corners_x <= W - 1)
           & (corners_y >= 0) & (corners_y <= H - 1))
    cx = torch.clamp(corners_x, 0, W - 1).long()
    cy = torch.clamp(corners_y, 0, H - 1).long()
    cvalid = inb & valid_bc[cy, cx]
    cflow = flow_bc[cy, cx]  # [H, W, 4, 2]
    du = px - x0
    dv = py - y0
    w4 = torch.stack([(1 - du) * (1 - dv), (1 - du) * dv, du * (1 - dv),
                      du * dv], -1)
    bilinear = torch.sum(w4[..., None] * cflow, dim=-2)
    dist = torch.hypot(corners_x - px[..., None], corners_y - py[..., None])
    dist = torch.where(cvalid, dist, torch.full_like(dist, math.inf))
    nn = torch.argmin(dist, dim=-1)
    nearest = torch.gather(cflow, -2, nn[..., None, None].expand(
        H, W, 1, 2))[..., 0, :]
    sampled = torch.where(torch.all(cvalid, -1)[..., None], bilinear,
                          nearest)
    return flow_ab + sampled, torch.any(cvalid, -1)


def augmented_flow_from_rotation(flow_sa2so, flow_so2to, valid_so2to,
                                 flow_to2ta):
    """The flow between the two augmented images: the source-side
    rotation, the GT flow and the target-side rotation composed
    (``compute_augmented_flow_from_rotation``). Returns (flow, valid)."""
    c1, v1 = compose_flows(flow_sa2so, flow_so2to, valid_so2to)
    c2, v2 = compose_flows(c1, flow_to2ta, torch.ones_like(v1))
    return c2, v1 & v2
