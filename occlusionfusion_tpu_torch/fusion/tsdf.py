"""Dense TSDF voxel volume (port of ``occlusionfusion_tpu/fusion/tsdf.py``).

Same semantics as the JAX package: world == camera frame, nearest-pixel
lookup with round-half-even, the ray-length multiplier, updates where the
voxel is in the frustum, observed, within -trunc and reachable by the
warp, and colour as a per-channel weighted running average rounded and
clamped to 255 each step. Colour rides through the gather as the packed
float b*65536 + g*256 + r, exactly as the JAX package does it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from occlusionfusion_tpu_torch.geometry.camera import Intrinsics


class TSDFConfig(NamedTuple):
    vol_dim: tuple
    voxel_size: float
    trunc_margin: float


class TSDFState(NamedTuple):
    tsdf: torch.Tensor  # [X, Y, Z]
    weight: torch.Tensor  # [X, Y, Z]
    color: torch.Tensor  # [X, Y, Z, 3]
    origin: torch.Tensor  # [3] world position of voxel (0, 0, 0)


def create_volume(config: TSDFConfig, origin, device=None) -> TSDFState:
    X, Y, Z = config.vol_dim
    dev = torch.device(device) if device is not None else None
    return TSDFState(
        tsdf=torch.ones((X, Y, Z), dtype=torch.float32, device=dev),
        weight=torch.zeros((X, Y, Z), dtype=torch.float32, device=dev),
        color=torch.zeros((X, Y, Z, 3), dtype=torch.float32, device=dev),
        origin=torch.as_tensor(
            np.asarray(origin, np.float32), device=dev
        ),
    )


def volume_bounds_from_frame(depth: np.ndarray, intr: Intrinsics, vol_dim,
                             voxel_size: float):
    """Volume origin (numpy) so the grid is centred on the observed points."""
    H, W = depth.shape
    v, u = np.mgrid[0:H, 0:W]
    d = np.asarray(depth)
    valid = d > 0
    x = (u - float(intr.cx)) / float(intr.fx) * d
    y = (v - float(intr.cy)) / float(intr.fy) * d
    pts = np.stack([x[valid], y[valid], d[valid]], -1)
    lo = pts.min(0)
    hi = pts.max(0)
    extent = np.asarray(vol_dim) * voxel_size
    center = (lo + hi) / 2
    return center - extent / 2


def voxel_world_points(config: TSDFConfig, origin: torch.Tensor):
    """[V, 3] canonical voxel-centre positions, x-major like the volume."""
    X, Y, Z = config.vol_dim
    dev = origin.device
    axes = [torch.arange(n, dtype=torch.float32, device=dev) for n in (X, Y, Z)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return (origin + grid * config.voxel_size).reshape(-1, 3)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -(2.0**30), 2.0**30).to(torch.int32)


def _pixel_of(points, intr: Intrinsics, H: int, W: int):
    z = points[:, 2]
    zs = torch.where(z > 0, z, torch.ones_like(z))
    # clamp before the int cast: far outside the image either way, and
    # a float beyond int32 has no defined conversion
    px = _to_i32(torch.round(points[:, 0] / zs * intr.fx + intr.cx))
    py = _to_i32(torch.round(points[:, 1] / zs * intr.fy + intr.cy))
    in_frustum = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (z > 0)
    return z, torch.clamp(px, 0, W - 1), torch.clamp(py, 0, H - 1), in_frustum


def project_to_depth(points, depth_im, intr: Intrinsics):
    """Nearest-pixel depth lookup: (depth_val, px, py, in_frustum)."""
    H, W = depth_im.shape
    _, pxc, pyc, in_frustum = _pixel_of(points, intr, H, W)
    flat = (pyc * W + pxc).long()
    depth_val = torch.where(
        in_frustum, depth_im.reshape(-1)[flat], torch.zeros_like(points[:, 2])
    )
    return depth_val, pxc, pyc, in_frustum


def check_visibility(points, depth_im, intr: Intrinsics, trunc_margin: float):
    """(visible [P], depth_diff [P]): depth > 0 and depth - z >= -trunc."""
    depth_val, _, _, _ = project_to_depth(points, depth_im, intr)
    depth_diff = depth_val - points[:, 2]
    visible = (depth_val > 0) & (depth_diff >= -trunc_margin)
    return visible, depth_diff


def integrate(
    config: TSDFConfig,
    state: TSDFState,
    warped_points: torch.Tensor,  # [V, 3]
    warp_valid: torch.Tensor,  # [V]
    depth_im: torch.Tensor,  # [H, W]
    color_im: torch.Tensor,  # [H, W, 3] 0..255
    intr: Intrinsics,
) -> TSDFState:
    """Warp-aware TSDF integration over every voxel of the volume (new
    tensors; the input state is not modified). The state may be dense
    [X, Y, Z] or bricked [MB, B, B, B]; ``warped_points`` and
    ``warp_valid`` follow it raveled in C order (free brick slots
    invalid)."""
    trunc = config.trunc_margin
    H, W = depth_im.shape
    z, px, py, in_frustum = _pixel_of(warped_points, intr, H, W)
    cr = torch.round(color_im)
    packed_col = cr[..., 0] + cr[..., 1] * 256.0 + cr[..., 2] * 65536.0
    rgbd_tab = torch.stack(
        [depth_im.reshape(-1), packed_col.reshape(-1)], dim=-1
    )
    rgbd = rgbd_tab[(py * W + px).long()]  # [V, 2]
    depth_val = torch.where(in_frustum, rgbd[:, 0], torch.zeros_like(z))
    diff = depth_val - z
    # ray-length multiplier (the JAX default ray_multiplier=True)
    mx = (px.to(torch.float32) - intr.cx) / intr.fx
    my = (py.to(torch.float32) - intr.cy) / intr.fy
    diff = diff * torch.sqrt(1.0 + mx * mx + my * my)
    update = warp_valid & in_frustum & (depth_val > 0) & (diff >= -trunc)
    dist = torch.clamp(diff / trunc, max=1.0)

    shape3 = state.tsdf.shape
    upd = update.reshape(shape3)
    w_old = state.weight
    w_add = upd.to(torch.float32)
    w_new = w_old + w_add
    w_safe = torch.clamp(w_new, min=1e-12)
    tsdf_new = torch.where(
        upd,
        (state.tsdf * w_old + w_add * dist.reshape(shape3)) / w_safe,
        state.tsdf,
    )
    p = rgbd[:, 1]
    red = torch.remainder(p, 256.0)
    rem = torch.floor(p / 256.0)
    grn = torch.remainder(rem, 256.0)
    blu = torch.floor(rem / 256.0)
    sampled = torch.stack([red, grn, blu], dim=-1).reshape(shape3 + (3,))
    color_new = torch.where(
        upd[..., None],
        torch.clamp(
            torch.round(
                (state.color * w_old[..., None] + w_add[..., None] * sampled)
                / w_safe[..., None]
            ),
            max=255.0,
        ),
        state.color,
    )
    return TSDFState(
        tsdf=tsdf_new, weight=w_new, color=color_new, origin=state.origin
    )


def truncated_region_mask(tsdf: torch.Tensor, weight: torch.Tensor):
    """Observed voxels whose 3^3 neighbourhood crosses zero (the mask that
    restricts marching cubes to observed surface)."""
    observed = weight > 0
    inf = torch.full_like(tsdf, float("inf"))
    big = torch.where(observed, tsdf, inf)
    small = torch.where(observed, tsdf, -inf)
    nb_max = F.max_pool3d(small[None, None], 3, stride=1, padding=1)[0, 0]
    nb_min = -F.max_pool3d(-big[None, None], 3, stride=1, padding=1)[0, 0]
    return observed & (nb_min <= 0.0) & (nb_max >= 0.0)
