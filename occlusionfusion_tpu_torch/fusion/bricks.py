"""Sparse bricked TSDF (port of ``occlusionfusion_tpu/fusion/bricks.py``).

The virtual volume is cut into B^3-voxel bricks; a static-capacity slot
table holds the active ones, so the TSDF state is [MB, B, B, B] instead
of [X, Y, Z] and ``tsdf.integrate`` consumes its voxels raveled in C
order. Activation is a host decision (numpy) at initialization and at
growth keyframes: a brick is active when its box meets the truncation
band of an observed depth point, dilated by ``dilate`` bricks (the
``brick_dilate`` setting). A keyframe refresh carries the integrated data
into the new slot layout with one device gather (``remap_slots``,
``apply_remap``).

Brick ids are linear indices into the virtual brick grid
(``bx * GY * GZ + by * GZ + bz``); free slots carry id -1, their voxels
are masked invalid, and their dummy positions sit at the volume origin.

Everything here but ``create_brick_volume`` and ``apply_remap`` is host
numpy code, copied from the JAX package so that the port never imports
it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from occlusionfusion_tpu_torch.fusion.tsdf import TSDFState
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

class BrickGrid(NamedTuple):
    """Static brick-grid geometry."""

    vol_dim: tuple  # virtual voxel grid (X, Y, Z)
    voxel_size: float
    brick: int  # voxels per brick edge
    max_bricks: int  # static slot capacity

    @property
    def grid_dim(self):
        b = self.brick
        return tuple(-(-d // b) for d in self.vol_dim)


def _backproject_valid(depth: np.ndarray, intr: Intrinsics):
    H, W = depth.shape
    v, u = np.mgrid[0:H, 0:W]
    d = np.asarray(depth)
    valid = d > 0
    x = (u - float(intr.cx)) / float(intr.fx) * d
    y = (v - float(intr.cy)) / float(intr.fy) * d
    return np.stack([x[valid], y[valid], d[valid]], -1)


def active_bricks_from_points(
    grid: BrickGrid,
    origin: np.ndarray,
    points: np.ndarray,
    trunc: float,
    dilate: int = 1,
) -> np.ndarray:
    """Sorted linear ids of bricks whose box meets the trunc-inflated box
    of any of the given world points, dilated by ``dilate`` bricks
    (6-neighbourhood per step)."""
    GX, GY, GZ = grid.grid_dim
    bs = grid.brick * grid.voxel_size
    occ = np.zeros((GX, GY, GZ), bool)
    if len(points):
        r = trunc
        lo = np.floor((points - origin - r) / bs).astype(np.int64)
        hi = np.floor((points - origin + r) / bs).astype(np.int64)
        lo = np.clip(lo, 0, np.asarray([GX - 1, GY - 1, GZ - 1]))
        hi = np.clip(hi, 0, np.asarray([GX - 1, GY - 1, GZ - 1]))
        span = hi - lo  # per-axis 0..ceil(2r/bs)
        m = int(span.max()) + 1
        for dx in range(m):
            for dy in range(m):
                for dz in range(m):
                    sel = (
                        (dx <= span[:, 0])
                        & (dy <= span[:, 1])
                        & (dz <= span[:, 2])
                    )
                    c = lo[sel] + np.asarray([dx, dy, dz])
                    occ[c[:, 0], c[:, 1], c[:, 2]] = True
    for _ in range(dilate):
        grown = occ.copy()
        grown[1:] |= occ[:-1]
        grown[:-1] |= occ[1:]
        grown[:, 1:] |= occ[:, :-1]
        grown[:, :-1] |= occ[:, 1:]
        grown[:, :, 1:] |= occ[:, :, :-1]
        grown[:, :, :-1] |= occ[:, :, 1:]
        occ = grown
    return np.flatnonzero(occ.reshape(-1)).astype(np.int32)


def active_bricks_from_depth(
    grid: BrickGrid,
    origin: np.ndarray,
    depth: np.ndarray,
    intr: Intrinsics,
    trunc: float,
    dilate: int = 1,
) -> np.ndarray:
    return active_bricks_from_points(
        grid, origin, _backproject_valid(depth, intr), trunc, dilate
    )


def pack_brick_ids(grid: BrickGrid, ids: np.ndarray) -> np.ndarray:
    """[max_bricks] int32 slot table; -1 marks a free slot."""
    if len(ids) > grid.max_bricks:
        raise ValueError(
            f"{len(ids)} active bricks exceed max_bricks={grid.max_bricks}"
        )
    out = -np.ones(grid.max_bricks, np.int32)
    out[: len(ids)] = np.sort(ids)
    return out


def create_brick_volume(grid: BrickGrid, origin, device) -> TSDFState:
    """An empty [MB, B, B, B] volume on ``device``."""
    B, MB = grid.brick, grid.max_bricks
    dev = torch.device(device)
    return TSDFState(
        tsdf=torch.ones((MB, B, B, B), dtype=torch.float32, device=dev),
        weight=torch.zeros((MB, B, B, B), dtype=torch.float32, device=dev),
        color=torch.zeros((MB, B, B, B, 3), dtype=torch.float32, device=dev),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=dev),
    )


def brick_voxel_points(
    grid: BrickGrid, origin: np.ndarray, brick_ids: np.ndarray
):
    """([MB*B^3, 3] f32 canonical voxel centres, [MB*B^3] bool valid), in
    the [MB, B, B, B] state's C order; free slots sit at the origin."""
    B = grid.brick
    GX, GY, GZ = grid.grid_dim
    ids = np.asarray(brick_ids, np.int64)
    slot_valid = ids >= 0
    safe = np.where(slot_valid, ids, 0)
    bx = safe // (GY * GZ)
    by = (safe // GZ) % GY
    bz = safe % GZ
    corner = np.stack([bx, by, bz], -1).astype(np.float32) * B  # [MB, 3] vox
    r = np.arange(B, dtype=np.float32)
    local = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    vox = (corner[:, None] + local[None]) * grid.voxel_size + np.asarray(
        origin, np.float32
    )
    vox = np.where(slot_valid[:, None, None], vox, np.asarray(origin))
    valid = np.repeat(slot_valid, B * B * B)
    return vox.reshape(-1, 3).astype(np.float32), valid


def scatter_to_dense(
    grid: BrickGrid,
    brick_ids: np.ndarray,
    tsdf_bricks: np.ndarray,  # [MB, B, B, B]
    weight_bricks: np.ndarray,
):
    """The brick table expanded to the dense virtual grid (host; for
    marching cubes), unallocated voxels at tsdf 1 and weight 0. Returns
    dense (tsdf, weight)."""
    B = grid.brick
    GX, GY, GZ = grid.grid_dim
    tsdf = np.ones((GX * B, GY * B, GZ * B), np.float32)
    weight = np.zeros((GX * B, GY * B, GZ * B), np.float32)
    for slot, bid in enumerate(np.asarray(brick_ids)):
        if bid < 0:
            continue
        bx = bid // (GY * GZ)
        by = (bid // GZ) % GY
        bz = bid % GZ
        sx, sy, sz = bx * B, by * B, bz * B
        tsdf[sx : sx + B, sy : sy + B, sz : sz + B] = tsdf_bricks[slot]
        weight[sx : sx + B, sy : sy + B, sz : sz + B] = weight_bricks[slot]
    x, y, z = grid.vol_dim
    return tsdf[:x, :y, :z], weight[:x, :y, :z]


def remap_slots(old_ids: np.ndarray, new_ids: np.ndarray) -> np.ndarray:
    """[MB] int32: for each new slot, the old slot holding the same brick,
    or -1 for a freshly activated or free one."""
    lookup = {int(b): i for i, b in enumerate(np.asarray(old_ids)) if b >= 0}
    out = -np.ones(len(new_ids), np.int32)
    for i, b in enumerate(np.asarray(new_ids)):
        if b >= 0 and int(b) in lookup:
            out[i] = lookup[int(b)]
    return out


def apply_remap(state: TSDFState, perm: np.ndarray) -> TSDFState:
    """The brick data carried into the new slot layout ``perm``
    (``remap_slots``) by one device gather; fresh slots reset to tsdf 1,
    weight 0 and colour 0."""
    dev = state.tsdf.device
    perm_t = torch.as_tensor(np.asarray(perm, np.int64), device=dev)
    fresh = (perm_t < 0)[:, None, None, None]
    safe = torch.clamp(perm_t, min=0)
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return TSDFState(
        tsdf=torch.where(fresh, one, state.tsdf[safe]),
        weight=torch.where(fresh, zero, state.weight[safe]),
        color=torch.where(fresh[..., None], zero, state.color[safe]),
        origin=state.origin,
    )
