"""Sequence and volume sharding over the ranks of a mesh axis (port of
``occlusionfusion_tpu/parallel/sequence.py``, and the x-slab integrate of
``volume_sharding``).

* ``lstm_node_sharded``: the history [T, N, 4] is batch-parallel over
  nodes for the motion GNN's 2-layer LSTM; each rank runs its node block,
  with no communication.
* ``lstm_time_ring``: T split over the ring; rank r runs time chunk r
  through both layers from the (h, c) carry of both layers that rank
  r - 1 sends, and sends its own on. Layer 1 at chunk r needs only layer
  0's outputs of chunk r and its own carry from r - 1, so this is JAX's
  layer-by-layer ring. gloo sends no CUDA tensors: on a gloo group the
  carry (and only the carry) passes through host copies.
* ``integrate_slab``: each rank integrates its x-slab of the volume, or
  its block of a bricked volume's slots.

Each returns this rank's block; ``mesh.gather_blocks`` assembles them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from occlusionfusion_tpu_torch.fusion import tsdf as T
from occlusionfusion_tpu_torch.models.motion_complete import lstm_forward
from occlusionfusion_tpu_torch.parallel.mesh import (
    _staged,
    axis_index,
    axis_size,
    shard_rows,
    volume_sharding,
)


@torch.no_grad()
def lstm_node_sharded(mesh, lstm, history: torch.Tensor,
                      axis: str = "data") -> torch.Tensor:
    """history [T, N, 4] -> this rank's node block of the top layer's
    hidden states [T, N / n, H]."""
    return lstm_forward(lstm, shard_rows(mesh, history, axis, dim=1))


def _send(x: torch.Tensor, dst: int, group) -> None:
    dist.send(x.cpu() if _staged(group, x) else x,
              dst=dist.get_global_rank(group, dst), group=group)


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = torch.empty_like(like, device="cpu") if _staged(group, like) \
        else torch.empty_like(like)
    dist.recv(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(like.device)


@torch.no_grad()
def lstm_time_ring(mesh, lstm, history: torch.Tensor,
                   axis: str = "data") -> torch.Tensor:
    """history [T, N, 4] with T split over ``axis`` -> this rank's time
    chunk of the top layer's hidden states [T / n, N, H]. Exact, and
    serial across the ring: for histories longer than one device holds,
    not for the 16-frame demo."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    r = axis_index(mesh, axis)
    chunk = shard_rows(mesh, history, axis, dim=0)
    shape = (lstm.num_layers, chunk.shape[1], lstm.hidden_size)
    carry = torch.zeros((2,) + shape, dtype=chunk.dtype, device=chunk.device)
    if r > 0:
        carry = _recv(carry, r - 1, group)
    out, (h, c) = lstm(chunk, (carry[0].contiguous(), carry[1].contiguous()))
    if r + 1 < n:
        _send(torch.stack([h, c]), r + 1, group)
    return out


def integrate_slab(mesh, config: T.TSDFConfig, state: T.TSDFState,
                   warped_points: torch.Tensor, warp_valid: torch.Tensor,
                   depth_im: torch.Tensor, color_im: torch.Tensor, intr,
                   axis: str = "data") -> T.TSDFState:
    """``tsdf.integrate`` of this rank's x-slab: the dense volume
    ``state`` [X, Y, Z] and its raveled voxel rows ``warped_points`` /
    ``warp_valid`` [X Y Z] (x-major) are taken by their block of X; the
    images are replicated. Returns the slab's new state [X / n, Y, Z].
    A bricked volume's slots [MB, B, B, B] with their slot-major rows
    [MB B^3] are taken the same way, by their block of MB."""
    X = state.tsdf.shape[0]
    rows = warped_points.shape[0] // X
    slab = T.TSDFState(
        tsdf=volume_sharding(mesh, state.tsdf, axis),
        weight=volume_sharding(mesh, state.weight, axis),
        color=volume_sharding(mesh, state.color, axis),
        origin=state.origin,
    )
    pts = volume_sharding(mesh, warped_points.reshape(X, rows, 3), axis)
    valid = volume_sharding(mesh, warp_valid.reshape(X, rows), axis)
    return T.integrate(config, slab, pts.reshape(-1, 3), valid.reshape(-1),
                       depth_im, color_im, intr)
