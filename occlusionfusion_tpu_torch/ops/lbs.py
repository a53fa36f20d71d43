"""Linear-blend-skinning voxel warp (port of ``occlusionfusion_tpu/ops/lbs.py``).

``lbs_warp`` launches kernel K2 (``csrc/lbs.cu``, replacing the TPU
kernel ``lbs_warp_pallas``) on CUDA tensors and runs the plain twin
``lbs_warp_torch`` (the port of ``lbs_warp_lax``: gather + einsum through
``warpfield.deform_points``) on CPU tensors. The kernel works in origin
form, y = (sum_k w_k R_k) x + sum_k w_k t'_k, and forms the table of
t' = (t + g) - R g itself, in shared memory, from the warp field's
tensors; invalid points pass through. The two forms agree to ~1e-6 m at
metre scale. ``pack_transforms`` builds the same table with torch ops,
as the JAX package's ``_pack_transforms`` does.
"""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch import device as D
from occlusionfusion_tpu_torch.fusion.warpfield import (
    SkinTable,
    WarpFieldState,
    deform_points,
    to_origin_form,
)
from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp


def pack_transforms(state: WarpFieldState) -> torch.Tensor:
    """[N, 12]: row-major R (origin form), then t'."""
    R, t_origin = to_origin_form(state)
    return torch.cat([R.reshape(-1, 9), t_origin], dim=-1).contiguous()


def lbs_warp_torch(points, anchors, weights, valid, state: WarpFieldState):
    """Plain twin (gather + einsum). On the CPU it warps only the valid
    points, with the same arithmetic per point: most voxels of a volume
    are unreachable and pass through unchanged."""
    if points.is_cuda:
        return deform_points(state, points,
                             SkinTable(anchors, weights, valid))
    rows = torch.nonzero(valid)[:, 0]
    out = points.clone()
    out[rows] = ed_warp(points[rows], state.node_positions, state.rotations,
                        state.translations, anchors[rows], weights[rows])
    return out


# the most nodes whose origin-form table (48 bytes a node) K2 holds in
# shared memory on the H100 beside its per-warp staging buffers (16 warps
# x 96 floats)
MAX_NODES = (D.SMEM_PER_BLOCK - 16 * 96 * 4) // 48


def lbs_warp_cuda(points, anchors, weights, valid, state: WarpFieldState):
    """Kernel K2. Bound on the H100 by device memory (25 bytes per
    voxel, 32 more per valid one); see the note in the source."""
    P, K = anchors.shape
    N = state.node_positions.shape[0]
    if K != 4:
        raise ValueError(f"LBS kernel takes K == 4 anchors, got {K}")
    if N > MAX_NODES:
        raise ValueError(
            f"LBS kernel holds at most {MAX_NODES} nodes in shared memory "
            f"({D.SMEM_PER_BLOCK} bytes), got {N}")
    # the kernel reads a voxel's anchors and weights as one 16-byte load
    D.check_aligned("anchors", anchors, 16)
    D.check_aligned("weights", weights, 16)
    nodes = state.node_positions.contiguous()
    rot = state.rotations.contiguous()
    trans = state.translations.contiguous()
    dev = D.tensors_device(
        points=points, anchors=anchors, weights=weights, valid=valid,
        node_positions=nodes, rotations=rot, translations=trans,
    )
    D.check_cuda_tensor("points", points, torch.float32, (P, 3))
    D.check_cuda_tensor("anchors", anchors, torch.int32, (P, K))
    D.check_cuda_tensor("weights", weights, torch.float32, (P, K))
    D.check_cuda_tensor("valid", valid, torch.bool, (P,))
    D.check_cuda_tensor("node_positions", nodes, torch.float32, (N, 3))
    D.check_cuda_tensor("rotations", rot, torch.float32, (N, 3, 3))
    D.check_cuda_tensor("translations", trans, torch.float32, (N, 3))
    out = torch.empty((P, 3), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    D.launch(
        "of_lbs_warp", dev, points.data_ptr(), anchors.data_ptr(),
        weights.data_ptr(), valid.data_ptr(), nodes.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), P, K, N, out.data_ptr(),
    )
    D.count_launch("lbs_warp")
    return out


def lbs_warp(points, anchors, weights, valid, state: WarpFieldState):
    """K2 on CUDA tensors, the twin on CPU tensors."""
    if points.is_cuda:
        return lbs_warp_cuda(
            points.contiguous(), anchors.contiguous(), weights.contiguous(),
            valid.contiguous(), state,
        )
    return lbs_warp_torch(points, anchors, weights, valid, state)
