"""Linear-blend-skinning voxel warp (port of ``occlusionfusion_tpu/ops/lbs.py``).

``lbs_warp`` launches kernel K2 (``csrc/lbs.cu``, replacing the TPU
kernel ``lbs_warp_pallas``) on CUDA tensors and runs the plain twin
``lbs_warp_torch`` (the port of ``lbs_warp_lax``: gather + einsum through
``warpfield.deform_points``) on CPU tensors. The kernel works in origin
form, y = (sum_k w_k R_k) x + sum_k w_k t'_k; invalid points pass
through. The two forms agree to ~1e-6 m at metre scale.
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


def pack_transforms(state: WarpFieldState) -> torch.Tensor:
    """[N, 12]: row-major R (origin form), then t'."""
    R, t_origin = to_origin_form(state)
    return torch.cat([R.reshape(-1, 9), t_origin], dim=-1).contiguous()


def lbs_warp_torch(points, anchors, weights, valid, state: WarpFieldState):
    """Plain twin (gather + einsum)."""
    return deform_points(state, points, SkinTable(anchors, weights, valid))


def lbs_warp_cuda(points, anchors, weights, valid, state: WarpFieldState):
    """Kernel K2. Bound on the H100 by device memory (57 bytes per
    point); see the note in the source."""
    P, K = anchors.shape
    N = state.node_positions.shape[0]
    if K != 4:
        raise ValueError(f"LBS kernel takes K == 4 anchors, got {K}")
    dev = D.tensors_device(
        points=points, anchors=anchors, weights=weights, valid=valid,
        node_positions=state.node_positions, rotations=state.rotations,
        translations=state.translations,
    )
    D.check_cuda_tensor("points", points, torch.float32, (P, 3))
    D.check_cuda_tensor("anchors", anchors, torch.int32, (P, K))
    D.check_cuda_tensor("weights", weights, torch.float32, (P, K))
    D.check_cuda_tensor("valid", valid, torch.bool, (P,))
    T = pack_transforms(state)
    D.check_cuda_tensor("transforms", T, torch.float32, (N, 12))
    out = torch.empty((P, 3), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    D.launch(
        "of_lbs_warp", dev, points.data_ptr(), anchors.data_ptr(),
        weights.data_ptr(), valid.data_ptr(), T.data_ptr(), P, K, N,
        out.data_ptr(),
    )
    D.launch_counts["lbs_warp"] += 1
    return out


def lbs_warp(points, anchors, weights, valid, state: WarpFieldState):
    """K2 on CUDA tensors, the twin on CPU tensors."""
    if points.is_cuda:
        return lbs_warp_cuda(
            points.contiguous(), anchors.contiguous(), weights.contiguous(),
            valid.contiguous(), state,
        )
    return lbs_warp_torch(points, anchors, weights, valid, state)
