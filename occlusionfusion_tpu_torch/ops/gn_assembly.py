"""Gauss-Newton point-term block assembly (port of the point term of
``occlusionfusion_tpu/ops/gn_assembly.py``).

``point_term_blocks`` launches kernel K3 (``csrc/gn_assembly.cu``,
replacing the TPU kernel ``point_term_blocks_pallas``) on CUDA tensors
and runs the plain twin ``point_term_blocks_torch`` on CPU tensors. Both
follow ``_assemble_blocks(assembly="blocks")`` of the JAX package, not
the TPU kernel, which gates the blend weights by the point weight and so
gets the residual wrong for fractional weights: the warp blends with the
raw skinning weights, the jacobian with the gated ones, and the residual
carries the point weight once.

Returns (blk [P, 16, 6, 6], b [P, 4, 6], rsq [P]); the 16 anchor pairs
are in (k, l) row-major order, the order of the caller's scatter
segments.
"""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch import device as D
from occlusionfusion_tpu_torch.geometry.so3 import hat
from occlusionfusion_tpu_torch.solvers.gauss_newton import data_residual_rows

K_ANCHORS = 4


def point_term_blocks_torch(points, targets, point_valid, anchors, weights,
                            nodes, R, t, sw: float):
    """Plain twin: gathers, the analytic jacobian blocks, and the pair
    products as one einsum."""
    P, K = anchors.shape
    a = anchors.long()
    g = nodes[a]
    Rk = R[a]
    tk = t[a]
    local = torch.einsum("pkij,pkj->pki", Rk, points[:, None] - g)
    w = weights * point_valid[:, None]
    warped = torch.sum(weights[..., None] * (local + g + tk), dim=1)
    r = data_residual_rows(warped, targets, point_valid, sw)
    Jw = -hat(local) * w[..., None, None]
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    Jt = eye.expand(P, K, 3, 3) * w[..., None, None]
    J = sw * torch.cat([Jw, Jt], dim=-1)  # [P, K, 3, 6]
    blk = torch.einsum("pkai,plaj->pklij", J, J).reshape(P, K * K, 6, 6)
    b = torch.einsum("pkai,pa->pki", J, r)
    return blk, b, torch.sum(r * r, dim=-1)


def point_term_blocks_cuda(points, targets, point_valid, anchors, weights,
                           nodes, R, t, sw: float):
    """Kernel K3. Bound on the H100 by writing its blocks (2.4 KB per
    point); see the note in the source."""
    P, K = anchors.shape
    N = nodes.shape[0]
    if K != K_ANCHORS:
        raise ValueError(f"point-term kernel takes K == 4 anchors, got {K}")
    f32 = torch.float32
    D.check_cuda_tensor("points", points, f32, (P, 3))
    D.check_cuda_tensor("targets", targets, f32, (P, 3))
    D.check_cuda_tensor("point_valid", point_valid, f32, (P,))
    D.check_cuda_tensor("anchors", anchors, torch.int32, (P, K))
    D.check_cuda_tensor("weights", weights, f32, (P, K))
    D.check_cuda_tensor("nodes", nodes, f32, (N, 3))
    D.check_cuda_tensor("R", R, f32, (N, 3, 3))
    D.check_cuda_tensor("t", t, f32, (N, 3))
    dev = points.device
    blk = torch.empty((P, K * K, 6, 6), dtype=f32, device=dev)
    b = torch.empty((P, K, 6), dtype=f32, device=dev)
    rsq = torch.empty((P,), dtype=f32, device=dev)
    if P == 0:
        return blk, b, rsq
    D.launch(
        "of_point_term_blocks", points.data_ptr(), targets.data_ptr(),
        point_valid.data_ptr(), anchors.data_ptr(), weights.data_ptr(),
        nodes.data_ptr(), R.data_ptr(), t.data_ptr(), float(sw), P, N,
        blk.data_ptr(), b.data_ptr(), rsq.data_ptr(),
    )
    D.launch_counts["point_term_blocks"] += 1
    return blk, b, rsq


def point_term_blocks(points, targets, point_valid, anchors, weights, nodes,
                      R, t, sw: float):
    """K3 on CUDA tensors, the twin on CPU tensors."""
    if points.is_cuda:
        c = [x.contiguous() for x in
             (points, targets, point_valid, anchors, weights, nodes, R, t)]
        return point_term_blocks_cuda(*c, sw)
    return point_term_blocks_torch(
        points, targets, point_valid, anchors, weights, nodes, R, t, sw
    )
