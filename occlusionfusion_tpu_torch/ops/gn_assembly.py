"""Gauss-Newton block assembly (port of
``occlusionfusion_tpu/ops/gn_assembly.py``): the point term and the ARAP
edge term.

``point_term_blocks`` launches kernel K3 (``csrc/gn_assembly.cu``,
replacing the TPU kernel ``point_term_blocks_pallas``) on CUDA tensors
and runs the plain twin ``point_term_blocks_torch`` on CPU tensors. Both
follow ``_assemble_blocks(assembly="blocks")`` of the JAX package, not
the TPU kernel, which gates the blend weights by the point weight and so
gets the residual wrong for fractional weights: the warp blends with the
raw skinning weights, the jacobian with the gated ones, and the residual
carries the point weight once. Returns (blk [P, 16, 6, 6], b [P, 4, 6],
rsq [P]); the 16 anchor pairs are in (k, l) row-major order, the order
of the caller's scatter segments.

``arap_term_blocks`` launches kernel K4 (``csrc/arap_term.cu``,
replacing ``arap_term_blocks_pallas``) on CUDA tensors and runs the
plain twin ``arap_term_blocks_torch`` (the JAX package's XLA ARAP
branch) on CPU tensors. Returns K4's layout: ii [N, 6, 6] summed over
edges, ij/ji/jj [N, E, 6, 6], b_i [N, 6], b_j [N, E, 6], rsq [N].
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


def arap_term_blocks_torch(nodes, R, t, edges, wa):
    """Plain twin of K4 (the XLA ARAP branch of ``_assemble_blocks``).
    ``edges`` [N, E] are clamped >= 0 and ``wa`` [N, E] is
    sqrt(w_arap * edge weight), 0 on invalid edges."""
    N, E = edges.shape
    e = edges.long()
    g_i = nodes[:, None]
    g_j = nodes[e]
    rot = torch.einsum("nij,nkj->nki", R, g_j - g_i)
    r = wa[..., None] * (rot + g_i + t[:, None] - g_j - t[e])
    eye = torch.eye(3, dtype=nodes.dtype, device=nodes.device).expand(
        N, E, 3, 3
    )
    Ji = torch.cat([-hat(rot), eye], dim=-1) * wa[..., None, None]
    Jj = torch.cat([torch.zeros_like(eye), -eye], dim=-1) * wa[..., None, None]
    ii = torch.sum(torch.einsum("neai,neaj->neij", Ji, Ji), dim=1)
    ij = torch.einsum("neai,neaj->neij", Ji, Jj)
    jj = torch.einsum("neai,neaj->neij", Jj, Jj)
    b_i = torch.sum(torch.einsum("neai,nea->nei", Ji, r), dim=1)
    b_j = torch.einsum("neai,nea->nei", Jj, r)
    rsq = torch.sum(r * r, dim=(1, 2))
    return ii, ij, ij.transpose(2, 3), jj, b_i, b_j, rsq


def arap_term_blocks_cuda(nodes, R, t, edges, wa):
    """Kernel K4. Bound on the H100 by writing its blocks (3.8 KB per
    node) and in practice by its launch; see the note in the source."""
    N, E = edges.shape
    f32 = torch.float32
    D.check_cuda_tensor("nodes", nodes, f32, (N, 3))
    D.check_cuda_tensor("R", R, f32, (N, 3, 3))
    D.check_cuda_tensor("t", t, f32, (N, 3))
    D.check_cuda_tensor("edges", edges, torch.int32, (N, E))
    D.check_cuda_tensor("wa", wa, f32, (N, E))
    dev = nodes.device
    ii = torch.empty((N, 6, 6), dtype=f32, device=dev)
    ij, ji, jj = (torch.empty((N, E, 6, 6), dtype=f32, device=dev)
                  for _ in range(3))
    b_i = torch.empty((N, 6), dtype=f32, device=dev)
    b_j = torch.empty((N, E, 6), dtype=f32, device=dev)
    rsq = torch.empty((N,), dtype=f32, device=dev)
    if N == 0:
        return ii, ij, ji, jj, b_i, b_j, rsq
    D.launch(
        "of_arap_term_blocks", nodes.data_ptr(), R.data_ptr(), t.data_ptr(),
        edges.data_ptr(), wa.data_ptr(), N, E, ii.data_ptr(), ij.data_ptr(),
        ji.data_ptr(), jj.data_ptr(), b_i.data_ptr(), b_j.data_ptr(),
        rsq.data_ptr(),
    )
    D.launch_counts["arap_term_blocks"] += 1
    return ii, ij, ji, jj, b_i, b_j, rsq


def arap_term_blocks(nodes, R, t, edges, wa):
    """K4 on CUDA tensors, the twin on CPU tensors."""
    if nodes.is_cuda:
        return arap_term_blocks_cuda(
            *(x.contiguous() for x in (nodes, R, t, edges.to(torch.int32), wa))
        )
    return arap_term_blocks_torch(nodes, R, t, edges, wa)
