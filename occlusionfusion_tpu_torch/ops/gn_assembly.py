"""Gauss-Newton normal equations (port of
``occlusionfusion_tpu/ops/gn_assembly.py``): the point term and the ARAP
edge term with the motion prior, each added in place into the dense
system M [6N, 6N], b [6N] and sq that the caller owns and zeroes.

``point_term_accumulate`` launches kernel K3' (``csrc/gn_assembly.cu``,
replacing the TPU kernel ``point_term_blocks_pallas`` and the caller's
scatter of its blocks) on CUDA tensors. On CPU tensors it runs the plain
twin ``point_term_accumulate_torch``: the per-point blocks of
``point_term_blocks_torch`` segment-summed into the [N*N, 36] block table
and permuted into M's layout. Both follow
``_assemble_blocks(assembly="blocks")`` of the JAX package, not the TPU
kernel, which gates the blend weights by the point weight and so gets
the residual wrong for fractional weights: the warp blends with the raw
skinning weights, the jacobian with the gated ones, and the residual
carries the point weight once.

``arap_term_accumulate`` launches kernel K4' (``csrc/arap_term.cu``,
replacing ``arap_term_blocks_pallas``, the caller's scatter and the
motion-prior ops) on CUDA tensors, and runs the plain twin
``arap_term_accumulate_torch`` (the per-edge blocks of
``arap_term_blocks_torch``, the JAX package's XLA ARAP branch, scattered
the same way, plus the motion prior) on CPU tensors.

M's layout is the JAX package's: the 6x6 block of node pair (a, c)
starts at row 6a, column 6c. Both kernels add with atomics, so their sum
order varies from run to run on the card.
"""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch import device as D
from occlusionfusion_tpu_torch.geometry.so3 import hat
from occlusionfusion_tpu_torch.ops.segment_ops import segment_sum
from occlusionfusion_tpu_torch.solvers.gauss_newton import data_residual_rows

K_ANCHORS = 4


def point_term_blocks_torch(points, targets, point_valid, anchors, weights,
                            nodes, R, t, sw: float):
    """Per-point blocks: gathers, the analytic jacobian blocks, and the
    pair products as one einsum. Returns (blk [P, 16, 6, 6], b [P, 4, 6],
    rsq [P]); the 16 anchor pairs in (k, l) row-major order."""
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


def arap_term_blocks_torch(nodes, R, t, edges, wa):
    """Per-edge blocks (the XLA ARAP branch of ``_assemble_blocks``).
    ``edges`` [N, E] are clamped >= 0 and ``wa`` [N, E] is
    sqrt(w_arap * edge weight), 0 on invalid edges. Returns ii [N, 6, 6]
    summed over edges, ij/ji/jj [N, E, 6, 6], b_i [N, 6], b_j [N, E, 6],
    rsq [N]."""
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


def _add_block_table(M, table):
    """M [6N, 6N] += the [N*N, 36] block table in M's layout."""
    n = M.shape[0] // 6
    M += table.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)


def point_term_accumulate_torch(points, targets, point_valid, anchors,
                                weights, nodes, R, t, sw: float, M, b, sq):
    """Plain twin of K3': the per-point blocks, one segment-sum of them
    into the [N*N, 36] block table, then M's layout."""
    n = nodes.shape[0]
    blk, b_pt, rsq = point_term_blocks_torch(
        points, targets, point_valid, anchors, weights, nodes, R, t, sw
    )
    a = anchors.long()
    seg = (a[:, :, None] * n + a[:, None, :]).reshape(-1)
    _add_block_table(M, segment_sum(blk.reshape(-1, 36), seg, n * n))
    b += segment_sum(b_pt.reshape(-1, 6), a.reshape(-1), n).reshape(-1)
    sq += torch.sum(rsq)


def point_term_accumulate_cuda(points, targets, point_valid, anchors,
                               weights, nodes, R, t, sw: float, M, b, sq):
    """Kernel K3'. Bound on the H100 by its atomics into M; see the note
    in the source."""
    P, K = anchors.shape
    N = nodes.shape[0]
    if K != K_ANCHORS:
        raise ValueError(f"point-term kernel takes K == 4 anchors, got {K}")
    dev = D.tensors_device(
        points=points, targets=targets, point_valid=point_valid,
        anchors=anchors, weights=weights, nodes=nodes, R=R, t=t, M=M, b=b,
        sq=sq,
    )
    f32 = torch.float32
    D.check_cuda_tensor("points", points, f32, (P, 3))
    D.check_cuda_tensor("targets", targets, f32, (P, 3))
    D.check_cuda_tensor("point_valid", point_valid, f32, (P,))
    D.check_cuda_tensor("anchors", anchors, torch.int32, (P, K))
    D.check_cuda_tensor("weights", weights, f32, (P, K))
    D.check_cuda_tensor("nodes", nodes, f32, (N, 3))
    D.check_cuda_tensor("R", R, f32, (N, 3, 3))
    D.check_cuda_tensor("t", t, f32, (N, 3))
    _check_system(M, b, sq, N)
    if P == 0:
        return
    D.launch(
        "of_point_term_accumulate", dev, points.data_ptr(),
        targets.data_ptr(), point_valid.data_ptr(), anchors.data_ptr(),
        weights.data_ptr(), nodes.data_ptr(), R.data_ptr(), t.data_ptr(),
        float(sw), P, N, M.data_ptr(), b.data_ptr(), sq.data_ptr(),
    )
    D.launch_counts["point_term_blocks"] += 1


def point_term_accumulate(points, targets, point_valid, anchors, weights,
                          nodes, R, t, sw: float, M, b, sq):
    """Add the point term into (M, b, sq): K3' on CUDA tensors, the twin
    on CPU tensors."""
    if points.is_cuda:
        c = [x.contiguous() for x in
             (points, targets, point_valid, anchors, weights, nodes, R, t)]
        point_term_accumulate_cuda(*c, sw, M, b, sq)
    else:
        point_term_accumulate_torch(points, targets, point_valid, anchors,
                                    weights, nodes, R, t, sw, M, b, sq)


def arap_term_accumulate_torch(nodes, R, t, edges, wa, wm, motion_targets,
                               M, b, sq):
    """Plain twin of K4': the per-edge blocks, one segment-sum of ij, ji
    and jj plus ii and the motion prior on the diagonal into the block
    table, then M's layout. ``wm`` [N] is the motion prior's weight,
    sqrt(w_motion) * confidence on valid nodes; its residual is
    r_m = wm (g + t - m)."""
    n, E = edges.shape
    ii, ij, ji, jj, b_i, b_j, rsq = arap_term_blocks_torch(
        nodes, R, t, edges, wa
    )
    e = edges.long()
    idx_i = torch.arange(n, device=nodes.device)[:, None].expand(n, E)
    segs = torch.cat([(idx_i * n + e).reshape(-1), (e * n + idx_i).reshape(-1),
                      (e * n + e).reshape(-1)])
    table = segment_sum(
        torch.cat([x.reshape(-1, 36) for x in (ij, ji, jj)]), segs, n * n
    )
    r_m = wm[:, None] * (nodes + t - motion_targets)
    mot = torch.zeros((n, 6, 6), dtype=nodes.dtype, device=nodes.device)
    mot[:, 3:, 3:] = torch.eye(3, device=nodes.device) * (wm**2)[:, None, None]
    diag = torch.arange(n, device=nodes.device) * (n + 1)
    table.index_add_(0, diag, (ii + mot).reshape(-1, 36))
    _add_block_table(M, table)
    b_nodes = segment_sum(b_j.reshape(-1, 6), e.reshape(-1), n) + b_i
    b_nodes[:, 3:] += wm[:, None] * r_m
    b += b_nodes.reshape(-1)
    sq += torch.sum(rsq) + torch.sum(r_m * r_m)


def arap_term_accumulate_cuda(nodes, R, t, edges, wa, wm, motion_targets,
                              M, b, sq):
    """Kernel K4'. Bound on the H100 by its launch and its atomics' latency;
    see the note in the source."""
    N, E = edges.shape
    if E > 32:
        raise ValueError(f"ARAP kernel takes at most 32 edge slots, got {E}")
    dev = D.tensors_device(
        nodes=nodes, R=R, t=t, edges=edges, wa=wa, wm=wm,
        motion_targets=motion_targets, M=M, b=b, sq=sq,
    )
    f32 = torch.float32
    D.check_cuda_tensor("nodes", nodes, f32, (N, 3))
    D.check_cuda_tensor("R", R, f32, (N, 3, 3))
    D.check_cuda_tensor("t", t, f32, (N, 3))
    D.check_cuda_tensor("edges", edges, torch.int32, (N, E))
    D.check_cuda_tensor("wa", wa, f32, (N, E))
    D.check_cuda_tensor("wm", wm, f32, (N,))
    D.check_cuda_tensor("motion_targets", motion_targets, f32, (N, 3))
    _check_system(M, b, sq, N)
    if N == 0:
        return
    D.launch(
        "of_arap_term_accumulate", dev, nodes.data_ptr(), R.data_ptr(),
        t.data_ptr(), edges.data_ptr(), wa.data_ptr(), wm.data_ptr(),
        motion_targets.data_ptr(), N, E, M.data_ptr(), b.data_ptr(),
        sq.data_ptr(),
    )
    D.launch_counts["arap_term_blocks"] += 1


def arap_term_accumulate(nodes, R, t, edges, wa, wm, motion_targets, M, b,
                         sq):
    """Add the ARAP term and the motion prior into (M, b, sq): K4' on
    CUDA tensors, the twin on CPU tensors. ``edges`` [N, E] are clamped
    >= 0, ``wa`` is 0 on invalid edges and ``wm`` 0 where the prior is
    off."""
    if nodes.is_cuda:
        arap_term_accumulate_cuda(
            *(x.contiguous() for x in (nodes, R, t, edges.to(torch.int32), wa,
                                       wm, motion_targets)), M, b, sq,
        )
    else:
        arap_term_accumulate_torch(nodes, R, t, edges, wa, wm,
                                   motion_targets, M, b, sq)


def _check_system(M, b, sq, N: int) -> None:
    """The kernels add into M [6N, 6N], b [6N] and sq [] in place, with
    8-byte vector atomics on M and b."""
    f32 = torch.float32
    D.check_cuda_tensor("M", M, f32, (6 * N, 6 * N))
    D.check_cuda_tensor("b", b, f32, (6 * N,))
    D.check_cuda_tensor("sq", sq, f32, ())
    if M.data_ptr() % 8 or b.data_ptr() % 8:
        raise ValueError("M and b must be 8-byte aligned")
