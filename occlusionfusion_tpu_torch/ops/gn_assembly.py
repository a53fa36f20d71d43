"""Gauss-Newton normal equations (port of
``occlusionfusion_tpu/ops/gn_assembly.py``): the point term and the ARAP
edge term with the motion prior, each added in place into the dense
system M [6N, 6N], b [6N] and sq that the caller owns and zeroes.

``point_term_accumulate`` launches kernel K3' (``csrc/gn_assembly.cu``,
replacing the TPU kernel ``point_term_blocks_pallas`` and the caller's
scatter of its blocks) on CUDA tensors. On CPU tensors it runs the plain
twin ``point_term_accumulate_torch``: the per-point blocks of
``point_term_blocks_torch`` summed into M at their anchor pairs. Both follow
``_assemble_blocks(assembly="blocks")`` of the JAX package, not the TPU
kernel, which gates the blend weights by the point weight and so gets
the residual wrong for fractional weights: the warp blends with the raw
skinning weights, the jacobian with the gated ones, and the residual
carries the point weight once. With ``proj`` = (fx, fy, sf, sd) both add
the 2d_depth data term instead of point3d: the residual is the projected
rows (sf (u - tu), sf (v - tv), sd (z - tz)) and each jacobian block is
G J_k, G the row scaling at the warped point (JAX
``projection_row_scaling``); the JAX package sends this data term to its
XLA "blocks" assembly on every backend, which both follow.

``arap_term_accumulate`` launches kernel K4' (``csrc/arap_term.cu``,
replacing ``arap_term_blocks_pallas``, the caller's scatter and the
motion-prior ops) on CUDA tensors, and runs the plain twin
``arap_term_accumulate_torch`` (the per-edge blocks of
``arap_term_blocks_torch``, the JAX package's XLA ARAP branch, summed
into M the same way, plus the motion prior) on CPU tensors.

M's layout is the JAX package's: the 6x6 block of node pair (a, c)
starts at row 6a, column 6c. Both kernels add with atomics, so their sum
order varies from run to run on the card.

``PointTermAssembly`` and ``ArapTermAssembly`` make the two terms
differentiable (the through-solver tracking trainer backpropagates
through the Gauss-Newton solve): their forward is the dispatching
accumulate into fresh zero tensors, K3'/K4' on CUDA tensors, and their
backward the twin's vector-Jacobian product at the saved inputs.
"""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch import device as D
from occlusionfusion_tpu_torch.geometry.so3 import hat
from occlusionfusion_tpu_torch.ops.segment_ops import segment_sum
from occlusionfusion_tpu_torch.solvers.gauss_newton import (
    data_rows,
    row_scaling,
)

K_ANCHORS = 4


def point_term_blocks_torch(points, targets, point_valid, anchors, weights,
                            nodes, R, t, sw: float, proj=None):
    """Per-point blocks: gathers, the analytic jacobian blocks (scaled by
    the 2d_depth rows' G where ``proj``), and the pair products as one
    einsum. Returns (blk [P, 16, 6, 6], b [P, 4, 6], rsq [P]); the 16
    anchor pairs in (k, l) row-major order."""
    P, K = anchors.shape
    a = anchors.long()
    g = nodes[a]
    Rk = R[a]
    tk = t[a]
    local = torch.einsum("pkij,pkj->pki", Rk, points[:, None] - g)
    w = weights * point_valid[:, None]
    warped = torch.sum(weights[..., None] * (local + g + tk), dim=1)
    r = sw * point_valid[:, None] * data_rows(warped, targets, proj)
    Jw = -hat(local) * w[..., None, None]
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    Jt = eye.expand(P, K, 3, 3) * w[..., None, None]
    J = sw * torch.cat([Jw, Jt], dim=-1)  # [P, K, 3, 6]
    if proj is not None:
        J = torch.einsum("pab,pkbc->pkac", row_scaling(warped, proj), J)
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


def _add_blocks(M, seg, blocks):
    """M [6N, 6N] += each 6x6 block at node pair seg = a * N + c, equal
    pairs summed (the segment-sum into the [N*N, 36] block table and its
    permute into M's layout, in one accumulating write through a view)."""
    n = M.shape[0] // 6
    M.view(n, 6, n, 6).permute(0, 2, 1, 3).index_put_(
        (seg // n, seg % n), blocks.reshape(-1, 6, 6), accumulate=True)


def point_term_accumulate_torch(points, targets, point_valid, anchors,
                                weights, nodes, R, t, sw: float, M, b, sq,
                                proj=None):
    """Plain twin of K3': the per-point blocks, summed into M at their
    anchor pairs."""
    n = nodes.shape[0]
    blk, b_pt, rsq = point_term_blocks_torch(
        points, targets, point_valid, anchors, weights, nodes, R, t, sw,
        proj,
    )
    a = anchors.long()
    _add_blocks(M, (a[:, :, None] * n + a[:, None, :]).reshape(-1), blk)
    b += segment_sum(b_pt.reshape(-1, 6), a.reshape(-1), n).reshape(-1)
    sq += torch.sum(rsq)


def point_term_accumulate_cuda(points, targets, point_valid, anchors,
                               weights, nodes, R, t, sw: float, M, b, sq,
                               proj=None):
    """Kernel K3'. Bound on the H100 by its atomics into M; see the note
    in the source. ``proj`` = (fx, fy, sf, sd) selects the 2d_depth
    rows."""
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
    fx, fy, sf, sd = (0.0, 0.0, 0.0, 0.0) if proj is None else proj
    D.launch(
        "of_point_term_accumulate", dev, points.data_ptr(),
        targets.data_ptr(), point_valid.data_ptr(), anchors.data_ptr(),
        weights.data_ptr(), nodes.data_ptr(), R.data_ptr(), t.data_ptr(),
        float(sw), int(proj is not None), float(fx), float(fy), float(sf),
        float(sd), P, N, M.data_ptr(), b.data_ptr(), sq.data_ptr(),
    )
    D.count_launch("point_term_blocks")


def point_term_accumulate(points, targets, point_valid, anchors, weights,
                          nodes, R, t, sw: float, M, b, sq, proj=None):
    """Add the point term (point3d, or 2d_depth with ``proj`` = (fx, fy,
    sf, sd)) into (M, b, sq): K3' on CUDA tensors, the twin on CPU
    tensors."""
    if points.is_cuda:
        c = [x.contiguous() for x in
             (points, targets, point_valid, anchors, weights, nodes, R, t)]
        point_term_accumulate_cuda(*c, sw, M, b, sq, proj=proj)
    else:
        point_term_accumulate_torch(points, targets, point_valid, anchors,
                                    weights, nodes, R, t, sw, M, b, sq,
                                    proj=proj)


def arap_term_accumulate_torch(nodes, R, t, edges, wa, wm, motion_targets,
                               M, b, sq):
    """Plain twin of K4': the per-edge blocks ij, ji and jj and, on the
    diagonal, ii and the motion prior, summed into M at their node pairs. ``wm`` [N] is the motion prior's weight,
    sqrt(w_motion) * confidence on valid nodes; its residual is
    r_m = wm (g + t - m)."""
    n, E = edges.shape
    ii, ij, ji, jj, b_i, b_j, rsq = arap_term_blocks_torch(
        nodes, R, t, edges, wa
    )
    e = edges.long()
    idx_i = torch.arange(n, device=nodes.device)[:, None].expand(n, E)
    r_m = wm[:, None] * (nodes + t - motion_targets)
    mot = torch.zeros((n, 6, 6), dtype=nodes.dtype, device=nodes.device)
    mot[:, 3:, 3:] = torch.eye(3, device=nodes.device) * (wm**2)[:, None, None]
    diag = torch.arange(n, device=nodes.device) * (n + 1)
    segs = torch.cat([(idx_i * n + e).reshape(-1), (e * n + idx_i).reshape(-1),
                      (e * n + e).reshape(-1), diag])
    _add_blocks(M, segs, torch.cat([x.reshape(-1, 36)
                                    for x in (ij, ji, jj, ii + mot)]))
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
    D.count_launch("arap_term_blocks")


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


def _twin_vjp(ctx, twin, n: int, grads, *fixed):
    """The vector-Jacobian product of ``twin`` (an accumulate into a fresh
    (M, b, sq) system of ``n`` nodes) at the saved inputs, for the inputs
    in ``ctx.needs_input_grad``; None for the others."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[: len(saved)]
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(bool(g) and x.is_floating_point())
                  for x, g in zip(saved, need)]
        dev = inputs[0].device
        M = torch.zeros((6 * n, 6 * n), dtype=torch.float32, device=dev)
        b = torch.zeros((6 * n,), dtype=torch.float32, device=dev)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        twin(*inputs, *fixed, M, b, sq)
        wrt = [x for x in inputs if x.requires_grad]
        # an output that none of them reaches (the ARAP M without R) has
        # a zero product and no graph
        outs = [(o, g) for o, g in zip((M, b, sq), grads) if o.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in outs],
                                       wrt, [g for _, g in outs],
                                       allow_unused=True)
                   if wrt and outs else [None] * len(wrt))
    return [next(got) if x.requires_grad else None for x in inputs]


class PointTermAssembly(torch.autograd.Function):
    """The point term as a differentiable function of its inputs:
    ``apply(points, targets, point_valid, anchors, weights, nodes, R, t,
    sw, proj)`` -> (M [6N, 6N], b [6N], sq []).

    Forward: ``point_term_accumulate`` into fresh zero tensors, so kernel
    K3' on CUDA tensors and its twin on CPU tensors. Backward: the
    vector-Jacobian product of the twin ``point_term_accumulate_torch``,
    recomputed under autograd at the saved inputs for the inputs that
    need a gradient (targets, point_valid, R and t on the training path).
    This is the kernel's backward, not a fallback: the forward stays the
    kernel, the twin computes the same function (the JAX
    ``_assemble_blocks(assembly="blocks")`` system, F1), and nothing
    switches on a failure. No backward kernel is written: the JAX
    package has none either (it differentiates its XLA "blocks"
    assembly)."""

    @staticmethod
    def forward(ctx, points, targets, point_valid, anchors, weights, nodes,
                R, t, sw, proj):
        n = nodes.shape[0]
        dev = nodes.device
        M = torch.zeros((6 * n, 6 * n), dtype=torch.float32, device=dev)
        b = torch.zeros((6 * n,), dtype=torch.float32, device=dev)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        point_term_accumulate(points, targets, point_valid, anchors, weights,
                              nodes, R, t, sw, M, b, sq, proj)
        ctx.save_for_backward(points, targets, point_valid, anchors, weights,
                              nodes, R, t)
        ctx.sw, ctx.proj = sw, proj
        return M, b, sq

    @staticmethod
    def backward(ctx, gM, gb, gsq):
        n = ctx.saved_tensors[5].shape[0]

        def twin(*args):
            *inputs, sw, M, b, sq = args
            point_term_accumulate_torch(*inputs, sw, M, b, sq,
                                        proj=ctx.proj)

        grads = _twin_vjp(ctx, twin, n, (gM, gb, gsq), ctx.sw)
        return (*grads, None, None)


class ArapTermAssembly(torch.autograd.Function):
    """The ARAP term with the motion prior as a differentiable function:
    ``apply(nodes, R, t, edges, wa, wm, motion_targets)`` -> (M, b, sq).
    Forward: ``arap_term_accumulate`` into fresh zeros (kernel K4' on CUDA
    tensors, the twin on CPU tensors); backward: the twin's
    vector-Jacobian product at the saved inputs, as
    ``PointTermAssembly``."""

    @staticmethod
    def forward(ctx, nodes, R, t, edges, wa, wm, motion_targets):
        n = nodes.shape[0]
        dev = nodes.device
        M = torch.zeros((6 * n, 6 * n), dtype=torch.float32, device=dev)
        b = torch.zeros((6 * n,), dtype=torch.float32, device=dev)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        arap_term_accumulate(nodes, R, t, edges, wa, wm, motion_targets, M, b,
                             sq)
        ctx.save_for_backward(nodes, R, t, edges, wa, wm, motion_targets)
        return M, b, sq

    @staticmethod
    def backward(ctx, gM, gb, gsq):
        n = ctx.saved_tensors[0].shape[0]
        return tuple(_twin_vjp(ctx, arap_term_accumulate_torch, n,
                               (gM, gb, gsq)))
