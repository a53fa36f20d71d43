"""Dense-normal-equations Gauss-Newton (port of
``occlusionfusion_tpu/solvers/gauss_newton_dense.py``, block assembly and
Cholesky only).

Per iteration: the point-term jacobian blocks (kernel K3 on CUDA, its
twin on the CPU), the ARAP blocks (kernel K4 on CUDA, its twin on the
CPU), and one segment-sum of all pair blocks into the [N*N, 36] block
table; the motion prior adds to the translation diagonal; the damped
system is solved by Cholesky and the rotations retract as R <- exp(dw) R.

Linearization at the current estimate (dw = 0):
  point residual  r_p = sum_k w_k (R_k (x_p - g_k) + g_k + t_k) - y_p
  ARAP edge (i,j) r_e = R_i (g_j - g_i) + g_i + t_i - g_j - t_j
  motion prior    r_n = c_n (g_n + t_n - m_n)
"""

from __future__ import annotations

import math

import torch

from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp
from occlusionfusion_tpu_torch.geometry.so3 import so3_exp
from occlusionfusion_tpu_torch.ops.gn_assembly import (
    arap_term_blocks,
    point_term_blocks,
)
from occlusionfusion_tpu_torch.ops.segment_ops import segment_sum
from occlusionfusion_tpu_torch.solvers.gauss_newton import (
    GNConfig,
    GNProblem,
    GNResult,
    check_config,
)


def pair_segment_ids(point_anchors, edges, n: int):
    """Scatter segment of every block row of ``_assemble_blocks``:
    [point K^2 pairs | arap ij | arap ji | arap jj]."""
    a = point_anchors.long()
    e = torch.clamp(edges, min=0).long()
    E_k = edges.shape[1]
    seg_pt = (a[:, :, None] * n + a[:, None, :]).reshape(-1)
    idx_i = torch.arange(n, device=a.device)[:, None].expand(n, E_k)
    seg_ij = (idx_i * n + e).reshape(-1)
    seg_ji = (e * n + idx_i).reshape(-1)
    seg_jj = (e * n + e).reshape(-1)
    return torch.cat([seg_pt, seg_ij, seg_ji, seg_jj])


def _assemble_blocks(problem: GNProblem, config: GNConfig, R, t):
    """(M [6N, 6N], b [6N], sq) at the current estimate: 6x6 blocks per
    anchor pair and per edge, accumulated into the [N, N] block table."""
    n = problem.nodes.shape[0]
    P, K = problem.point_anchors.shape
    dev = problem.nodes.device
    # kernel K3 on CUDA tensors, its twin on CPU tensors
    blk16, b_pt, rsq = point_term_blocks(
        problem.source_points, problem.target_points, problem.point_valid,
        problem.point_anchors, problem.point_weights, problem.nodes, R, t,
        math.sqrt(float(config.w_point)),
    )
    sq = torch.sum(rsq)
    a = problem.point_anchors.long()

    # ARAP term: kernel K4 on CUDA tensors, its twin on CPU tensors
    e = torch.clamp(problem.edges, min=0)
    wa = torch.sqrt(float(config.w_arap) * torch.where(
        problem.edges >= 0, problem.edge_weights,
        torch.zeros_like(problem.edge_weights),
    ))
    ii, ij, ji, jj, b_arap_i, b_arap_j, rsq_a = arap_term_blocks(
        problem.nodes, R, t, e, wa
    )
    sq = sq + torch.sum(rsq_a)

    # one segment-sum of every pair block into the [N*N, 36] table
    all_blocks = torch.cat([
        blk16.reshape(-1, 36), ij.reshape(-1, 36), ji.reshape(-1, 36),
        jj.reshape(-1, 36),
    ])
    segs = pair_segment_ids(problem.point_anchors, problem.edges, n)
    M_blocks = segment_sum(all_blocks, segs, n * n)
    diag = torch.arange(n, device=dev) * (n + 1)
    M_blocks.index_add_(0, diag, ii.reshape(-1, 36))
    b_nodes = segment_sum(
        torch.cat([b_pt.reshape(-1, 6), b_arap_j.reshape(-1, 6)]),
        torch.cat([a.reshape(-1), e.reshape(-1).long()]), n,
    ) + b_arap_i

    if config.w_motion:
        wm = math.sqrt(float(config.w_motion)) * problem.motion_confidence * (
            problem.node_valid.to(torch.float32)
        )
        r_m = wm[:, None] * (problem.nodes + t - problem.motion_targets)
        mot = torch.zeros((n, 6, 6), dtype=torch.float32, device=dev)
        mot[:, 3:, 3:] = torch.eye(3, device=dev) * (wm**2)[:, None, None]
        M_blocks.index_add_(0, diag, mot.reshape(-1, 36))
        b_nodes[:, 3:] += wm[:, None] * r_m
        sq = sq + torch.sum(r_m * r_m)

    M = M_blocks.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    return M, b_nodes.reshape(-1), sq


def solve_dense(problem: GNProblem, config: GNConfig, init_rotations,
                init_translations) -> GNResult:
    """``config.iters`` damped GN steps solved by Cholesky, from the
    node transforms (init_rotations [N, 3, 3], init_translations [N, 3]).
    A step that is not finite (or whose factorization fails) is dropped
    and clears ``valid``; nothing here waits on the host."""
    check_config(config)
    n = problem.nodes.shape[0]
    dev = problem.nodes.device
    R, t = init_rotations, init_translations
    free = (problem.solve_node_mask & problem.node_valid).to(torch.float32)
    free6 = torch.repeat_interleave(free, 6)
    damp = torch.diag(torch.where(
        free6 > 0, torch.full_like(free6, config.lm_damping),
        torch.ones_like(free6),
    ))
    ok = torch.ones((), dtype=torch.bool, device=dev)
    hist = []
    for _ in range(config.iters):
        M, b, sq = _assemble_blocks(problem, config, R, t)
        M = M * free6[:, None] * free6[None, :] + damp
        rhs = -b * free6
        L, info = torch.linalg.cholesky_ex(M)
        x = torch.cholesky_solve(rhs[:, None], L)[:, 0].reshape(n, 6)
        dw, dt = x[:, :3], x[:, 3:]
        finite = torch.isfinite(x).all() & (info == 0)
        dw = torch.where(finite, dw, torch.zeros_like(dw))
        dt = torch.where(finite, dt, torch.zeros_like(dt))
        R = torch.einsum("nij,njk->nik", so3_exp(dw), R)
        t = t + dt
        ok = ok & finite
        hist.append(sq)
    warped = ed_warp(
        problem.source_points, problem.nodes, R, t, problem.point_anchors,
        problem.point_weights,
    )
    nv = problem.node_valid
    R = torch.where(nv[:, None, None], R,
                    torch.eye(3, dtype=torch.float32, device=dev))
    t = torch.where(nv[:, None], t, torch.zeros_like(t))
    return GNResult(
        rotations=R, translations=t, warped_points=warped,
        residual_history=torch.stack(hist), valid=ok,
    )
