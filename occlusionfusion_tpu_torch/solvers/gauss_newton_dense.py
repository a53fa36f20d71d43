"""Dense-normal-equations Gauss-Newton (port of
``occlusionfusion_tpu/solvers/gauss_newton_dense.py``, block assembly and
Cholesky only).

Per iteration: zero the system, add the point term (kernel K3' on CUDA,
its twin on the CPU) and the ARAP term with the motion prior (kernel K4'
on CUDA, its twin on the CPU) straight into M [6N, 6N], b [6N] and sq;
solve the damped system by Cholesky; retract the rotations as
R <- exp(dw) R. What does not change between iterations (the clamped
edges and their weights, the prior's weights, the free-node mask and the
damping) is computed once per solve.

Linearization at the current estimate (dw = 0):
  point residual  r_p = sum_k w_k (R_k (x_p - g_k) + g_k + t_k) - y_p
  ARAP edge (i,j) r_e = R_i (g_j - g_i) + g_i + t_i - g_j - t_j
  motion prior    r_n = c_n (g_n + t_n - m_n)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp
from occlusionfusion_tpu_torch.geometry.so3 import so3_exp
from occlusionfusion_tpu_torch.ops.gn_assembly import (
    arap_term_accumulate,
    point_term_accumulate,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import (
    GNConfig,
    GNProblem,
    GNResult,
    check_config,
)


class _FixedTerms(NamedTuple):
    """The assembly's inputs that stay fixed over a solve."""

    sw: float  # sqrt(w_point)
    edges: torch.Tensor  # [N, E] int32, clamped >= 0
    wa: torch.Tensor  # [N, E] sqrt(w_arap * edge weight), 0 on invalid
    wm: torch.Tensor  # [N] sqrt(w_motion) * confidence on valid nodes


def _fixed_terms(problem: GNProblem, config: GNConfig) -> _FixedTerms:
    edges = problem.edges
    wa = torch.sqrt(float(config.w_arap) * torch.where(
        edges >= 0, problem.edge_weights,
        torch.zeros_like(problem.edge_weights),
    ))
    wm = math.sqrt(float(config.w_motion)) * problem.motion_confidence * (
        problem.node_valid.to(torch.float32)
    )
    return _FixedTerms(math.sqrt(float(config.w_point)),
                       torch.clamp(edges, min=0).to(torch.int32), wa, wm)


def _accumulate(problem: GNProblem, terms: _FixedTerms, R, t, M, b, sq):
    """Add every term at (R, t) into (M, b, sq)."""
    point_term_accumulate(
        problem.source_points, problem.target_points, problem.point_valid,
        problem.point_anchors, problem.point_weights, problem.nodes, R, t,
        terms.sw, M, b, sq,
    )
    arap_term_accumulate(problem.nodes, R, t, terms.edges, terms.wa,
                         terms.wm, problem.motion_targets, M, b, sq)


def _assemble_blocks(problem: GNProblem, config: GNConfig, R, t):
    """(M [6N, 6N], b [6N], sq) at the current estimate, in the JAX
    package's layout."""
    n = problem.nodes.shape[0]
    dev = problem.nodes.device
    M = torch.zeros((6 * n, 6 * n), dtype=torch.float32, device=dev)
    b = torch.zeros((6 * n,), dtype=torch.float32, device=dev)
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    _accumulate(problem, _fixed_terms(problem, config), R, t, M, b, sq)
    return M, b, sq


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
    free66 = free6[:, None] * free6[None, :]
    damp = torch.diag(torch.where(
        free6 > 0, torch.full_like(free6, config.lm_damping),
        torch.ones_like(free6),
    ))
    terms = _fixed_terms(problem, config)
    # M and b share one buffer, zeroed by one fill per iteration; each
    # iteration adds its sq into its own slot of the history
    Mb = torch.empty((36 * n * n + 6 * n,), dtype=torch.float32, device=dev)
    M, b = Mb[: 36 * n * n].view(6 * n, 6 * n), Mb[36 * n * n:]
    hist = torch.zeros((config.iters,), dtype=torch.float32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for it in range(config.iters):
        Mb.zero_()
        _accumulate(problem, terms, R, t, M, b, hist[it])
        A = torch.addcmul(damp, M, free66)
        rhs = -b * free6
        L, info = torch.linalg.cholesky_ex(A)
        x = torch.cholesky_solve(rhs[:, None], L)[:, 0].reshape(n, 6)
        dw, dt = x[:, :3], x[:, 3:]
        finite = torch.isfinite(x).all() & (info == 0)
        dw = torch.where(finite, dw, torch.zeros_like(dw))
        dt = torch.where(finite, dt, torch.zeros_like(dt))
        R = torch.einsum("nij,njk->nik", so3_exp(dw), R)
        t = t + dt
        ok = ok & finite
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
        residual_history=hist, valid=ok,
    )
