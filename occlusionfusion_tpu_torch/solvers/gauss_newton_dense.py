"""Dense-normal-equations Gauss-Newton (port of
``occlusionfusion_tpu/solvers/gauss_newton_dense.py``, block assembly).

Per iteration: zero the system, add the point term (kernel K3' on CUDA,
its twin on the CPU) and the ARAP term with the motion prior (kernel K4'
on CUDA, its twin on the CPU) straight into M [6N, 6N], b [6N] and sq;
solve the damped system by the configured linear solver; retract the
rotations as R <- exp(dw) R. What does not change between iterations
(the clamped edges and their weights, the prior's weights, the free-node
mask, the damping and the 2d_depth projection) is computed once per
solve. M is assembled in f32 whatever ``normal_matrix_precision`` says,
as the JAX package computes it on the CPU.

Linearization at the current estimate (dw = 0):
  point residual  r_p = sum_k w_k (R_k (x_p - g_k) + g_k + t_k) - y_p
    (2d_depth: the projected rows, their jacobian blocks G_p J_k with
    G_p the row scaling at the warped point)
  ARAP edge (i,j) r_e = R_i (g_j - g_i) + g_i + t_i - g_j - t_j
  motion prior    r_n = c_n (g_n + t_n - m_n)

Linear solvers (``GNConfig.linear_solver``): "cholesky"; "cg", block-
Jacobi PCG on the assembled M (one [6N, 6N] matvec an iteration);
"schur" and "ns", the explicit inverses of ``ops/blocksolve.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp
from occlusionfusion_tpu_torch.geometry.so3 import hat, so3_exp
from occlusionfusion_tpu_torch.ops.blocksolve import (
    newton_schulz_solve,
    spd_schur_solve,
)
from occlusionfusion_tpu_torch.ops.gn_assembly import (
    ArapTermAssembly,
    PointTermAssembly,
    arap_term_accumulate,
    point_term_accumulate,
)
from occlusionfusion_tpu_torch.ops.segment_ops import segment_sum
from occlusionfusion_tpu_torch.solvers.gauss_newton import (
    LINEAR_SOLVERS,
    GNConfig,
    GNProblem,
    GNResult,
    _f32_sqrt,
    projection,
    row_scaling,
)


class _FixedTerms(NamedTuple):
    """The assembly's inputs that stay fixed over a solve."""

    sw: float  # sqrt(w_point)
    edges: torch.Tensor  # [N, E] int32, clamped >= 0
    wa: torch.Tensor  # [N, E] sqrt(w_arap * edge weight), 0 on invalid
    wm: torch.Tensor  # [N] sqrt(w_motion) * confidence on valid nodes
    proj: tuple | None  # (fx, fy, sf, sd) for 2d_depth, else None


def _fixed_terms(problem: GNProblem, config: GNConfig) -> _FixedTerms:
    edges = problem.edges
    wa = torch.sqrt(float(config.w_arap) * torch.where(
        edges >= 0, problem.edge_weights,
        torch.zeros_like(problem.edge_weights),
    ))
    wm = _f32_sqrt(config.w_motion) * problem.motion_confidence * (
        problem.node_valid.to(torch.float32)
    )
    return _FixedTerms(_f32_sqrt(config.w_point),
                       torch.clamp(edges, min=0).to(torch.int32), wa, wm,
                       projection(problem, config))


def _accumulate(problem: GNProblem, terms: _FixedTerms, R, t, M, b, sq):
    """Add every term at (R, t) into (M, b, sq)."""
    point_term_accumulate(
        problem.source_points, problem.target_points, problem.point_valid,
        problem.point_anchors, problem.point_weights, problem.nodes, R, t,
        terms.sw, M, b, sq, terms.proj,
    )
    arap_term_accumulate(problem.nodes, R, t, terms.edges, terms.wa,
                         terms.wm, problem.motion_targets, M, b, sq)


def _assemble_differentiable(problem: GNProblem, terms: _FixedTerms, R, t):
    """(M, b, sq) at (R, t) as fresh tensors through the autograd
    Functions of ``ops/gn_assembly.py``: K3' and K4' forward on CUDA
    tensors, gradients by the twins' vector-Jacobian products."""
    Mp, bp, sqp = PointTermAssembly.apply(
        problem.source_points, problem.target_points, problem.point_valid,
        problem.point_anchors, problem.point_weights, problem.nodes, R, t,
        terms.sw, terms.proj,
    )
    Ma, ba, sqa = ArapTermAssembly.apply(
        problem.nodes, R, t, terms.edges, terms.wa, terms.wm,
        problem.motion_targets,
    )
    return Mp + Ma, bp + ba, sqp + sqa


def _needs_grad(problem: GNProblem, *tensors) -> bool:
    """Whether autograd records the solve: gradients are on and some input
    of the problem or the initial transforms requires grad."""
    if not torch.is_grad_enabled():
        return False
    return any(isinstance(x, torch.Tensor) and x.requires_grad
               for x in (*problem, *tensors))


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


def diag_blocks(problem: GNProblem, config: GNConfig, R, t):
    """Per-node 6x6 diagonal blocks [N, 6, 6] of J^T J without the N^2
    table: the point term's J_k^T J_k at each anchor, the ARAP (i, i) and
    (j, j) blocks and the motion prior's translation diagonal (the
    block-Jacobi preconditioner of the matrix-free solver)."""
    n = problem.nodes.shape[0]
    P, K = problem.point_anchors.shape
    a = problem.point_anchors.long()
    g = problem.nodes[a]
    local = torch.einsum("pkij,pkj->pki", R[a],
                         problem.source_points[:, None] - g)
    w = problem.point_weights * problem.point_valid[:, None]
    eye = torch.eye(3, dtype=torch.float32, device=g.device)
    J = _f32_sqrt(config.w_point) * torch.cat(
        [-hat(local) * w[..., None, None],
         eye.expand(P, K, 3, 3) * w[..., None, None]], dim=-1)
    proj = projection(problem, config)
    if proj is not None:
        warped = torch.sum(problem.point_weights[..., None]
                           * (local + g + t[a]), dim=1)
        J = torch.einsum("pab,pkbc->pkac", row_scaling(warped, proj), J)
    blocks = torch.einsum("pkai,pkaj->pkij", J, J)
    D = segment_sum(blocks.reshape(-1, 36), a.reshape(-1), n).reshape(n, 6, 6)

    E = problem.edges.shape[1]
    e = torch.clamp(problem.edges, min=0).long()
    rot = torch.einsum("nij,nkj->nki", R,
                       problem.nodes[e] - problem.nodes[:, None])
    wa = torch.sqrt(float(config.w_arap) * torch.where(
        problem.edges >= 0, problem.edge_weights,
        torch.zeros_like(problem.edge_weights)))
    Ji = torch.cat([-hat(rot), eye.expand(n, E, 3, 3)],
                   dim=-1) * wa[..., None, None]
    D = D + torch.sum(torch.einsum("neai,neaj->neij", Ji, Ji), dim=1)
    jj = (wa**2)[..., None, None] * eye.expand(n, E, 3, 3)
    D[:, 3:, 3:] += segment_sum(jj.reshape(-1, 9), e.reshape(-1),
                                n).reshape(n, 3, 3)
    if config.w_motion:
        wm2 = (float(config.w_motion) * problem.motion_confidence**2
               * problem.node_valid.to(torch.float32))
        D[:, 3:, 3:] += eye * wm2[:, None, None]
    return D


def _pcg(A, rhs, free6, iters: int):
    """Block-Jacobi PCG on the damped, masked dense system A (frozen
    rows are the identity), ``iters`` iterations from zero."""
    n = A.shape[0] // 6
    diag = A.reshape(n, 6, n, 6).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    inv_diag = torch.linalg.inv_ex(diag).inverse

    def prec(v):
        return torch.einsum("nij,nj->ni", inv_diag,
                            v.reshape(n, 6)).reshape(-1) * free6

    x = torch.zeros_like(rhs)
    r, p = rhs, prec(rhs)
    rz = torch.dot(r, p)
    for _ in range(iters):
        Ap = (A @ p) * free6
        alpha = rz / torch.clamp(torch.dot(p, Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.dot(r, z)
        p = z + rz_new / torch.clamp(rz, min=1e-20) * p
        rz = rz_new
    return x


def solve_dense(problem: GNProblem, config: GNConfig, init_rotations,
                init_translations) -> GNResult:
    """``config.iters`` damped GN steps solved by ``config.linear_solver``
    from the node transforms (init_rotations [N, 3, 3], init_translations
    [N, 3]); each step is the solution times ``step_length``. A step that
    is not finite (or whose Cholesky factorization fails) is dropped and
    clears ``valid``; nothing here waits on the host."""
    if config.linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"linear_solver must be one of {LINEAR_SOLVERS}, "
                         f"got {config.linear_solver!r}")
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
    # the rows the Cholesky factorizes: all on the card (no host read in a
    # captured step); on the CPU, where the factorization of the padded
    # system costs most of a test's solve, up to the last valid node's
    active = 6 * n
    if dev.type != "cuda" and bool(problem.node_valid.any()):
        active = 6 * (int(torch.nonzero(problem.node_valid)[-1, 0]) + 1)
    # without gradients M and b share one buffer, zeroed by one fill per
    # iteration, and each iteration adds its sq into its own slot of the
    # history; with them (the through-solver trainer) each iteration's
    # system comes fresh from the autograd Functions and nothing that
    # autograd saved is written in place
    differentiable = _needs_grad(problem, init_rotations, init_translations)
    if not differentiable:
        Mb = torch.empty((36 * n * n + 6 * n,), dtype=torch.float32,
                         device=dev)
        M, b = Mb[: 36 * n * n].view(6 * n, 6 * n), Mb[36 * n * n:]
        hist = torch.zeros((config.iters,), dtype=torch.float32, device=dev)
    sqs = []
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for it in range(config.iters):
        if differentiable:
            M, b, sq = _assemble_differentiable(problem, terms, R, t)
            sqs.append(sq)
        else:
            Mb.zero_()
            _accumulate(problem, terms, R, t, M, b, hist[it])
        A = torch.addcmul(damp, M, free66)
        rhs = -b * free6
        finite = torch.ones((), dtype=torch.bool, device=dev)
        if config.linear_solver == "cholesky":
            # rows from 6 * active on are padded nodes' identity rows with
            # a zero right-hand side: their solution is 0
            L, info = torch.linalg.cholesky_ex(A[:active, :active])
            sol = torch.cholesky_solve(rhs[:active, None], L)[:, 0]
            if differentiable:
                x = torch.nn.functional.pad(sol, (0, 6 * n - active))
            else:
                x = torch.zeros_like(rhs)
                x[:active] = sol
            finite = info == 0
        elif config.linear_solver == "cg":
            x = _pcg(A, rhs, free6, config.dense_cg_iters)
        elif config.linear_solver == "schur":
            x = spd_schur_solve(A, rhs, leaf=config.schur_leaf)
        else:
            x = newton_schulz_solve(A, rhs, block=config.ns_block,
                                    iters=config.ns_iters)
        x = x.reshape(n, 6) * config.step_length
        finite = finite & torch.isfinite(x).all()
        x = torch.where(finite, x, torch.zeros_like(x))
        R = torch.einsum("nij,njk->nik", so3_exp(x[:, :3]), R)
        t = t + x[:, 3:]
        ok = ok & finite
    warped = ed_warp(
        problem.source_points, problem.nodes, R, t, problem.point_anchors,
        problem.point_weights,
    )
    if differentiable:
        hist = torch.stack(sqs) if sqs else torch.zeros(
            (0,), dtype=torch.float32, device=dev)
    nv = problem.node_valid
    R = torch.where(nv[:, None, None], R,
                    torch.eye(3, dtype=torch.float32, device=dev))
    t = torch.where(nv[:, None], t, torch.zeros_like(t))
    return GNResult(
        rotations=R, translations=t, warped_points=warped,
        residual_history=hist, valid=ok,
    )
