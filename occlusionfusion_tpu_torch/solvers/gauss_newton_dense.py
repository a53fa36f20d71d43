"""Dense-normal-equations Gauss-Newton (port of
``occlusionfusion_tpu/solvers/gauss_newton_dense.py``).

Per iteration: zero the system, add the point term (kernel K3' on CUDA,
its twin on the CPU) and the ARAP term with the motion prior (kernel K4'
on CUDA, its twin on the CPU) straight into M [6N, 6N], b [6N] and sq;
solve the damped system by the configured linear solver; retract the
rotations as R <- exp(dw) R. ``GNConfig.assembly="dense_j"`` instead
forms the row-stacked jacobian J [3P + 3NE (+ 3N), 6N] and M = J^T J,
b = J^T r by f32 matrix products (``_assemble``), on either device: the
JAX package's cross-validation twin, which multiplies mostly zeros.

``build_pair_scatter_plan`` makes the JAX package's keyframe-static
compact-pair plan of the block table's scatter (``PairScatterPlan``).
On CPU tensors ``solve_dense(scatter_plan=)`` sums the twins' blocks
through it as JAX does (the direct scatter where the plan overflowed);
on CUDA tensors K3'/K4' add straight into M, so no block table exists to
compact: the plan's shapes are checked and the system is the one without
it. What does not change between iterations
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
    arap_term_blocks_torch,
    arap_term_jacobian,
    point_term_accumulate,
    point_term_blocks_torch,
    point_term_jacobian,
)
from occlusionfusion_tpu_torch.ops.segment_ops import segment_sum
from occlusionfusion_tpu_torch.solvers.gauss_newton import (
    ASSEMBLIES,
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


def _assemble(problem: GNProblem, config: GNConfig, R, t, terms=None):
    """The ``dense_j`` route: (M [6N, 6N], b [6N], sq) from the dense
    row-stacked jacobian J of the point rows [3P, 6N], the ARAP rows per
    edge [3 N E, 6N] and, where ``w_motion``, the motion prior's rows
    [3N, 6N], each residual's 6-dof blocks scattered into its anchors'
    columns; then M = J^T J and b = J^T r as f32 matrix products (TF32
    off). The same system as the block routes, computed through mostly
    zeros: at N = 512, P = 8192, J is 38,400 x 3,072 and J^T J about
    0.72 TFLOP."""
    terms = terms or _fixed_terms(problem, config)
    n = problem.nodes.shape[0]
    P, K = problem.point_anchors.shape
    dev = problem.nodes.device
    J, r_pt = point_term_jacobian(
        problem.source_points, problem.target_points, problem.point_valid,
        problem.point_anchors, problem.point_weights, problem.nodes, R, t,
        terms.sw, terms.proj)
    J_pt = torch.zeros((P, 3, n, 6), dtype=torch.float32, device=dev)
    rows = torch.arange(P, device=dev)[:, None].expand(P, K)
    J_pt.permute(0, 2, 1, 3).index_put_(
        (rows, problem.point_anchors.long()), J, accumulate=True)
    Ji, Jj, r_ar = arap_term_jacobian(problem.nodes, R, t, terms.edges,
                                      terms.wa)
    E = terms.edges.shape[1]
    J_ar = torch.zeros((n, E, 3, n, 6), dtype=torch.float32, device=dev)
    ni = torch.arange(n, device=dev)[:, None].expand(n, E)
    ei = torch.arange(E, device=dev)[None, :].expand(n, E)
    view = J_ar.permute(0, 1, 3, 2, 4)  # [n, E, n (column node), 3, 6]
    view.index_put_((ni, ei, ni), Ji, accumulate=True)
    view.index_put_((ni, ei, terms.edges.long()), Jj, accumulate=True)
    parts = [J_pt.reshape(3 * P, 6 * n), J_ar.reshape(3 * n * E, 6 * n)]
    res = [r_pt.reshape(-1), r_ar.reshape(-1)]
    if config.w_motion:
        J_m = torch.zeros((n, 3, n, 6), dtype=torch.float32, device=dev)
        idx = torch.arange(n, device=dev)
        J_m[idx, :, idx, 3:] = torch.eye(3, device=dev) * terms.wm[:, None,
                                                                   None]
        parts.append(J_m.reshape(3 * n, 6 * n))
        res.append((terms.wm[:, None] * (problem.nodes + t
                                         - problem.motion_targets))
                   .reshape(-1))
    J_all = torch.cat(parts)
    r_all = torch.cat(res)
    return J_all.T @ J_all, J_all.T @ r_all, torch.sum(r_all * r_all)


class PairScatterPlan(NamedTuple):
    """Keyframe-static plan of the block table's scatter (the JAX
    package's): every row of ``_assemble_blocks``' pair blocks, in
    ``pair_segment_ids`` order, mapped to a compact slot of the occupied
    (node, node) pairs. ``overflow`` flags more distinct pairs than
    slots; the assembly then takes the direct scatter."""

    compact_ids: torch.Tensor  # [R] int32: row -> compact slot
    slot_segs: torch.Tensor  # [U] int32: slot -> pair a * N + c (N * N free)
    overflow: torch.Tensor  # 0-d bool


def pair_segment_ids(point_anchors, edges, n: int) -> torch.Tensor:
    """Every pair block's segment a * n + c, in row order: the points' K^2
    anchor pairs, then the ARAP (i, j), (j, i) and (j, j) blocks."""
    a = point_anchors.to(torch.int32)
    e = torch.clamp(edges, min=0).to(torch.int32)
    E = edges.shape[1]
    idx_i = torch.arange(n, dtype=torch.int32,
                         device=e.device)[:, None].expand(n, E)
    return torch.cat([
        (a[:, :, None] * n + a[:, None, :]).reshape(-1),
        (idx_i * n + e).reshape(-1),
        (e * n + idx_i).reshape(-1),
        (e * n + e).reshape(-1),
    ])


def build_pair_scatter_plan(point_anchors, edges, n: int,
                            u_cap: int = 0) -> PairScatterPlan:
    """The compact-pair plan (once per keyframe). ``u_cap`` 0 means
    min(n^2, 64 n) slots. Where more pairs are occupied than slots, the
    extra pairs share the last slot and ``overflow`` is set, as in JAX
    (whose scatter keeps the largest such pair there)."""
    if u_cap <= 0:
        u_cap = min(n * n, 64 * n)
    segs = pair_segment_ids(point_anchors, edges, n)
    order = torch.argsort(segs, stable=True)
    s_sorted = segs[order]
    newseg = torch.ones_like(s_sorted)
    newseg[1:] = (s_sorted[1:] != s_sorted[:-1]).to(torch.int32)
    rank = torch.cumsum(newseg, 0, dtype=torch.int32) - 1
    overflow = rank[-1] + 1 > u_cap
    rank_c = torch.clamp(rank, max=u_cap - 1)
    compact_ids = torch.zeros_like(segs)
    compact_ids[order] = rank_c
    slot_segs = torch.full((u_cap,), n * n, dtype=torch.int32,
                           device=segs.device)
    slot_segs = slot_segs.scatter_reduce(0, rank_c.long(), s_sorted,
                                         reduce="amax", include_self=False)
    return PairScatterPlan(compact_ids=compact_ids, slot_segs=slot_segs,
                           overflow=overflow)


def _check_plan(plan: PairScatterPlan, problem: GNProblem) -> None:
    n = problem.nodes.shape[0]
    P, K = problem.point_anchors.shape
    rows = P * K * K + 3 * n * problem.edges.shape[1]
    if (tuple(plan.compact_ids.shape) != (rows,)
            or plan.slot_segs.dim() != 1 or plan.overflow.dim() != 0):
        raise ValueError(
            f"scatter plan of {tuple(plan.compact_ids.shape)} rows, "
            f"{tuple(plan.slot_segs.shape)} slots for a problem of {rows} "
            f"pair rows")


def _accumulate_planned(problem: GNProblem, terms: _FixedTerms, R, t,
                        plan: PairScatterPlan, M, b, sq):
    """The twins' blocks summed into (M, b, sq) through the plan, as the
    JAX package's ``_assemble_blocks(plan=)``: one segment sum of every
    pair block into the compact slots, expanded into the [N N] block
    table (the direct segment sum where the plan overflowed), the ARAP
    (i, i) blocks and the motion prior on the diagonal."""
    n = problem.nodes.shape[0]
    blk, b_pt, rsq = point_term_blocks_torch(
        problem.source_points, problem.target_points, problem.point_valid,
        problem.point_anchors, problem.point_weights, problem.nodes, R, t,
        terms.sw, terms.proj)
    ii, ij, ji, jj, b_i, b_j, rsq_a = arap_term_blocks_torch(
        problem.nodes, R, t, terms.edges, terms.wa)
    rows = torch.cat([x.reshape(-1, 36) for x in (blk, ij, ji, jj)])
    if bool(plan.overflow):
        table = segment_sum(rows, pair_segment_ids(
            problem.point_anchors, problem.edges, n).long(), n * n)
    else:
        u_cap = plan.slot_segs.shape[0]
        c = segment_sum(rows, plan.compact_ids.long(), u_cap)
        table = torch.zeros((n * n + 1, 36), dtype=rows.dtype,
                            device=rows.device)
        table[plan.slot_segs.long()] = c  # slot n * n: unused, dropped
        table = table[:n * n]
    r_m = terms.wm[:, None] * (problem.nodes + t - problem.motion_targets)
    mot = torch.zeros((n, 6, 6), dtype=rows.dtype, device=rows.device)
    mot[:, 3:, 3:] = torch.eye(3, device=rows.device) * (
        terms.wm**2)[:, None, None]
    diag = torch.arange(n, device=rows.device) * (n + 1)
    table[diag] += (ii + mot).reshape(-1, 36)
    a = problem.point_anchors.long()
    b_nodes = segment_sum(
        torch.cat([b_pt.reshape(-1, 6), b_j.reshape(-1, 6)]),
        torch.cat([a.reshape(-1), terms.edges.long().reshape(-1)]), n) + b_i
    b_nodes[:, 3:] += terms.wm[:, None] * r_m
    M += table.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    b += b_nodes.reshape(-1)
    sq += torch.sum(rsq) + torch.sum(rsq_a) + torch.sum(r_m * r_m)


def _add_terms(problem: GNProblem, config: GNConfig, terms: _FixedTerms, R,
               t, M, b, sq, plan: PairScatterPlan | None = None):
    """Add the system at (R, t) into (M, b, sq) by ``config.assembly``'s
    route: ``dense_j``; the blocks through ``plan`` (CPU tensors); or
    K3' + K4' (their twins on CPU tensors)."""
    if config.assembly == "dense_j":
        Mj, bj, sqj = _assemble(problem, config, R, t, terms)
        M += Mj
        b += bj
        sq += sqj
    elif plan is not None and not problem.nodes.is_cuda:
        _accumulate_planned(problem, terms, R, t, plan, M, b, sq)
    else:
        _accumulate(problem, terms, R, t, M, b, sq)


def check_assembly(config: GNConfig) -> None:
    if config.assembly not in ASSEMBLIES:
        raise ValueError(f"assembly must be one of {ASSEMBLIES}, got "
                         f"{config.assembly!r}")


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


def _active_rows(problem: GNProblem) -> int:
    """The rows the Cholesky factorizes: all on the card (no host read in
    a captured step); on the CPU, where the factorization of the padded
    system costs most of a test's solve, up to the last valid node's."""
    n = problem.nodes.shape[0]
    if problem.nodes.device.type != "cuda" and bool(problem.node_valid.any()):
        return 6 * (int(torch.nonzero(problem.node_valid)[-1, 0]) + 1)
    return 6 * n


def _cholesky_solve(A, rhs, active: int, differentiable: bool = False):
    """(x, finite): A x = rhs by Cholesky over the first ``active`` rows;
    the rows from ``active`` on are padded nodes' identity rows with a
    zero right-hand side, whose solution is 0. ``finite`` is False where
    the factorization failed."""
    L, info = torch.linalg.cholesky_ex(A[:active, :active])
    sol = torch.cholesky_solve(rhs[:active, None], L)[:, 0]
    if differentiable:
        x = torch.nn.functional.pad(sol, (0, rhs.shape[0] - active))
    else:
        x = torch.zeros_like(rhs)
        x[:active] = sol
    return x, info == 0


def _retract(R, t, x, finite, step_length: float):
    """(R, t, finite) after the step x [6N] times ``step_length``:
    R <- exp(dw) R, t <- t + dt; a step that is not finite (or whose
    ``finite`` is already False) is dropped."""
    x = x.reshape(-1, 6) * step_length
    finite = finite & torch.isfinite(x).all()
    x = torch.where(finite, x, torch.zeros_like(x))
    R = torch.einsum("nij,njk->nik", so3_exp(x[:, :3]), R)
    return R, t + x[:, 3:], finite


def _linear_solve(A, rhs, free6, active: int, config: GNConfig,
                  differentiable: bool = False):
    """(x, finite): the damped, masked system A x = rhs by
    ``config.linear_solver``; ``finite`` is False where a Cholesky
    factorization failed."""
    if config.linear_solver == "cholesky":
        return _cholesky_solve(A, rhs, active, differentiable)
    if config.linear_solver == "cg":
        x = _pcg(A, rhs, free6, config.dense_cg_iters)
    elif config.linear_solver == "schur":
        x = spd_schur_solve(A, rhs, leaf=config.schur_leaf)
    else:
        x = newton_schulz_solve(A, rhs, block=config.ns_block,
                                iters=config.ns_iters)
    return x, torch.ones((), dtype=torch.bool, device=A.device)


def solve_dense(problem: GNProblem, config: GNConfig, init_rotations,
                init_translations,
                scatter_plan: PairScatterPlan | None = None) -> GNResult:
    """``config.iters`` damped GN steps solved by ``config.linear_solver``
    from the node transforms (init_rotations [N, 3, 3], init_translations
    [N, 3]); each step is the solution times ``step_length``; the system
    assembled by ``config.assembly``'s route (``_add_terms``; the
    ``scatter_plan`` orders the CPU twins' sum). A step that is not
    finite (or whose Cholesky factorization fails) is dropped and clears
    ``valid``; nothing here waits on the host."""
    if config.linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"linear_solver must be one of {LINEAR_SOLVERS}, "
                         f"got {config.linear_solver!r}")
    check_assembly(config)
    if scatter_plan is not None:
        _check_plan(scatter_plan, problem)
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
    active = _active_rows(problem)
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
            M, b, sq = (_assemble(problem, config, R, t, terms)
                        if config.assembly == "dense_j" else
                        _assemble_differentiable(problem, terms, R, t))
            sqs.append(sq)
        else:
            Mb.zero_()
            _add_terms(problem, config, terms, R, t, M, b, hist[it],
                       scatter_plan)
        A = torch.addcmul(damp, M, free66)
        x, finite = _linear_solve(A, -b * free6, free6, active, config,
                                  differentiable)
        R, t, finite = _retract(R, t, x, finite, config.step_length)
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
