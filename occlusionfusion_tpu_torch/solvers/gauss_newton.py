"""Gauss-Newton problem types, the data terms and the matrix-free GN-CG
solver (port of ``occlusionfusion_tpu/solvers/gauss_newton.py``).

Two data terms, as in the JAX package: ``"point3d"``, the isotropic
point-to-point residual, and ``"2d_depth"``, the reference's anisotropic
stack of two image-plane rows weighted ``w_flow`` and a camera-depth row
weighted ``w_depth``; both sides of the 2d_depth rows are projected
through ``GNProblem.intrinsics``. The dense solver
(``gauss_newton_dense.solve_dense``) assembles the normal equations by
blocks, kernels K3' and K4' on CUDA tensors, their twins on CPU tensors,
and solves them by Cholesky, block-Jacobi PCG, a recursive Schur inverse
or Newton-Schulz. ``solve`` never forms them: conjugate gradients over
the free nodes' (dw, t) on the residuals' jacobian, optionally
preconditioned by the inverse 6x6 diagonal blocks of J^T J. Graph growth
runs it to ARAP-initialise new nodes with the old ones frozen.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp
from occlusionfusion_tpu_torch.geometry.so3 import so3_exp

LINEAR_SOLVERS = ("cholesky", "cg", "schur", "ns")
DATA_TERMS = ("point3d", "2d_depth")
ASSEMBLIES = ("auto", "blocks", "blocks_pallas", "blocks_pallas_full",
              "dense_j")


class GNConfig(NamedTuple):
    iters: int = 10
    cg_iters: int = 32  # the matrix-free solver's CG iterations a step
    lm_damping: float = 1e-4
    w_point: float = 1.0
    w_arap: float = 2.0
    w_motion: float = 0.0
    step_length: float = 1.0
    # block-Jacobi preconditioning of the matrix-free CG (6x6 diagonal
    # blocks of J^T J)
    precondition: bool = False
    # the dense solver's linear solver: "cholesky", "cg" (block-Jacobi
    # PCG on the assembled M, dense_cg_iters), "schur" (recursive Schur
    # inverse, leaves of schur_leaf) or "ns" (Newton-Schulz from the
    # inverse diagonal blocks of ns_block, ns_iters)
    linear_solver: str = "cholesky"
    dense_cg_iters: int = 24
    schur_leaf: int = 96
    ns_iters: int = 12
    ns_block: int = 96
    # "point3d" or "2d_depth" (GNProblem.intrinsics required); the
    # 2d_depth rows' weights (lambda^2, times w_point like the rest)
    data_term: str = "point3d"
    w_flow: float = 1e-3
    w_depth: float = 1.0
    # accepted for the JAX package's configs: it chose the XLA precision
    # of the J^T J contraction; the port assembles M in f32 whatever it
    # says, as the JAX package does on the CPU
    normal_matrix_precision: str = "highest"
    # the dense solver's assembly of the normal equations, one of
    # ASSEMBLIES. "dense_j" forms the row-stacked jacobian J and
    # M = J^T J, b = J^T r by f32 matrix products (the JAX package's
    # cross-validation twin, on either device). Every other value
    # assembles by 6x6 blocks: K3' + K4' on CUDA tensors, their twins on
    # CPU tensors, the system of the JAX "blocks" and
    # "blocks_pallas_full" routes ("blocks_pallas" too but for its
    # point-weight gating, ROADMAP F1, which the port does not copy)
    assembly: str = "auto"


class GNProblem(NamedTuple):
    """Static-shape problem data (padded + masked)."""

    source_points: torch.Tensor  # [P, 3]
    point_anchors: torch.Tensor  # [P, K]
    point_weights: torch.Tensor  # [P, K]
    target_points: torch.Tensor  # [P, 3]
    point_valid: torch.Tensor  # [P] f32 correspondence weights in [0, 1]
    nodes: torch.Tensor  # [N, 3]
    node_valid: torch.Tensor  # [N]
    edges: torch.Tensor  # [N, K_e] -1 padded
    edge_weights: torch.Tensor  # [N, K_e]
    motion_targets: torch.Tensor  # [N, 3]
    motion_confidence: torch.Tensor  # [N]
    solve_node_mask: torch.Tensor  # [N] True = free
    # fx, fy, cx, cy: four Python floats (what a captured step takes) or
    # a [4] tensor; required by data_term="2d_depth"
    intrinsics: tuple | torch.Tensor | None = None


class GNResult(NamedTuple):
    rotations: torch.Tensor
    translations: torch.Tensor
    warped_points: torch.Tensor
    residual_history: torch.Tensor  # [iters] total squared residual
    valid: torch.Tensor  # 0-d bool: every iteration finite


def _f32_sqrt(w: float) -> float:
    """sqrt of a weight rounded as the JAX package forms it (in f32)."""
    return float(np.sqrt(np.float32(w)))


def projection(problem: GNProblem, config: GNConfig):
    """(fx, fy, sf, sd) as floats for the 2d_depth data term, with
    sf = sqrt(w_flow) and sd = sqrt(w_depth); None for point3d. A tensor
    ``intrinsics`` is read back to the host here, so a captured step
    passes floats."""
    if config.data_term not in DATA_TERMS:
        raise ValueError(f"data_term must be one of {DATA_TERMS}, got "
                         f"{config.data_term!r}")
    if config.data_term == "point3d":
        return None
    if problem.intrinsics is None:
        raise ValueError("data_term='2d_depth' needs GNProblem.intrinsics")
    intr = problem.intrinsics
    if isinstance(intr, torch.Tensor):
        intr = intr.tolist()
    return (float(np.float32(intr[0])), float(np.float32(intr[1])),
            _f32_sqrt(config.w_flow), _f32_sqrt(config.w_depth))


def _project_uvz(points, fx: float, fy: float):
    """(u, v, z) image coordinates of camera-space points, without the
    principal point (it cancels in every residual difference); the 1e-7
    guards padded zero points."""
    zinv = 1.0 / (points[..., 2] + 1e-7)
    return fx * points[..., 0] * zinv, fy * points[..., 1] * zinv, \
        points[..., 2]


def data_rows(warped, targets, proj):
    """Unweighted data rows [P, 3]: warped - targets (point3d, ``proj``
    None) or (sf (u - tu), sf (v - tv), sd (z - tz)) with ``proj`` =
    (fx, fy, sf, sd)."""
    if proj is None:
        return warped - targets
    fx, fy, sf, sd = proj
    u, v, z = _project_uvz(warped, fx, fy)
    tu, tv, tz = _project_uvz(targets, fx, fy)
    return torch.stack([sf * (u - tu), sf * (v - tv), sd * (z - tz)], -1)


def row_scaling(warped, proj):
    """[P, 3, 3] left factor G = d(sf u, sf v, sd z)/d(xyz) at the warped
    points, turning 3D-point jacobian rows into the 2d_depth rows; None
    for point3d."""
    if proj is None:
        return None
    fx, fy, sf, sd = proj
    zinv = 1.0 / (warped[:, 2] + 1e-7)
    G = torch.zeros((warped.shape[0], 3, 3), dtype=warped.dtype,
                    device=warped.device)
    G[:, 0, 0] = sf * fx * zinv
    G[:, 0, 2] = -sf * fx * warped[:, 0] * zinv * zinv
    G[:, 1, 1] = sf * fy * zinv
    G[:, 1, 2] = -sf * fy * warped[:, 1] * zinv * zinv
    G[:, 2, 2] = sd
    return G


def data_residual_rows(warped, problem: GNProblem, config: GNConfig):
    """Weighted data residual [P, 3] at the warped points:
    sqrt(w_point) * pv * rows; the point weight pv enters once."""
    sw = _f32_sqrt(config.w_point)
    rows = data_rows(warped, problem.target_points,
                     projection(problem, config))
    return sw * problem.point_valid[:, None] * rows


def projection_row_scaling(warped, problem: GNProblem, config: GNConfig):
    """``row_scaling`` for this problem's data term (None for point3d)."""
    return row_scaling(warped, projection(problem, config))


def _residuals(dw, t, problem: GNProblem, config: GNConfig, base_R):
    """The stacked weighted residuals, one flat vector (point rows, ARAP
    edges, the motion prior where w_motion), at rotations
    exp(dw) base_R and translations t."""
    R = torch.einsum("nij,njk->nik", so3_exp(dw), base_R)
    warped = ed_warp(problem.source_points, problem.nodes, R, t,
                     problem.point_anchors, problem.point_weights)
    point = data_residual_rows(warped, problem, config)
    e = torch.clamp(problem.edges, min=0).long()
    g_i = problem.nodes[:, None]
    g_j = problem.nodes[e]
    rotated = torch.einsum("nij,nkj->nki", R, g_j - g_i)
    arap = rotated + g_i + t[:, None] - g_j - t[e]
    wa = torch.sqrt(float(config.w_arap) * torch.where(
        problem.edges >= 0, problem.edge_weights,
        torch.zeros_like(problem.edge_weights)))
    parts = [point.reshape(-1), (wa[..., None] * arap).reshape(-1)]
    if config.w_motion:
        wm = float(config.w_motion) ** 0.5 * problem.motion_confidence
        parts.append((wm[:, None] * (problem.nodes + t
                                     - problem.motion_targets)
                      * problem.node_valid[:, None]).reshape(-1))
    return torch.cat(parts)


@torch.no_grad()
def solve(problem: GNProblem, config: GNConfig = GNConfig(),
          init_rotations=None, init_translations=None) -> GNResult:
    """``config.iters`` LM-damped GN steps, each solving
    (J^T J + lm I) x = -J^T r over the free nodes' (dw, t) by
    ``config.cg_iters`` CG iterations, preconditioned by the inverse
    damped 6x6 diagonal blocks of J^T J (``diag_blocks``) where
    ``config.precondition``; the step is x * ``step_length``. A step
    that is not finite is dropped and clears ``valid``. Frozen
    (``solve_node_mask`` False) and padded nodes keep their transforms.
    J is formed over the free nodes' parameters only, once per GN step,
    by forward differentiation (``torch.func.jacfwd``); CG then runs on
    its products. That is the JAX solver's masked CG over all nodes,
    whose frozen components stay zero, in a few dozen device ops a step
    rather than a jvp and a vjp per CG iteration."""
    n = problem.nodes.shape[0]
    dev = problem.nodes.device
    R = (init_rotations if init_rotations is not None else
         torch.eye(3, dtype=torch.float32, device=dev).expand(n, 3, 3))
    t = (init_translations if init_translations is not None else
         torch.zeros((n, 3), dtype=torch.float32, device=dev))
    free = torch.nonzero(problem.solve_node_mask & problem.node_valid)[:, 0]
    k = free.shape[0]
    lm = float(config.lm_damping)
    hist = []
    ok = torch.ones((), dtype=torch.bool, device=dev)
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for _ in range(config.iters):
        base_R, base_t = R, t

        def res_fn(z):  # z [k, 6]: the free nodes' (dw, dt)
            return _residuals(zeros3.index_add(0, free, z[:, :3]),
                              base_t.index_add(0, free, z[:, 3:]), problem,
                              config, base_R)

        z0 = torch.zeros((k, 6), dtype=torch.float32, device=dev)
        r0 = res_fn(z0)
        hist.append(torch.sum(r0 * r0))
        if k == 0:
            continue
        J = torch.func.jacfwd(res_fn)(z0).reshape(r0.shape[0], 6 * k)

        def jtj(v):
            return J.T @ (J @ v) + lm * v

        if config.precondition:
            from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
                diag_blocks,
            )

            Db = diag_blocks(problem, config, R, t)[free] + lm * torch.eye(
                6, dtype=torch.float32, device=dev)
            Dinv = torch.linalg.inv_ex(Db).inverse  # [k, 6, 6]

            def apply_m(v):
                return torch.einsum("nij,nj->ni", Dinv,
                                    v.reshape(k, 6)).reshape(-1)
        else:
            def apply_m(v):
                return v

        b = -(J.T @ r0)
        x = torch.zeros_like(b)
        z = apply_m(b)
        r, p, rz = b, z, torch.dot(b, z)
        for _ in range(config.cg_iters):
            Ap = jtj(p)
            alpha = rz / torch.clamp(torch.dot(p, Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            z = apply_m(r)
            rz_new = torch.dot(r, z)
            p = z + rz_new / torch.clamp(rz, min=1e-20) * p
            rz = rz_new
        x = x.reshape(k, 6) * config.step_length
        finite = torch.isfinite(x).all()
        x = torch.where(finite, x, torch.zeros_like(x))
        R = torch.einsum("nij,njk->nik",
                         so3_exp(zeros3.index_add(0, free, x[:, :3])), R)
        t = t.index_add(0, free, x[:, 3:])
        ok = ok & finite
    warped = ed_warp(problem.source_points, problem.nodes, R, t,
                     problem.point_anchors, problem.point_weights)
    nv = problem.node_valid
    R = torch.where(nv[:, None, None], R,
                    torch.eye(3, dtype=torch.float32, device=dev))
    t = torch.where(nv[:, None], t, torch.zeros_like(t))
    return GNResult(rotations=R, translations=t, warped_points=warped,
                    residual_history=torch.stack(hist), valid=ok)
