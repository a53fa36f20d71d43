"""Gauss-Newton problem types and the matrix-free GN-CG solver (port of
``occlusionfusion_tpu/solvers/gauss_newton.py``).

Only the isotropic point-to-point data term (the JAX ``point3d``) is
ported. The dense solver (``gauss_newton_dense.solve_dense``) assembles
the normal equations by blocks, kernels K3' and K4' on CUDA tensors,
their twins on CPU tensors, and solves them by Cholesky. ``solve`` never
forms them: conjugate gradients over the free nodes' (dw, t) on the
residuals' jacobian, without the block-Jacobi preconditioner. Graph
growth runs it to ARAP-initialise new nodes with the old ones frozen.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp
from occlusionfusion_tpu_torch.geometry.so3 import so3_exp


class GNConfig(NamedTuple):
    iters: int = 10
    lm_damping: float = 1e-4
    w_point: float = 1.0
    w_arap: float = 2.0
    w_motion: float = 0.0
    # the dense solver's linear solver (Cholesky only)
    linear_solver: str = "cholesky"
    # the matrix-free solver's CG iterations per GN step (full steps);
    # the JAX block-Jacobi preconditioner is not ported: check_config
    # raises on precondition=True
    cg_iters: int = 32
    precondition: bool = False


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


class GNResult(NamedTuple):
    rotations: torch.Tensor
    translations: torch.Tensor
    warped_points: torch.Tensor
    residual_history: torch.Tensor  # [iters] total squared residual
    valid: torch.Tensor  # 0-d bool: every iteration finite


def check_config(config: GNConfig) -> None:
    if config.linear_solver != "cholesky":
        raise NotImplementedError(
            f"linear_solver={config.linear_solver!r} is not ported "
            "(cholesky only)"
        )
    if config.precondition:
        raise NotImplementedError("precondition=True is not ported")


def data_residual_rows(warped, targets, point_valid, sw: float):
    """Weighted point3d data residual [P, 3]: sw * pv * (warped - y), with
    sw = sqrt(w_point); the point weight pv enters once."""
    return sw * point_valid[:, None] * (warped - targets)


def _residuals(dw, t, problem: GNProblem, config: GNConfig, base_R):
    """The stacked weighted residuals, one flat vector (point rows, ARAP
    edges, the motion prior where w_motion), at rotations
    exp(dw) base_R and translations t."""
    R = torch.einsum("nij,njk->nik", so3_exp(dw), base_R)
    warped = ed_warp(problem.source_points, problem.nodes, R, t,
                     problem.point_anchors, problem.point_weights)
    point = data_residual_rows(warped, problem.target_points,
                               problem.point_valid, float(config.w_point)
                               ** 0.5)
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
    ``config.cg_iters`` CG iterations; a step that is not finite is
    dropped and clears ``valid``. Frozen (``solve_node_mask`` False) and
    padded nodes keep their transforms. J is formed over the free nodes'
    parameters only, once per GN step, by forward differentiation
    (``torch.func.jacfwd``); CG then runs on its products. That is the
    JAX solver's masked CG over all nodes, whose frozen components stay
    zero, in a few dozen device ops a step rather than a jvp and a vjp
    per CG iteration."""
    check_config(config)
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

        b = -(J.T @ r0)
        x = torch.zeros_like(b)
        r, p, rz = b, b, torch.dot(b, b)
        for _ in range(config.cg_iters):
            Ap = jtj(p)
            alpha = rz / torch.clamp(torch.dot(p, Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            rz_new = torch.dot(r, r)
            p = r + rz_new / torch.clamp(rz, min=1e-20) * p
            rz = rz_new
        x = x.reshape(k, 6)
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
