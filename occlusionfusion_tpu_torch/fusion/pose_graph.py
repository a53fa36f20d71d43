"""Keyframe pose graph for long-sequence drift correction (port of
``occlusionfusion_tpu/fusion/pose_graph.py``).

Each keyframe carries a global SE(3) pose; edges carry relative-pose
measurements (odometry between consecutive keyframes, loop closures from
``fusion/loop_closure.py``). Gauss-Newton over se(3) tangent corrections,
each step's normal equations J^T J x = -J^T r solved by conjugate
gradients.

Residual per edge (i, j) with measurement (R_ij, t_ij):
  r = (log(R_err), t_err), (R_err, t_err) = T_ij^-1 T_i^-1 T_j.
The first pose is gauge-fixed. Small and host-side (keyframes only): the
jacobian [6E, 6K] of the residuals is formed once per GN step by forward
differentiation (``torch.func.jacfwd``), and CG runs on it, so a step is
a few dozen device ops rather than a jvp and a vjp per CG iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch.geometry.so3 import so3_exp, so3_log


class PoseGraph(NamedTuple):
    """Static-shape pose graph (padded)."""

    poses_R: torch.Tensor  # [K, 3, 3] initial keyframe rotations
    poses_t: torch.Tensor  # [K, 3]
    pose_valid: torch.Tensor  # [K]
    edge_i: torch.Tensor  # [E] int
    edge_j: torch.Tensor  # [E]
    edge_R: torch.Tensor  # [E, 3, 3] measured relative rotation i -> j
    edge_t: torch.Tensor  # [E, 3]
    edge_valid: torch.Tensor  # [E]
    edge_weight: torch.Tensor  # [E]


def _compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def _inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def _edge_residuals(xi, graph: PoseGraph):
    """[E, 6] weighted residuals at tangent corrections xi [K, 6] around
    the graph's poses."""
    R = so3_exp(xi[:, :3]) @ graph.poses_R
    t = graph.poses_t + xi[:, 3:]
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    Rinv, tinv = _inverse(R[ei], t[ei])
    R_rel, t_rel = _compose(Rinv, tinv, R[ej], t[ej])  # T_i^-1 T_j
    Rm_inv, tm_inv = _inverse(graph.edge_R, graph.edge_t)
    R_err, t_err = _compose(Rm_inv, tm_inv, R_rel, t_rel)
    res = torch.cat([so3_log(R_err), t_err], dim=-1)
    w = torch.sqrt(torch.clamp(graph.edge_weight, min=0.0)) * (
        graph.edge_valid.to(torch.float32))
    return res * w[:, None]


@torch.no_grad()
def optimize_pose_graph(graph: PoseGraph, iters: int = 10,
                        cg_iters: int = 32, damping: float = 1e-6):
    """GN over the tangent corrections; pose 0 is gauge-fixed.
    Returns (R [K, 3, 3], t [K, 3], residual_history [iters])."""
    K = graph.poses_R.shape[0]
    dev = graph.poses_R.device
    free = (graph.pose_valid
            & (torch.arange(K, device=dev) > 0))[:, None].to(torch.float32)
    poses_R, poses_t = graph.poses_R, graph.poses_t
    hist = []
    for _ in range(iters):
        g = graph._replace(poses_R=poses_R, poses_t=poses_t)

        def res_fn(xi):
            return _edge_residuals(xi, g)

        xi0 = torch.zeros((K, 6), dtype=torch.float32, device=dev)
        r0 = res_fn(xi0).reshape(-1)
        J = torch.func.jacfwd(res_fn)(xi0).reshape(r0.shape[0], K * 6)
        hist.append(torch.sum(r0 * r0))

        def jtj(v):
            v = v * free
            return (J.T @ (J @ v.reshape(-1))).reshape(K, 6) * free + (
                damping * v)

        b = -(J.T @ r0).reshape(K, 6) * free
        x, r, p, rs = torch.zeros_like(b), b, b, torch.sum(b * b)
        for _ in range(cg_iters):
            Ap = jtj(p)
            alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            rs2 = torch.sum(r * r)
            p = r + (rs2 / torch.clamp(rs, min=1e-20)) * p
            rs = rs2
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        poses_R = so3_exp(x[:, :3]) @ poses_R
        poses_t = poses_t + x[:, 3:]
    return poses_R, poses_t, torch.stack(hist)
