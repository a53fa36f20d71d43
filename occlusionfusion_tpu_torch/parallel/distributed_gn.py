"""Distributed Gauss-Newton: point residuals sharded over the ranks of a
mesh axis, the normal equations reduced with ``all_reduce`` (port of
``occlusionfusion_tpu/parallel/distributed_gn.py``).

Every rank holds the whole problem and takes its block of the point
arrays (``mesh.shard_rows``), or, with ``sharded=True``, holds only its
block already (the sharded engine's tables); the node state stays
replicated, and every rank runs the same small solve on the same reduced
system, so the node transforms need no broadcast.

``solve_dense_distributed`` is the production solver sharded: each rank
adds its point shard (kernel K3' on the card, its twin on the CPU) and
the graph terms (K4') into one buffer [M | b | sq], one ``all_reduce``
per GN iteration sums it, and only then the free-node mask and the LM
damping are applied, once, before a replicated Cholesky. The graph terms
are replicated, so they are made exact under the sum by rescaling, as
in JAX: both enter M, b and sq quadratically in (edge weight, motion
confidence), so each rank takes edge weights / n and confidences /
sqrt(n). ``solve_distributed`` is JAX's matrix-free GN-CG: the point
term's products J^T J v from each rank's jacobian of its shard, one
``all_reduce`` of the 6N-vector per CG iteration (one more for b and sq
per step), the graph terms replicated.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp
from occlusionfusion_tpu_torch.parallel.mesh import axis_size, shard_rows
from occlusionfusion_tpu_torch.solvers.gauss_newton import (
    GNConfig,
    GNProblem,
    GNResult,
    _residuals,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
    _active_rows,
    _add_terms,
    _fixed_terms,
    _linear_solve,
    _retract,
    check_assembly,
)

POINT_FIELDS = ("source_points", "point_anchors", "point_weights",
                "target_points", "point_valid")


def _all_reduce(buf: torch.Tensor, group) -> None:
    """Sum ``buf`` over the group in place (every collective of this
    module goes through here)."""
    dist.all_reduce(buf, group=group)


def shard_problem(mesh, problem: GNProblem, axis: str = "data") -> GNProblem:
    """This rank's problem: its block of the point arrays, the node
    arrays whole."""
    return problem._replace(**{
        f: shard_rows(mesh, getattr(problem, f), axis) for f in POINT_FIELDS
    })


def _initial(problem: GNProblem, R0, t0):
    n = problem.nodes.shape[0]
    dev = problem.nodes.device
    R = R0 if R0 is not None else torch.eye(
        3, dtype=torch.float32, device=dev).expand(n, 3, 3).contiguous()
    t = t0 if t0 is not None else torch.zeros(
        (n, 3), dtype=torch.float32, device=dev)
    return R, t


def _result(local: GNProblem, R, t, hist, ok) -> GNResult:
    warped = ed_warp(local.source_points, local.nodes, R, t,
                     local.point_anchors, local.point_weights)
    nv = local.node_valid
    R = torch.where(nv[:, None, None], R,
                    torch.eye(3, dtype=torch.float32, device=R.device))
    t = torch.where(nv[:, None], t, torch.zeros_like(t))
    return GNResult(rotations=R, translations=t, warped_points=warped,
                    residual_history=hist, valid=ok)


def _local(mesh, problem: GNProblem, axis: str, sharded: bool) -> GNProblem:
    return problem if sharded else shard_problem(mesh, problem, axis)


@torch.no_grad()
def solve_dense_distributed(mesh, problem: GNProblem,
                            config: GNConfig = GNConfig(), axis: str = "data",
                            init_rotations=None, init_translations=None,
                            sharded: bool = False) -> GNResult:
    """The dense GN solve of ``solve_dense`` with the point term sharded
    over ``axis``: ``config.iters`` damped steps from (init_rotations,
    init_translations) (identity and zero by default), the system
    assembled by the "blocks" route and solved by Cholesky whatever
    ``config.assembly`` and ``config.linear_solver`` say (as in JAX). P
    must divide by the axis size; with ``sharded`` the problem's point
    arrays are already this rank's block. ``warped_points`` is this
    rank's shard (``mesh.gather_blocks`` assembles it);
    ``residual_history`` is the reduced squared residual of each
    iteration."""
    return _solve_dense_shard(
        mesh, _local(mesh, problem, axis, sharded),
        config._replace(assembly="blocks", linear_solver="cholesky"), axis,
        init_rotations, init_translations)


@torch.no_grad()
def _solve_dense_shard(mesh, local: GNProblem, config: GNConfig, axis: str,
                      init_rotations, init_translations) -> GNResult:
    """The loop of ``solve_dense_distributed`` on this rank's shard
    ``local``, with the system assembled by ``config.assembly``'s route
    and solved by ``config.linear_solver``: what GSPMD makes of
    ``solve_dense`` inside the sharded fused step
    (``parallel/engine.RankShard``)."""
    check_assembly(config)
    n_shards = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    local = local._replace(
        edge_weights=local.edge_weights / n_shards,
        motion_confidence=local.motion_confidence / math.sqrt(n_shards),
    )
    n = local.nodes.shape[0]
    dev = local.nodes.device
    R, t = _initial(local, init_rotations, init_translations)
    free = (local.solve_node_mask & local.node_valid).to(torch.float32)
    free6 = torch.repeat_interleave(free, 6)
    free66 = free6[:, None] * free6[None, :]
    damp = torch.diag(torch.where(
        free6 > 0, torch.full_like(free6, config.lm_damping),
        torch.ones_like(free6)))
    terms = _fixed_terms(local, config)
    active = _active_rows(local)
    # one buffer [M | b | sq], summed by one all_reduce an iteration
    buf = torch.empty((36 * n * n + 6 * n + 1,), dtype=torch.float32,
                      device=dev)
    M = buf[: 36 * n * n].view(6 * n, 6 * n)
    b = buf[36 * n * n: 36 * n * n + 6 * n]
    sq = buf[-1]
    hist = torch.zeros((config.iters,), dtype=torch.float32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for it in range(config.iters):
        buf.zero_()
        _add_terms(local, config, terms, R, t, M, b, sq)
        _all_reduce(buf, group)
        hist[it] = sq
        A = torch.addcmul(damp, M, free66)
        x, finite = _linear_solve(A, -b * free6, free6, active, config)
        R, t, finite = _retract(R, t, x, finite, config.step_length)
        ok = ok & finite
    return _result(local, R, t, hist, ok)


@torch.no_grad()
def solve_distributed(mesh, problem: GNProblem, config: GNConfig = GNConfig(),
                      axis: str = "data", sharded: bool = False) -> GNResult:
    """JAX's matrix-free GN-CG with the point residuals sharded over
    ``axis``: ``config.iters`` steps from identity, each ``config.cg_iters``
    CG iterations from zero without a preconditioner on
    (J^T J + lm I) x = -J^T r over the free nodes' (dw, t). Each step,
    every rank forms the jacobian of its point rows and of the
    (replicated) graph rows over all nodes' (dw, t) by forward
    differentiation (``torch.func.jacfwd``, as the port's ``solve``
    does); the point term's J^T J v is summed by one ``all_reduce`` of the
    6N-vector per CG iteration, one more sums b and sq a step. P must
    divide by the axis size (``sharded``: the point arrays are already
    this rank's block); ``warped_points`` is this rank's shard."""
    group = mesh.get_group(axis)
    local = _local(mesh, problem, axis, sharded)
    n = local.nodes.shape[0]
    rows = 3 * local.source_points.shape[0]
    dev = local.nodes.device
    R, t = _initial(local, None, None)
    mask = (local.solve_node_mask & local.node_valid).to(
        torch.float32)[:, None].repeat(2, 3).reshape(-1)
    lm = float(config.lm_damping)
    hist = torch.zeros((config.iters,), dtype=torch.float32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    zero = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    # JAX's split: the point rows alone (the shard's), and the graph rows
    # alone (replicated: no point arrays)
    pt_cfg = config._replace(w_arap=0.0, w_motion=0.0)
    g_cfg = config._replace(w_point=0.0)
    graph = local._replace(**{f: getattr(local, f)[:0] for f in POINT_FIELDS})
    for it in range(config.iters):
        base_R = R

        def pt_res(x):  # x [6N]: every node's (dw, t), dw first
            x = x.view(2, n, 3)
            return _residuals(x[0], x[1], local, pt_cfg, base_R)[:rows]

        def g_res(x):
            x = x.view(2, n, 3)
            return _residuals(x[0], x[1], graph, g_cfg, base_R)

        x0 = torch.cat([zero, t]).reshape(-1)
        r_pt, r_g = pt_res(x0), g_res(x0)
        J_pt = torch.func.jacfwd(pt_res)(x0)
        J_g = torch.func.jacfwd(g_res)(x0)
        red = torch.cat([J_pt.T @ r_pt, torch.sum(r_pt * r_pt)[None]])
        _all_reduce(red, group)
        hist[it] = red[-1] + torch.sum(r_g * r_g)
        b = -(red[:-1] + J_g.T @ r_g) * mask

        def jtj(v):
            v = v * mask
            s_pt = J_pt.T @ (J_pt @ v)
            _all_reduce(s_pt, group)
            return (s_pt + J_g.T @ (J_g @ v)) * mask + lm * v

        x = torch.zeros_like(b)
        r, p = b, b
        rs = torch.sum(b * b)
        for _ in range(config.cg_iters):
            Ap = jtj(p)
            alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = torch.sum(r * r)
            p = r + rs_new / torch.clamp(rs, min=1e-20) * p
            rs = rs_new
        x = x.view(2, n, 3)
        R, t, finite = _retract(R, t, torch.cat([x[0], x[1]], dim=1),
                                torch.ones_like(ok), config.step_length)
        ok = ok & finite
    return _result(local, R, t, hist, ok)
