"""Non-rigid ICP: first-order warp-field solver on the SO(3) tangent (port
of ``occlusionfusion_tpu/solvers/nicp.py``).

Per-node rotations R = exp(omega) and pivoted translations t are fitted
by Adam over ARAP + landmark + motion costs (and, where their weights are
set, the truncated chamfer and the rendered silhouette and projective
depth costs), with the learning rate
decaying by ``gamma`` every step, for a static number of iterations.
Adam is written out in tensor ops to optax's semantics
(``optax.adam(exponential_decay(lr, 1, gamma))``: b1 0.9, b2 0.999, eps
1e-8 outside the square root, bias correction by the step count, the
rate lr * gamma^count taken before the count's increment). The
reference's ``loss < 1e-7`` early exit is a mask that freezes the
parameters and the whole optimiser state, count included, so no step
reads a value back to the host and the solve can be captured in a CUDA
graph. Gradients come from ``torch.autograd.grad`` on leaf tensors
under ``torch.enable_grad()``; the result is detached.

The chamfer cost compares random subsamples of the warped points and the
targets. The JAX package draws them from ``PRNGKey(0)`` in every solve,
a pair of index vectors per Adam step and one for the final loss, so
every frame uses the same samples. The port keeps that: ``solve`` takes
an index table [iters + 1, 2, S] (``chamfer_table``: the caller's, e.g.
the JAX package's own indices, or ``default_chamfer_table``, drawn once
from a ``torch.Generator`` seeded with 0) and draws nothing itself, so
a captured solve replays the same samples.

The rendered costs run only where the problem carries a target depth map
and its intrinsics (``NICPProblem.target_depth``/``render_intrinsics``),
as in the JAX package, whose fusion paths never set them (ROADMAP F14);
the silhouette cost has no gradient (F15).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp
from occlusionfusion_tpu_torch.geometry.so3 import so3_exp, so3_log
from occlusionfusion_tpu_torch.ops.rasterize import render_depth
from occlusionfusion_tpu_torch.solvers import losses

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class NICPConfig(NamedTuple):
    iters: int = 200
    lr: float = 0.06
    gamma: float = 0.999
    w_arap: float = 10.0
    w_ldmk: float = 1.0
    w_motion: float = 100.0
    w_chamfer: float = 0.0
    w_smooth_trans: float = 0.0
    w_smooth_rot: float = 0.0
    w_silh: float = 0.0
    w_depth: float = 0.0
    render_hw: tuple = (0, 0)
    early_stop_loss: float = 1e-7
    chamfer_samples: int = 1000
    chamfer_trunc: float = 0.3


class NICPProblem(NamedTuple):
    """Static-shape problem data; index tensors padded and masked."""

    source_points: torch.Tensor  # [P, 3]
    point_anchors: torch.Tensor  # [P, K]
    point_weights: torch.Tensor  # [P, K]
    point_valid: torch.Tensor  # [P] bool
    nodes: torch.Tensor  # [N, 3]
    node_valid: torch.Tensor  # [N] bool
    edges: torch.Tensor  # [N, K_e] -1 padded
    edge_weights: torch.Tensor  # [N, K_e]
    target_points: torch.Tensor  # [M, 3]
    landmark_src: torch.Tensor  # [L]
    landmark_tgt: torch.Tensor  # [L]
    landmark_valid: torch.Tensor  # [L] bool gate or float weights
    motion_targets: torch.Tensor  # [N, 3]
    motion_confidence: torch.Tensor  # [N]
    # the rendered costs' inputs (read only where w_silh or w_depth):
    # fx, fy, cx, cy (floats or a [4] tensor) and the target depth [H, W]
    render_intrinsics: tuple | torch.Tensor | None = None
    target_depth: torch.Tensor | None = None


class NICPResult(NamedTuple):
    rotations: torch.Tensor  # [N, 3, 3]
    translations: torch.Tensor  # [N, 3] (pivoted)
    warped_points: torch.Tensor  # [P, 3]
    loss_history: torch.Tensor  # [iters]
    final_loss: torch.Tensor  # 0-d


def chamfer_sizes(config: NICPConfig, n_source: int, n_target: int):
    """(S, T): the chamfer subsample sizes of the warped points and the
    targets."""
    return (min(config.chamfer_samples, n_source),
            min(config.chamfer_samples, n_target))


def default_chamfer_table(config: NICPConfig, n_source: int, n_target: int,
                          device=None):
    """[iters + 1, 2, max(S, T)] int64: per Adam step, then for the final
    loss, S indices into the n_source points and T into the n_target
    targets (the rest of a shorter row is 0), uniform, from a
    ``torch.Generator`` seeded with 0."""
    S, T = chamfer_sizes(config, n_source, n_target)
    gen = torch.Generator().manual_seed(0)
    rows = config.iters + 1
    table = torch.zeros((rows, 2, max(S, T)), dtype=torch.int64)
    table[:, 0, :S] = torch.randint(n_source, (rows, S), generator=gen)
    table[:, 1, :T] = torch.randint(n_target, (rows, T), generator=gen)
    return table.to(device)


def _objective(omega, t, problem: NICPProblem, config: NICPConfig,
               chamfer_idx=None):
    """(total cost, warped source points); ``chamfer_idx`` [2, S] is this
    evaluation's row of the chamfer table."""
    R = so3_exp(omega)
    warped = ed_warp(problem.source_points, problem.nodes, R, t,
                     problem.point_anchors, problem.point_weights)
    total = torch.zeros((), dtype=torch.float32, device=omega.device)
    if config.w_arap:
        total = total + config.w_arap * losses.arap_cost(
            R, t, problem.nodes, problem.edges, problem.edge_weights)
    if config.w_ldmk:
        total = total + config.w_ldmk * losses.landmark_cost(
            warped, problem.target_points, problem.landmark_src,
            problem.landmark_tgt, problem.landmark_valid)
    if config.w_motion:
        total = total + config.w_motion * losses.motion_cost(
            problem.nodes, t, problem.motion_targets,
            problem.motion_confidence, problem.node_valid)
    if config.w_chamfer:
        S, T = chamfer_sizes(config, problem.source_points.shape[0],
                             problem.target_points.shape[0])
        total = total + config.w_chamfer * losses.truncated_chamfer_cost(
            warped, problem.target_points, chamfer_idx[0, :S],
            chamfer_idx[1, :T], problem.point_valid, None,
            config.chamfer_trunc)
    if (config.w_silh or config.w_depth) and problem.target_depth is not None:
        src_depth, src_mask = render_depth(
            warped, tuple(problem.render_intrinsics), config.render_hw,
            problem.point_valid)
        if config.w_silh:
            total = total + config.w_silh * losses.silhouette_cost(
                src_mask, problem.target_depth > 0)
        if config.w_depth:
            total = total + config.w_depth * losses.projective_depth_cost(
                src_depth, problem.target_depth)
    return total, warped


def _grads(omega, t, problem, config, chamfer_idx):
    """(loss, d loss / d omega, d loss / d t), all detached."""
    with torch.enable_grad():
        omega = omega.detach().requires_grad_(True)
        t = t.detach().requires_grad_(True)
        loss, _ = _objective(omega, t, problem, config, chamfer_idx)
        g = torch.autograd.grad(loss, (omega, t), allow_unused=True)
    g = [torch.zeros_like(x) if gx is None else gx for gx, x in zip(g, (omega, t))]
    return loss.detach(), g[0], g[1]


def solve(
    problem: NICPProblem,
    config: NICPConfig = NICPConfig(),
    init_rotations: torch.Tensor | None = None,
    init_translations: torch.Tensor | None = None,
    chamfer_table: torch.Tensor | None = None,
) -> NICPResult:
    """``config.iters`` Adam steps from the warm start (omega =
    log(init_rotations), t = init_translations; zeros when not given).
    Padded nodes come back as the identity; invalid points keep their
    source position. With ``w_chamfer`` the subsamples come from
    ``chamfer_table`` (default: ``default_chamfer_table``, made here, so
    a captured solve is given one)."""
    if config.w_chamfer and chamfer_table is None:
        chamfer_table = default_chamfer_table(
            config, problem.source_points.shape[0],
            problem.target_points.shape[0], problem.nodes.device)
    rows = (chamfer_table if config.w_chamfer
            else [None] * (config.iters + 1))
    nodes = problem.nodes
    dev, n = nodes.device, nodes.shape[0]
    if init_rotations is None:
        omega = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    else:
        omega = so3_log(init_rotations).detach()
    if init_translations is None:
        t = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    else:
        t = init_translations.detach().clone()
    params = [omega, t]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    count = torch.zeros((), dtype=torch.float32, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    history = []
    for it in range(config.iters):
        loss, g_omega, g_t = _grads(params[0], params[1], problem, config,
                                    rows[it])
        count_inc = count + 1.0
        # the rate of this step, from the count before its increment
        step = -(config.lr * config.gamma ** count)
        bc1 = 1.0 - ADAM_B1 ** count_inc
        bc2 = 1.0 - ADAM_B2 ** count_inc
        stop_now = stopped | (loss < config.early_stop_loss)
        for i, g in enumerate((g_omega, g_t)):
            m = (1.0 - ADAM_B1) * g + ADAM_B1 * mu[i]
            v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu[i]
            update = step * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
            params[i] = torch.where(stop_now, params[i], params[i] + update)
            mu[i] = torch.where(stop_now, mu[i], m)
            nu[i] = torch.where(stop_now, nu[i], v)
        count = torch.where(stop_now, count, count_inc)
        stopped = stop_now
        history.append(loss)
    omega, t = params
    with torch.no_grad():
        final_loss, warped = _objective(omega, t, problem, config,
                                        rows[config.iters])
        R = so3_exp(omega)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    valid = problem.node_valid
    R = torch.where(valid[:, None, None], R, eye)
    t = torch.where(valid[:, None], t, torch.zeros_like(t))
    warped = torch.where(problem.point_valid[:, None], warped,
                         problem.source_points)
    loss_history = (torch.stack(history) if history
                    else torch.zeros((0,), dtype=torch.float32, device=dev))
    return NICPResult(rotations=R, translations=t, warped_points=warped,
                      loss_history=loss_history, final_loss=final_loss)
