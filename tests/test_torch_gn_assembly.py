"""Port of the GN point term (ops/gn_assembly.py) and the dense solver:
the K3' twin, accumulated into M, b and sq, against the JAX
_assemble_blocks(assembly="blocks") with FRACTIONAL point weights (the
case the TPU kernel gets wrong), 5e-5 relative as in the JAX suite; the
accumulating twin against the per-point blocks and the scatter the
caller did before K3'; and K3''s own arithmetic (csrc/gn_assembly.cu),
emulated in numpy, against the twin."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.gauss_newton_dense import (
    _assemble_blocks as assemble_blocks_jax,
    solve_dense as solve_dense_jax,
)
from occlusionfusion_tpu_torch.ops.gn_assembly import (
    point_term_accumulate,
    point_term_accumulate_cuda,
    point_term_accumulate_torch,
    point_term_blocks_torch,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
    _assemble_blocks,
    solve_dense,
)
from test_gauss_newton import build_problem
from torch_port_impl import (
    gn_problem_to_torch,
    hat_entry,
    random_pose_field,
    tt,
)

REL = 5e-5


def _fractional_problem(seed):
    problem, _, _ = build_problem(n_pts=300, n_nodes=30)
    rng = np.random.RandomState(seed)
    pv = np.asarray(problem.point_valid) * rng.uniform(0.3, 1.0, 300)
    problem = problem._replace(point_valid=jnp.asarray(pv.astype(np.float32)))
    return problem


@pytest.mark.parametrize("w_motion", [0.0, 1.5])
@pytest.mark.parametrize("seed", [4, 9])
def test_blocks_match_jax_with_fractional_weights(w_motion, seed):
    problem = _fractional_problem(seed)
    n = problem.nodes.shape[0]
    R, t = random_pose_field(n, seed)
    if w_motion:
        rng = np.random.RandomState(seed + 1)
        problem = problem._replace(
            motion_targets=problem.nodes + 0.01,
            motion_confidence=jnp.asarray(rng.rand(n).astype(np.float32)),
        )
    cfg_j = GNConfigJ(iters=1, w_point=1.7, w_arap=2.1, w_motion=w_motion,
                      assembly="blocks")
    M1, b1, sq1 = assemble_blocks_jax(problem, cfg_j, jnp.asarray(R),
                                      jnp.asarray(t))
    cfg = GNConfig(iters=1, w_point=1.7, w_arap=2.1, w_motion=w_motion)
    M2, b2, sq2 = _assemble_blocks(gn_problem_to_torch(problem), cfg, tt(R),
                                   tt(t))
    M1, b1 = np.asarray(M1), np.asarray(b1)
    np.testing.assert_allclose(M2.numpy(), M1, atol=REL * np.abs(M1).max())
    np.testing.assert_allclose(b2.numpy(), b1, atol=REL * np.abs(b1).max())
    np.testing.assert_allclose(float(sq2), float(sq1), rtol=REL)


def _point_inputs(seed):
    problem = gn_problem_to_torch(_fractional_problem(seed))
    R, t = random_pose_field(problem.nodes.shape[0], seed)
    return (problem.source_points, problem.target_points,
            problem.point_valid, problem.point_anchors,
            problem.point_weights, problem.nodes, tt(R), tt(t))


def _system(n):
    return (torch.zeros((6 * n, 6 * n)), torch.zeros(6 * n),
            torch.zeros(()))


def _padded_point_inputs(seed):
    """_point_inputs with the last 40 points padded (pv = 0) and one
    anchor weight in ten zeroed: pairs the kernel skips."""
    x, y, pv, a, w, g, R, t = _point_inputs(seed)
    pv = pv.clone()
    pv[-40:] = 0.0
    rng = np.random.RandomState(seed)
    w = torch.where(torch.from_numpy(rng.rand(*w.shape) < 0.1),
                    torch.zeros_like(w), w)
    return x, y, pv, a, w, g, R, t


def emulate_point_kernel(x, y, pv, a, w, g, R, t, sw):
    """K3' in numpy, step by step as csrc/gn_assembly.cu adds: b and r.r
    per point, then per anchor pair (k, l) and block row the three
    8-byte adds, with the pairs the kernel skips left out."""
    n = g.shape[0]
    M = np.zeros((6 * n, 6 * n), np.float64)
    b = np.zeros((n, 6), np.float64)
    loc = np.einsum("pkij,pkj->pki", R[a], x[:, None] - g[a])
    warped = np.sum(w[..., None] * (loc + g[a] + t[a]), axis=1)
    r = sw * pv[:, None] * (warped - y)
    wg = w * pv[:, None]
    for k in range(4):
        c = (sw * wg[:, k])[:, None]
        np.add.at(b, a[:, k], c * np.concatenate(
            [np.cross(loc[:, k], r), r], axis=1))
    for row in range(6):
        for k in range(4):
            for l in range(4):
                s = sw * sw * wg[:, k] * wg[:, l]
                A, B = loc[:, k], loc[:, l]
                v = np.zeros((x.shape[0], 6))
                if row < 3:
                    i1, i2 = (row + 1) % 3, (row + 2) % 3
                    for j in range(3):
                        v[:, j] = (
                            s * (A[:, i1] * B[:, i1] + A[:, i2] * B[:, i2])
                            if j == row else -s * (B[:, row] * A[:, j]))
                        v[:, 3 + j] = s * hat_entry(A, row, j)
                    pairs = (0, 1, 2)
                else:
                    rr = row - 3
                    for j in range(3):
                        v[:, j] = -s * hat_entry(B, rr, j)
                        v[:, 3 + j] = s * (j == rr)
                    pairs = tuple(q for q in range(3)
                                  if not (rr == 2 and q == 1)
                                  and not (rr == 0 and q == 2))
                live = s != 0
                for q in pairs:
                    cols = 6 * a[live, l][:, None] + 2 * q + np.arange(2)
                    np.add.at(M, ((6 * a[live, k] + row)[:, None], cols),
                              v[live, 2 * q: 2 * q + 2])
    return M, b.reshape(-1), np.sum(r * r)


@pytest.mark.parametrize("padded", [False, True])
def test_kernel_arithmetic_matches_twin(padded):
    """csrc/gn_assembly.cu: the closed-form block rows
    sw^2 wg_k wg_l [[(l_k.l_l) I - l_l l_k^T, hat(l_k)], [-hat(l_l), I]],
    its zero skips and b = sw wg_k [l_k x r; r], emulated in numpy,
    against the accumulating twin (fractional pv; padded points and zero
    anchor weights in the second case)."""
    inputs = _padded_point_inputs(2) if padded else _point_inputs(2)
    sw = float(np.sqrt(1.7))
    M1, b1, sq1 = emulate_point_kernel(
        *(v.numpy().astype(np.float64) if v.is_floating_point() else
          v.numpy() for v in inputs), sw)
    M2, b2, sq2 = _system(inputs[5].shape[0])
    point_term_accumulate_torch(*inputs, sw, M2, b2, sq2)
    np.testing.assert_allclose(M2.numpy(), M1, atol=1e-6 * np.abs(M1).max())
    np.testing.assert_allclose(b2.numpy(), b1, atol=1e-6 * np.abs(b1).max())
    np.testing.assert_allclose(float(sq2), sq1, rtol=1e-5)


@pytest.mark.parametrize("padded", [False, True])
def test_accumulate_twin_matches_blocks_and_old_scatter(padded):
    """point_term_accumulate_torch equals point_term_blocks_torch followed
    by the scatter _assemble_blocks did before K3' (segment ids per pair,
    one index_add_ into [N*N, 36], the permute to [6N, 6N]), within 1e-6
    of scale, adding onto a system that already holds values."""
    inputs = _padded_point_inputs(5) if padded else _point_inputs(5)
    n = inputs[5].shape[0]
    blk, b_pt, rsq = point_term_blocks_torch(*inputs, 1.3)
    a = inputs[3].long()
    seg = (a[:, :, None] * n + a[:, None, :]).reshape(-1)
    table = torch.zeros((n * n, 36)).index_add_(0, seg, blk.reshape(-1, 36))
    rng = np.random.RandomState(1)
    M0 = torch.from_numpy(rng.rand(6 * n, 6 * n).astype(np.float32))
    b0 = torch.from_numpy(rng.rand(6 * n).astype(np.float32))
    M_ref = M0 + table.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(
        6 * n, 6 * n)
    b_ref = b0 + torch.zeros((n, 6)).index_add_(
        0, a.reshape(-1), b_pt.reshape(-1, 6)).reshape(-1)
    M, b, sq = M0.clone(), b0.clone(), torch.tensor(0.5)
    point_term_accumulate_torch(*inputs, 1.3, M, b, sq)
    np.testing.assert_allclose(M.numpy(), M_ref.numpy(),
                               atol=1e-6 * float(M_ref.abs().max()))
    np.testing.assert_allclose(b.numpy(), b_ref.numpy(),
                               atol=1e-6 * float(b_ref.abs().max()))
    np.testing.assert_allclose(float(sq), 0.5 + float(rsq.sum()), rtol=1e-6)


def test_front_door_uses_twin_on_cpu():
    args = _point_inputs(3)
    n = args[5].shape[0]
    (M1, b1, s1), (M2, b2, s2) = _system(n), _system(n)
    point_term_accumulate(*args, 1.0, M1, b1, s1)
    point_term_accumulate_torch(*args, 1.0, M2, b2, s2)
    assert all(np.array_equal(u.numpy(), v.numpy())
               for u, v in zip((M1, b1, s1), (M2, b2, s2)))


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        point_term_accumulate_cuda(*_point_inputs(3), 1.0,
                                   *_system(_point_inputs(3)[5].shape[0]))


@pytest.mark.parametrize("w_motion", [0.0, 1.0])
def test_solve_dense_matches_jax(w_motion):
    problem = _fractional_problem(6)
    n = problem.nodes.shape[0]
    if w_motion:
        problem = problem._replace(
            motion_targets=problem.nodes,
            motion_confidence=jnp.full((n,), 0.5, jnp.float32),
        )
    kw = dict(iters=4, w_point=1.0, w_arap=2.0, w_motion=w_motion)
    # start from a small non-identity warp, as a frame after the first does
    R0, t0 = random_pose_field(n, seed=12, rot=0.05, trans=0.01)
    ref = solve_dense_jax(problem, GNConfigJ(assembly="blocks", **kw),
                          jnp.asarray(R0), jnp.asarray(t0))
    got = solve_dense(gn_problem_to_torch(problem), GNConfig(**kw), tt(R0),
                      tt(t0))
    assert bool(got.valid) and bool(ref.valid)
    np.testing.assert_allclose(got.rotations.numpy(),
                               np.asarray(ref.rotations), atol=1e-4)
    np.testing.assert_allclose(got.translations.numpy(),
                               np.asarray(ref.translations), atol=1e-4)
    # the residual converges to ~1e-13: compare against the first one
    hist = np.asarray(ref.residual_history)
    np.testing.assert_allclose(got.residual_history.numpy(), hist,
                               rtol=1e-4, atol=1e-6 * hist[0])
