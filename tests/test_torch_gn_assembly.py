"""Port of the GN point term (ops/gn_assembly.py) and the dense solver:
the K3 twin, segment-summed into M, b and sq, against the JAX
_assemble_blocks(assembly="blocks") with FRACTIONAL point weights (the
case the TPU kernel gets wrong), 5e-5 relative as in the JAX suite."""

import numpy as np
import pytest
import jax.numpy as jnp

from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.gauss_newton_dense import (
    _assemble_blocks as assemble_blocks_jax,
    solve_dense as solve_dense_jax,
)
from occlusionfusion_tpu_torch.ops.gn_assembly import (
    point_term_blocks,
    point_term_blocks_cuda,
    point_term_blocks_torch,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
    _assemble_blocks,
    solve_dense,
)
from test_gauss_newton import build_problem
from torch_port_impl import gn_problem_to_torch, random_pose_field, tt

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


def test_kernel_arithmetic_matches_twin():
    """csrc/gn_assembly.cu per point: ungated blend for the residual,
    gated weights in the jacobian, pv once in r; emulate it in numpy."""
    x, y, pv, a, w, g, R, t = (v.numpy() for v in _point_inputs(2))
    sw = np.sqrt(1.7)
    local = np.einsum("pkij,pkj->pki", R[a], x[:, None] - g[a])
    warped = np.sum(w[..., None] * (local + g[a] + t[a]), axis=1)
    r = sw * pv[:, None] * (warped - y)
    wg = w * pv[:, None]
    lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
    z = np.zeros_like(lx)
    nh = np.stack([np.stack([z, lz, -ly], -1), np.stack([-lz, z, lx], -1),
                   np.stack([ly, -lx, z], -1)], -2)  # -hat(local)
    J = sw * np.concatenate(
        [nh * wg[..., None, None], np.eye(3) * wg[..., None, None]], -1
    )
    blk = np.einsum("pkai,plaj->pklij", J, J).reshape(-1, 16, 6, 6)
    b = np.einsum("pkai,pa->pki", J, r)
    got = point_term_blocks_torch(*_point_inputs(2), float(sw))
    scale = np.abs(blk).max()
    np.testing.assert_allclose(got[0].numpy(), blk, atol=1e-6 * scale)
    np.testing.assert_allclose(got[1].numpy(), b, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(got[2].numpy(), np.sum(r * r, -1), rtol=1e-5)


def test_front_door_uses_twin_on_cpu():
    args = _point_inputs(3)
    a = point_term_blocks(*args, 1.0)
    b = point_term_blocks_torch(*args, 1.0)
    assert all(np.array_equal(u.numpy(), v.numpy()) for u, v in zip(a, b))


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        point_term_blocks_cuda(*_point_inputs(3), 1.0)


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
