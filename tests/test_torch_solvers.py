"""The remaining Gauss-Newton solvers of the port against the JAX package
on the CPU, on the same seeded numpy inputs: the 2d_depth data term
(data_residual_rows, projection_row_scaling), K3''s twin with the
2d_depth rows against the JAX _assemble_blocks(assembly="blocks") (the
route JAX takes for this data term on every backend) with fractional
point weights, K3''s 2d_depth arithmetic (csrc/gn_assembly.cu) emulated
in numpy against the twin, diag_blocks, the Schur and Newton-Schulz
inverses, solve_dense with each linear solver, and the preconditioned
matrix-free GN-CG with a step length.

Tolerances are the JAX suite's own: M, b and sq within 5e-5 relative
(tests/test_gn_assembly.py), so M relative to its largest entry, which
the 2d_depth rows scale by fx/z; the explicit inverses' X M within 5e-3
of I (tests/test_gauss_newton_dense.py); the linear solvers' node
translations within 2e-4 (cg, schur) and 5e-4 (ns) of Cholesky's
(tests/test_gauss_newton_dense.py:65-187), and the port within the same
of the JAX package with the same solver; PCG within 3e-4
(tests/test_preconditioner.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occlusionfusion_tpu.ops import blocksolve as BSJ
from occlusionfusion_tpu.solvers import gauss_newton as GNJ
from occlusionfusion_tpu.solvers import gauss_newton_dense as GNDJ
from occlusionfusion_tpu_torch.ops import blocksolve as BS
from occlusionfusion_tpu_torch.ops.gn_assembly import (
    point_term_accumulate_torch,
)
from occlusionfusion_tpu_torch.solvers import gauss_newton as GN
from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND
from test_gauss_newton import build_problem
from test_gn_2d_depth import INTR
from test_gn_2d_depth import build_problem as build_2d_problem
from torch_port_impl import (  # noqa: F401
    gn_problem_to_torch,
    one_torch_thread,
    random_pose_field,
    tt,
)

REL = 5e-5
# the JAX functions compiled whole, each once per shape and config: far
# fewer XLA compiles than their ops one by one
jit_cfg = functools.partial(jax.jit, static_argnames=("config",))
assemble_blocks_j = jit_cfg(GNDJ._assemble_blocks)
diag_blocks_j = jit_cfg(GNDJ.diag_blocks)
data_residual_rows_j = jit_cfg(GNJ.data_residual_rows)
projection_row_scaling_j = jit_cfg(GNJ.projection_row_scaling)
schur_inverse_j = jax.jit(BSJ.spd_schur_inverse, static_argnames=("leaf",))
schur_solve_j = jax.jit(BSJ.spd_schur_solve, static_argnames=("leaf",))
ns_inverse_j = jax.jit(BSJ.newton_schulz_inverse,
                       static_argnames=("block", "iters"))
ns_solve_j = jax.jit(BSJ.newton_schulz_solve,
                     static_argnames=("block", "iters"))
SOLVER_ATOL = {"cg": 2e-4, "schur": 2e-4, "ns": 5e-4}
TWO_D = dict(data_term="2d_depth", w_flow=1e-3, w_depth=1.0)


def _problem(case, seed=4):
    """A JAX GNProblem: "point3d" (tests/test_gauss_newton.py's sphere) or
    "2d_depth" (tests/test_gn_2d_depth.py's sphere in front of the
    camera, with its intrinsics); fractional point weights, a motion
    prior and a quarter of the nodes frozen."""
    if case == "point3d":
        problem, _, _ = build_problem(n_pts=300, n_nodes=30, seed=seed)
    else:
        problem, _, _ = build_2d_problem(n_pts=300, n_nodes=24, seed=seed)
        problem = problem._replace(intrinsics=INTR)
    n, P = problem.nodes.shape[0], problem.source_points.shape[0]
    rng = np.random.RandomState(seed)
    pv = np.asarray(problem.point_valid) * rng.uniform(0.3, 1.0, P)
    mask = np.ones(n, bool)
    mask[: n // 4] = False
    return problem._replace(
        point_valid=jnp.asarray(pv.astype(np.float32)),
        motion_targets=problem.nodes + 0.01,
        motion_confidence=jnp.asarray(rng.rand(n).astype(np.float32)),
        solve_node_mask=jnp.asarray(mask))


def _configs(case, **kw):
    extra = TWO_D if case == "2d_depth" else {}
    return (GNJ.GNConfig(assembly="blocks", **extra, **kw),
            GN.GNConfig(**extra, **kw))


@pytest.mark.parametrize("case", ["point3d", "2d_depth"])
def test_data_rows_and_row_scaling_match_jax(case):
    problem = _problem(case)
    cfg_j, cfg = _configs(case, w_point=1.7)
    rng = np.random.RandomState(1)
    warped = problem.target_points + jnp.asarray(
        rng.randn(*problem.target_points.shape).astype(np.float32) * 0.01)
    pt = gn_problem_to_torch(problem)
    got = GN.data_residual_rows(tt(warped), pt, cfg).numpy()
    ref = np.asarray(data_residual_rows_j(warped, problem, config=cfg_j))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(
        ref).max())
    G = GN.projection_row_scaling(tt(warped), pt, cfg)
    Gj = projection_row_scaling_j(warped, problem, config=cfg_j)
    if case == "point3d":
        assert G is None and Gj is None
    else:
        np.testing.assert_allclose(G.numpy(), np.asarray(Gj), rtol=1e-6)


@pytest.mark.parametrize("w_motion", [0.0, 1.5])
@pytest.mark.parametrize("seed", [4, 9])
def test_point_term_2d_depth_matches_jax_blocks(seed, w_motion):
    """M, b and sq of the 2d_depth system with fractional point weights,
    the point term through K3''s twin, against the JAX XLA blocks."""
    problem = _problem("2d_depth", seed)
    R, t = random_pose_field(problem.nodes.shape[0], seed, rot=0.1,
                             trans=0.02)
    cfg_j, cfg = _configs("2d_depth", w_point=1.7, w_arap=2.1,
                          w_motion=w_motion)
    M1, b1, sq1 = (np.asarray(x) for x in assemble_blocks_j(
        problem, config=cfg_j, R=jnp.asarray(R), t=jnp.asarray(t)))
    M2, b2, sq2 = GND._assemble_blocks(gn_problem_to_torch(problem), cfg,
                                       tt(R), tt(t))
    np.testing.assert_allclose(M2.numpy(), M1, atol=REL * np.abs(M1).max())
    np.testing.assert_allclose(b2.numpy(), b1, atol=REL * np.abs(b1).max())
    np.testing.assert_allclose(float(sq2), float(sq1), rtol=REL)


def emulate_point_kernel_2d(x, y, pv, a, w, g, R, t, sw, proj):
    """K3''s 2d_depth branch in numpy, as csrc/gn_assembly.cu computes
    it: per point the projected residual r, G's five entries,
    pull = G^T r and C = G^T G; b[a_k] += sw wg_k [l_k x pull; pull];
    block row i < 3 of pair (k, l) is s (l_l x u, u) with
    u_j = (l_k x C_j)_i, row 3 + i is s (l_l x C_i, C_i)."""
    fx, fy, sf, sd = proj
    n = g.shape[0]
    M = np.zeros((6 * n, 6 * n))
    b = np.zeros((n, 6))
    loc = np.einsum("pkij,pkj->pki", R[a], x[:, None] - g[a])
    warped = np.sum(w[..., None] * (loc + g[a] + t[a]), axis=1)
    zi = 1.0 / (warped[:, 2] + 1e-7)
    tzi = 1.0 / (y[:, 2] + 1e-7)
    spv = sw * pv
    r = np.stack([spv * sf * (fx * warped[:, 0] * zi - fx * y[:, 0] * tzi),
                  spv * sf * (fy * warped[:, 1] * zi - fy * y[:, 1] * tzi),
                  spv * sd * (warped[:, 2] - y[:, 2])], -1)
    g00, g11 = sf * fx * zi, sf * fy * zi
    g02 = -sf * fx * warped[:, 0] * zi * zi
    g12 = -sf * fy * warped[:, 1] * zi * zi
    pull = np.stack([g00 * r[:, 0], g11 * r[:, 1],
                     g02 * r[:, 0] + g12 * r[:, 1] + sd * r[:, 2]], -1)
    C = np.zeros((x.shape[0], 3, 3))
    C[:, 0, 0], C[:, 0, 2], C[:, 1, 1] = g00 * g00, g00 * g02, g11 * g11
    C[:, 1, 2] = g11 * g12
    C[:, 2, 2] = g02 * g02 + g12 * g12 + sd * sd
    C[:, 2, 0], C[:, 2, 1] = C[:, 0, 2], C[:, 1, 2]
    wg = w * pv[:, None]
    for k in range(4):
        c = (sw * wg[:, k])[:, None]
        np.add.at(b, a[:, k], c * np.concatenate(
            [np.cross(loc[:, k], pull), pull], axis=1))
    for k in range(4):
        for l in range(4):
            s = (sw * sw * wg[:, k] * wg[:, l])[:, None]
            for row in range(6):
                if row < 3:
                    u = np.stack([np.cross(loc[:, k], C[:, :, j])[:, row]
                                  for j in range(3)], -1)
                else:
                    u = C[:, row - 3, :]
                v = s * np.concatenate([np.cross(loc[:, l], u), u], axis=1)
                for p in np.nonzero(s[:, 0])[0]:
                    M[6 * a[p, k] + row, 6 * a[p, l]:6 * a[p, l] + 6] += v[p]
    return M, b.reshape(-1), float(np.sum(r * r))


def test_kernel_arithmetic_2d_matches_twin():
    problem = gn_problem_to_torch(_problem("2d_depth", 3))
    n = problem.nodes.shape[0]
    R, t = random_pose_field(n, 3, rot=0.1, trans=0.02)
    pv = problem.point_valid.clone()
    pv[-30:] = 0.0
    args = (problem.source_points, problem.target_points, pv,
            problem.point_anchors, problem.point_weights, problem.nodes,
            tt(R), tt(t))
    proj = GN.projection(problem, GN.GNConfig(**TWO_D))
    M, b, sq = torch.zeros((6 * n, 6 * n)), torch.zeros(6 * n), \
        torch.zeros(())
    point_term_accumulate_torch(*args, 1.3, M, b, sq, proj)
    Me, be, sqe = emulate_point_kernel_2d(
        *(np.asarray(x, np.float64) if x.dtype.is_floating_point
          else x.numpy().astype(np.int64) for x in args), 1.3, proj)
    np.testing.assert_allclose(M.numpy(), Me, atol=REL * np.abs(Me).max())
    np.testing.assert_allclose(b.numpy(), be, atol=REL * np.abs(be).max())
    np.testing.assert_allclose(float(sq), sqe, rtol=REL)


@pytest.mark.parametrize("case", ["point3d", "2d_depth"])
def test_diag_blocks_match_jax(case):
    problem = _problem(case)
    R, t = random_pose_field(problem.nodes.shape[0], 2, rot=0.1, trans=0.02)
    cfg_j, cfg = _configs(case, w_point=1.3, w_arap=2.2, w_motion=0.7)
    ref = np.asarray(diag_blocks_j(problem, config=cfg_j, R=jnp.asarray(R),
                                   t=jnp.asarray(t)))
    got = GND.diag_blocks(gn_problem_to_torch(problem), cfg, tt(R), tt(t))
    np.testing.assert_allclose(got.numpy(), ref, atol=REL * np.abs(ref).max())


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    J = rng.randn(2 * n, n).astype(np.float32)
    return (J.T @ J / n + 0.1 * np.eye(n, dtype=np.float32)).astype(
        np.float32)


@pytest.mark.parametrize("n,leaf", [(60, 24), (300, 96), (90, 13),
                                    (48, 96)])
def test_schur_inverse_matches_jax(n, leaf):
    """Including a size off the 6-dof split rounding (90) and a matrix
    that is its own leaf (48 <= 96)."""
    M = _spd(n, n)
    got = BS.spd_schur_inverse(tt(M), leaf).numpy()
    ref = np.asarray(schur_inverse_j(jnp.asarray(M), leaf=leaf))
    assert np.abs(got @ M - np.eye(n)).max() < 5e-3
    np.testing.assert_allclose(got, ref, atol=5e-4 * np.abs(ref).max())
    rhs = np.random.RandomState(1).randn(n).astype(np.float32)
    np.testing.assert_allclose(
        BS.spd_schur_solve(tt(M), tt(rhs), leaf).numpy(),
        np.asarray(schur_solve_j(jnp.asarray(M), jnp.asarray(rhs),
                                 leaf=leaf)), atol=1e-4)


@pytest.mark.parametrize("n,block", [(60, 24), (90, 96), (300, 96)])
def test_newton_schulz_inverse_matches_jax(n, block):
    M = _spd(n, n + 1)
    assert BS._block_size(n, block) == BSJ._block_size(n, block)
    got = BS.newton_schulz_inverse(tt(M), block, 14).numpy()
    ref = np.asarray(ns_inverse_j(jnp.asarray(M), block=block, iters=14))
    assert np.abs(got @ M - np.eye(n)).max() < 5e-3
    np.testing.assert_allclose(got, ref, atol=5e-4 * np.abs(ref).max())
    rhs = np.random.RandomState(2).randn(n).astype(np.float32)
    np.testing.assert_allclose(
        BS.newton_schulz_solve(tt(M), tt(rhs), block, 14).numpy(),
        np.asarray(ns_solve_j(jnp.asarray(M), jnp.asarray(rhs),
                              block=block, iters=14)),
        atol=1e-4)


def test_block_size_rule():
    for n in (6, 60, 90, 180, 3072, 35, 97):
        for target in (24, 48, 96):
            assert BS._block_size(n, target) == BSJ._block_size(n, target)


@pytest.fixture(scope="module")
def dense_runs():
    """(case, solver) -> (port result, JAX result or None, problem) of
    solve_dense, 6 iterations from a random pose field (the port's
    Cholesky against JAX's: tests/test_torch_gn_assembly.py)."""
    out = {}
    for case in ("point3d", "2d_depth"):
        problem = _problem(case)
        pt = gn_problem_to_torch(problem)
        R, t = (np.array(x) for x in random_pose_field(
            problem.nodes.shape[0], 7, rot=0.05, trans=0.01))
        R[~np.asarray(problem.solve_node_mask)] = np.eye(3)
        t[~np.asarray(problem.solve_node_mask)] = 0.0
        for solver in ("cholesky", "cg", "schur", "ns"):
            kw = dict(iters=6, w_motion=0.5, linear_solver=solver,
                      schur_leaf=48, ns_block=48, step_length=0.9)
            cfg_j, cfg = _configs(case, **kw)
            # the JAX package's own solve: every solver on point3d, ns on
            # 2d_depth (each is one compile of the JAX solve)
            ref = None if solver == "cholesky" or (
                case == "2d_depth" and solver != "ns") else GNDJ.solve_dense(
                problem, cfg_j, jnp.asarray(R), jnp.asarray(t))
            out[case, solver] = (GND.solve_dense(pt, cfg, tt(R), tt(t)),
                                 ref, problem)
    return out


@pytest.mark.parametrize("case", ["point3d", "2d_depth"])
@pytest.mark.parametrize("solver", ["cg", "schur", "ns"])
def test_solve_dense_linear_solver_matches_jax_and_cholesky(dense_runs,
                                                            solver, case):
    got, ref, problem = dense_runs[case, solver]
    chol = dense_runs[case, "cholesky"][0]
    atol = SOLVER_ATOL[solver]
    assert bool(got.valid) and bool(chol.valid)
    np.testing.assert_allclose(got.translations.numpy(),
                               chol.translations.numpy(), atol=atol)
    if ref is not None:
        assert bool(ref.valid)
        np.testing.assert_allclose(got.translations.numpy(),
                                   np.asarray(ref.translations), atol=atol)
        np.testing.assert_allclose(got.residual_history.numpy(),
                                   np.asarray(ref.residual_history),
                                   rtol=1e-3)
    frozen = ~np.asarray(problem.solve_node_mask)
    assert np.abs(got.translations.numpy()[frozen]).max() < 1e-7


def test_preconditioned_gn_cg_matches_jax():
    """With the 2d_depth rows (point3d: tests/test_torch_keyframe_units.py
    ::test_gn_solve_rejects_the_preconditioner)."""
    case = "2d_depth"
    problem = _problem(case)
    n = problem.nodes.shape[0]
    R, t = (np.array(x) for x in random_pose_field(n, 8, rot=0.05,
                                                   trans=0.01))
    frozen = ~np.asarray(problem.solve_node_mask)
    R[frozen], t[frozen] = np.eye(3), 0.0
    kw = dict(iters=4, cg_iters=16, w_motion=0.5, precondition=True,
              step_length=0.8)
    cfg_j, cfg = _configs(case, **kw)
    ref = GNJ.solve(problem, cfg_j, jnp.asarray(R), jnp.asarray(t))
    got = GN.solve(gn_problem_to_torch(problem), cfg, tt(R), tt(t))
    assert bool(got.valid) and bool(ref.valid)
    np.testing.assert_allclose(got.translations.numpy(),
                               np.asarray(ref.translations), atol=3e-4)
    np.testing.assert_allclose(got.residual_history.numpy(),
                               np.asarray(ref.residual_history), rtol=1e-3)
