"""The port's N-ICP cost terms and solver (occlusionfusion_tpu_torch/
solvers/{losses,nicp}.py) against the JAX package's on the same numpy
inputs, on the CPU.

Tolerances: each cost term within 1e-6 relative (f32 sums of a few
hundred terms in another order); the solve's loss history within 1e-5
relative and its final R and t within 2e-5 after 20 Adam steps (the two
autodiffs sum the same gradients in another order, and Adam's
normalised step carries that rounding into every parameter)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occlusionfusion_tpu.geometry.skinning import skinning_weights
from occlusionfusion_tpu.geometry.so3 import so3_exp as so3_exp_j
from occlusionfusion_tpu.ops.knn import knn_lax
from occlusionfusion_tpu.solvers import losses as LJ
from occlusionfusion_tpu.solvers import nicp as NJ
from occlusionfusion_tpu_torch.solvers import losses as LT
from occlusionfusion_tpu_torch.solvers import nicp as NT
from torch_port_impl import (  # noqa: F401
    jax_chamfer_table,
    one_torch_thread,
    random_pose_field,
    tt,
)

COST_RTOL = 1e-6
LOSS_RTOL = 1e-5
RT_ATOL = 2e-5


def build_problem(seed=0, n_pts=300, n_nodes=30, pad_nodes=6, pad_pts=20):
    """A sphere of points under a rigid motion plus noise, n_nodes nodes
    with pad_nodes padded (invalid, no edges, no anchors) and pad_pts
    padded points; fractional landmark weights (some 0); a motion prior
    with fractional confidence. Returns the JAX NICPProblem (numpy
    leaves)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n_pts, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = (v * 0.5).astype(np.float32)
    nodes = pts[rng.choice(n_pts, n_nodes, replace=False)]
    coverage = 0.25
    anchors, weights, valid = skinning_weights(
        jnp.asarray(pts), jnp.asarray(nodes), None, coverage, k=4)
    d2, idx = knn_lax(jnp.asarray(nodes), jnp.asarray(nodes), k=7)
    edges = np.asarray(idx[:, 1:]).astype(np.int32)
    ew = np.exp(-np.asarray(d2[:, 1:]) / (2 * coverage ** 2))
    ew = (ew / ew.sum(1, keepdims=True)).astype(np.float32)
    edges[rng.rand(*edges.shape) < 0.15] = -1  # padded edge slots
    ew[edges < 0] = 0.0
    R = np.asarray(so3_exp_j(jnp.asarray([0.2, -0.1, 0.25])))
    target = (pts @ R.T + np.asarray([0.04, -0.02, 0.06])
              + rng.randn(n_pts, 3) * 0.003).astype(np.float32)
    N, P = n_nodes + pad_nodes, n_pts + pad_pts

    def pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    lw = rng.rand(n_pts).astype(np.float32)
    lw[lw < 0.3] = 0.0
    node_t = (nodes @ R.T - nodes + 0.05).astype(np.float32)
    return NJ.NICPProblem(
        source_points=pad(pts, P), point_anchors=pad(np.asarray(anchors), P),
        point_weights=pad(np.asarray(weights), P),
        point_valid=pad(np.asarray(valid), P, False),
        nodes=pad(nodes, N), node_valid=pad(np.ones(n_nodes, bool), N, False),
        edges=pad(edges, N, -1), edge_weights=pad(ew, N),
        target_points=pad(target, P), landmark_src=np.arange(P),
        landmark_tgt=np.arange(P), landmark_valid=pad(lw, P),
        motion_targets=pad(nodes + node_t, N),
        motion_confidence=pad(rng.rand(n_nodes).astype(np.float32), N),
    )


def to_torch(problem):
    return NT.NICPProblem(**{
        k: None if getattr(problem, k) is None else tt(getattr(problem, k))
        for k in NT.NICPProblem._fields})


def assert_cost(got, ref):
    np.testing.assert_allclose(float(got), float(ref), rtol=COST_RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_arap_cost_matches_jax(seed):
    p = build_problem(seed)
    R, t = random_pose_field(p.nodes.shape[0], seed + 10)
    ref = LJ.arap_cost(jnp.asarray(R), jnp.asarray(t), p.nodes, p.edges,
                       p.edge_weights)
    got = LT.arap_cost(tt(R), tt(t), tt(p.nodes), tt(p.edges),
                       tt(p.edge_weights))
    assert_cost(got, ref)


@pytest.mark.parametrize("mask", ["none", "bool", "float"])
def test_landmark_cost_matches_jax(mask):
    p = build_problem(2)
    rng = np.random.RandomState(3)
    warped = (p.source_points + rng.randn(*p.source_points.shape) * 0.01
              ).astype(np.float32)
    m = {"none": None, "bool": p.landmark_valid > 0,
         "float": p.landmark_valid}[mask]
    ref = LJ.landmark_cost(warped, p.target_points, p.landmark_src,
                           p.landmark_tgt, None if m is None else jnp.asarray(m))
    got = LT.landmark_cost(tt(warped), tt(p.target_points), tt(p.landmark_src),
                           tt(p.landmark_tgt), None if m is None else tt(m))
    assert_cost(got, ref)


@pytest.mark.parametrize("with_valid", [True, False])
def test_motion_cost_matches_jax(with_valid):
    p = build_problem(4)
    _, t = random_pose_field(p.nodes.shape[0], 5)
    nv = p.node_valid if with_valid else None
    ref = LJ.motion_cost(p.nodes, jnp.asarray(t), p.motion_targets,
                         p.motion_confidence, nv)
    got = LT.motion_cost(tt(p.nodes), tt(t), tt(p.motion_targets),
                         tt(p.motion_confidence),
                         None if nv is None else tt(nv))
    assert_cost(got, ref)


def test_smoothness_cost_matches_jax():
    rng = np.random.RandomState(6)
    a, b = rng.randn(2, 40, 3).astype(np.float32)
    assert_cost(LT.smoothness_cost(tt(a), tt(b)),
                LJ.smoothness_cost(jnp.asarray(a), jnp.asarray(b)))


def _solve_both(problem, cfg, warm):
    init = (None, None)
    if warm:
        R, t = random_pose_field(problem.nodes.shape[0], 7, rot=0.1,
                                 trans=0.02)
        init = (R, t)
    ref = NJ.solve(jax_problem(problem), NJ.NICPConfig(**cfg._asdict()),
                   *(None if x is None else jnp.asarray(x) for x in init))
    got = NT.solve(to_torch(problem), cfg,
                   *(None if x is None else tt(x) for x in init))
    return ref, got


def jax_problem(problem):
    return NJ.NICPProblem(*(None if x is None else jnp.asarray(x)
                            for x in problem))


def assert_result(ref, got):
    np.testing.assert_allclose(got.loss_history.numpy(),
                               np.asarray(ref.loss_history), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got.final_loss), float(ref.final_loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.rotations.numpy(),
                               np.asarray(ref.rotations), atol=RT_ATOL)
    np.testing.assert_allclose(got.translations.numpy(),
                               np.asarray(ref.translations), atol=RT_ATOL)
    np.testing.assert_allclose(got.warped_points.numpy(),
                               np.asarray(ref.warped_points), atol=RT_ATOL)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solve_matches_jax(warm):
    """20 Adam steps with every term on, padded nodes and points."""
    problem = build_problem(8)
    ref, got = _solve_both(problem, NT.NICPConfig(iters=20), warm)
    assert_result(ref, got)
    # padded nodes come back as the identity, padded points unmoved
    pad = ~problem.node_valid
    assert np.all(got.rotations.numpy()[pad] == np.eye(3, dtype=np.float32))
    assert np.all(got.translations.numpy()[pad] == 0)
    pv = ~problem.point_valid
    assert np.array_equal(got.warped_points.numpy()[pv],
                          problem.source_points[pv])


def test_solve_early_stop_freezes_like_jax():
    """A threshold the loss crosses mid-solve: the parameters and the
    optimiser state freeze from that step on, in both."""
    problem = build_problem(9)
    full = NT.solve(to_torch(problem), NT.NICPConfig(iters=20))
    hist = full.loss_history.numpy()
    thr = float(hist[8])  # crossed at step 9 at the latest
    cfg = NT.NICPConfig(iters=20, early_stop_loss=thr * 1.0001)
    ref, got = _solve_both(problem, cfg, warm=False)
    assert_result(ref, got)
    h = got.loss_history.numpy()
    first = int(np.argmax(h < cfg.early_stop_loss))
    assert 0 < first < 19
    assert np.all(h[first + 1:] == h[first + 1])


@pytest.mark.parametrize("name", ["w_chamfer", "w_silh", "w_depth"])
def test_unported_terms_raise(name):
    """The three weights no longer raise: each solve matches the JAX
    package's, the chamfer on JAX's own subsamples, the rendered costs on
    a problem without a target depth, as the fusion paths build it, where
    both packages skip them (ROADMAP F14). The chamfer is truncated at
    0.2 m^2: the padded targets sit at the origin, the centre of this
    problem's sphere of radius 0.5 m, where every source point is a near
    tie at 0.25 m^2 and the JAX package's own gradient differs between
    its eager and its compiled program."""
    problem = build_problem(0)
    cfg = NT.NICPConfig(iters=10, chamfer_trunc=0.2, **{name: 1.0})
    P = problem.source_points.shape[0]
    table = (tt(jax_chamfer_table(cfg.iters, cfg.chamfer_samples, P, P))
             if name == "w_chamfer" else None)
    ref = NJ.solve(jax_problem(problem), cfg)
    got = NT.solve(to_torch(problem), cfg, chamfer_table=table)
    assert_result(ref, got)


def test_config_defaults_match_jax():
    assert NT.NICPConfig()._asdict() == NJ.NICPConfig()._asdict()


def test_solve_under_no_grad_returns_detached():
    """The fused step runs under torch.no_grad(): the solve must still
    differentiate its objective, and hand back tensors with no graph."""
    problem = to_torch(build_problem(1))
    with torch.no_grad():
        res = NT.solve(problem, NT.NICPConfig(iters=3))
    assert all(not x.requires_grad for x in res)
    assert float(res.loss_history[-1]) < float(res.loss_history[0])
