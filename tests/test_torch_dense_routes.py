"""The JAX configuration routes the port used to refuse, against the JAX
package on the same inputs: the dense skin of the voxel warp
(``precompute_dense_skin`` bit for bit, ``lbs_warp_dense`` within 1e-5
relative), the compact-pair scatter plan (its three outputs equal,
overflow included), ``solve_dense`` with ``assembly="dense_j"`` and with
a plan (within ``tests/test_gn_assembly.py``'s 5e-5 relative of JAX's
systems and 1e-4 m of its solves), and the routing of ``lbs_impl``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occlusionfusion_tpu.fusion.warpfield import WarpFieldState as WJ
from occlusionfusion_tpu.ops import lbs as LJ
from occlusionfusion_tpu.solvers import gauss_newton as GNJ
from occlusionfusion_tpu.solvers import gauss_newton_dense as GNDJ
from occlusionfusion_tpu_torch.fusion import fused_step as FS
from occlusionfusion_tpu_torch.fusion.warpfield import WarpFieldState
from occlusionfusion_tpu_torch.ops import lbs as L
from occlusionfusion_tpu_torch.solvers import gauss_newton as GN
from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND
from test_gauss_newton import build_problem
from torch_port_impl import (  # noqa: F401 (one_torch_thread: autouse)
    gn_problem_to_torch,
    jax_run_once,
    one_torch_thread,
    random_pose_field,
    tt,
)

REL = 5e-5  # tests/test_gn_assembly.py:46-52


def _skin_inputs(P=3000, n=70, seed=0):
    """A skin table with repeated anchors in some rows, anchors past the
    node count in others, and invalid rows; a random warp field."""
    rng = np.random.RandomState(seed)
    anchors = rng.randint(0, n, size=(P, 4)).astype(np.int32)
    anchors[::7, 1] = anchors[::7, 0]
    weights = rng.rand(P, 4).astype(np.float32)
    weights /= weights.sum(1, keepdims=True)
    valid = rng.rand(P) > 0.2
    points = rng.randn(P, 3).astype(np.float32) * 0.3
    nodes = rng.randn(n, 3).astype(np.float32) * 0.3
    R, t = (np.array(x) for x in random_pose_field(n, seed + 1))
    return points, anchors, weights, valid, nodes, R, t


def test_dense_skin_is_jax_bit_for_bit():
    _, a, w, v, _, _, _ = _skin_inputs()
    ref = jax_run_once(lambda a, w, v: LJ.precompute_dense_skin(
        a, w, v, n_nodes=70), jnp.asarray(a), jnp.asarray(w), jnp.asarray(v))
    got = L.precompute_dense_skin(tt(a), tt(w), tt(v), 70, rows=1000)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == (3000, 128)
        np.testing.assert_array_equal(
            g.view(torch.int16).numpy(),
            np.asarray(r).view(np.int16))
    assert L.dense_skin_bytes(3000, 70) == LJ.dense_skin_bytes(3000, 70) \
        == got.s_hi.numel() * 4


def test_lbs_warp_dense_matches_jax_and_the_twin():
    p, a, w, v, g, R, t = _skin_inputs()
    skin_j = LJ.precompute_dense_skin(jnp.asarray(a), jnp.asarray(w),
                                      jnp.asarray(v), n_nodes=70)
    state_j = WJ(jnp.asarray(g), jnp.ones(70, bool), jnp.asarray(R),
                 jnp.asarray(t))
    ref = np.asarray(jax_run_once(LJ.lbs_warp_dense, jnp.asarray(p),
                                  jnp.asarray(v), skin_j, state_j))
    state = WarpFieldState(tt(g), torch.ones(70, dtype=torch.bool), tt(R),
                           tt(t))
    skin = L.precompute_dense_skin(tt(a), tt(w), tt(v), 70)
    got = L.lbs_warp_dense(tt(p), tt(v), skin, state).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)
    twin = L.lbs_warp_torch(tt(p), tt(a), tt(w), tt(v), state).numpy()
    np.testing.assert_allclose(got, twin, atol=1e-5 * scale)
    np.testing.assert_array_equal(got[~v], p[~v])


def _problem(seed=4):
    """tests/test_gauss_newton.py's sphere with fractional point weights,
    a motion prior and a quarter of the nodes frozen."""
    problem, _, _ = build_problem(n_pts=300, n_nodes=30, seed=seed)
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


@pytest.mark.parametrize("u_cap", [0, 40])
def test_pair_scatter_plan_equals_jax(u_cap):
    problem = _problem()
    n = problem.nodes.shape[0]
    ref = GNDJ.build_pair_scatter_plan(problem.point_anchors, problem.edges,
                                       n=n, u_cap=u_cap)
    pt = gn_problem_to_torch(problem)
    got = GND.build_pair_scatter_plan(pt.point_anchors, pt.edges, n,
                                      u_cap=u_cap)
    np.testing.assert_array_equal(
        GND.pair_segment_ids(pt.point_anchors, pt.edges, n).numpy(),
        np.asarray(GNDJ.pair_segment_ids(problem.point_anchors,
                                         problem.edges, n)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert bool(got.overflow) == (u_cap == 40)


def _systems(problem, cfg_j, R, t, plan_j=None):
    """JAX's (M, b, sq): _assemble for dense_j, _assemble_blocks with the
    plan otherwise."""
    if cfg_j.assembly == "dense_j":
        return jax_run_once(lambda p, R, t: GNDJ._assemble(p, cfg_j, R, t),
                            problem, R, t)
    return jax_run_once(lambda p, R, t, pl: GNDJ._assemble_blocks(
        p, cfg_j, R, t, plan=pl), problem, R, t, plan_j)


@pytest.mark.parametrize("route", ["dense_j", "plan", "plan_overflow"])
def test_system_and_solve_match_jax(route):
    problem = _problem()
    n = problem.nodes.shape[0]
    pt = gn_problem_to_torch(problem)
    R, t = (np.array(x) for x in random_pose_field(n, 7, rot=0.05,
                                                   trans=0.01))
    kw = dict(iters=4, w_point=1.7, w_arap=2.1, w_motion=0.5)
    asm = "dense_j" if route == "dense_j" else "blocks"
    cfg_j, cfg = GNJ.GNConfig(assembly=asm, **kw), GN.GNConfig(
        assembly=asm, **kw)
    u_cap = 40 if route == "plan_overflow" else 0
    plan_j = plan = None
    if route != "dense_j":
        plan_j = GNDJ.build_pair_scatter_plan(
            problem.point_anchors, problem.edges, n=n, u_cap=u_cap)
        plan = GND.build_pair_scatter_plan(pt.point_anchors, pt.edges, n,
                                           u_cap=u_cap)
    Mj, bj, sqj = (np.asarray(x) for x in _systems(
        problem, cfg_j, jnp.asarray(R), jnp.asarray(t), plan_j))
    M = torch.zeros((6 * n, 6 * n))
    b = torch.zeros(6 * n)
    sq = torch.zeros(())
    GND._add_terms(pt, cfg, GND._fixed_terms(pt, cfg), tt(R), tt(t), M, b,
                   sq, plan)
    np.testing.assert_allclose(M.numpy(), Mj, atol=REL * np.abs(Mj).max())
    np.testing.assert_allclose(b.numpy(), bj, atol=REL * np.abs(bj).max())
    np.testing.assert_allclose(float(sq), float(sqj), rtol=REL)
    ref = jax_run_once(lambda p, R, t, pl: GNDJ.solve_dense(
        p, cfg_j, R, t, scatter_plan=pl), problem, jnp.asarray(R),
        jnp.asarray(t), plan_j)
    got = GND.solve_dense(pt, cfg, tt(R), tt(t), scatter_plan=plan)
    assert bool(got.valid) and bool(ref.valid)
    np.testing.assert_allclose(got.translations.numpy(),
                               np.asarray(ref.translations), atol=1e-4)
    np.testing.assert_allclose(got.residual_history.numpy(),
                               np.asarray(ref.residual_history), rtol=1e-3)


def test_dense_j_gradient_matches_the_block_route():
    """dense_j is plain torch ops, so autograd differentiates it; its
    gradient of the solved translations equals the block route's (the
    twins' vector-Jacobian products)."""
    pt = gn_problem_to_torch(_problem())
    n = pt.nodes.shape[0]
    R, t = (tt(x) for x in random_pose_field(n, 7, rot=0.05, trans=0.01))
    grads = []
    for asm in ("dense_j", "blocks"):
        targets = pt.target_points.clone().requires_grad_(True)
        res = GND.solve_dense(pt._replace(target_points=targets),
                              GN.GNConfig(iters=2, w_motion=0.5,
                                          assembly=asm), R, t)
        (g,) = torch.autograd.grad(res.translations.sum(), targets)
        grads.append((res.translations.detach(), g))
    np.testing.assert_allclose(grads[0][0].numpy(), grads[1][0].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(),
                               atol=1e-4 * float(grads[1][1].abs().max()))


def test_unknown_assembly_and_lbs_impl_raise():
    pt = gn_problem_to_torch(_problem())
    n = pt.nodes.shape[0]
    R, t = (tt(x) for x in random_pose_field(n, 7))
    with pytest.raises(ValueError, match="assembly"):
        GND.solve_dense(pt, GN.GNConfig(assembly="sparse"), R, t)
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig

    with pytest.raises(ValueError, match="assembly"):
        FusionConfig(gn=GN.GNConfig(assembly="sparse"))
    with pytest.raises(ValueError, match="lbs_impl"):
        FusionConfig(lbs_impl="gather")
    assert {a: FusionConfig(gn=GN.GNConfig(assembly=a)).gn.assembly
            for a in GN.ASSEMBLIES} == {a: a for a in GN.ASSEMBLIES}


@pytest.fixture(scope="module")
def fused():
    """A dense 24^3 volume with lbs_impl "dense" (its skin built) and
    "auto" (none), from one initialize of a 48x48 sphere."""
    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.fusion.pipeline import (
        DynamicFusion,
        FusionConfig,
    )
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig

    h = w = 48
    intr = Intrinsics(110.0, 110.0, 24.0, 24.0)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([(u - 24) / 110.0, (v - 24) / 110.0, np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = np.array([0.0, 0.0, 0.6])
    bb = d @ c
    disc = bb * bb - (c @ c - 0.1**2)
    tt_ = bb - np.sqrt(np.maximum(disc, 0))
    depth = np.where((disc > 0) & (tt_ > 0), tt_ * d[..., 2], 0).astype(
        np.float32)
    seq = ArraySequence([np.full((h, w, 3), 100.0, np.float32)] * 2,
                        [depth, depth], intr)
    cfg = FusionConfig(vol_dim=(24, 24, 24), voxel_size=0.012,
                       node_coverage=0.04, max_nodes=64, max_points=512,
                       graph=GraphConfig(node_coverage=0.04), solver="gn_dense",
                       lbs_impl="dense")
    f = DynamicFusion(seq, cfg, device="cpu")
    f.initialize(seq.load(0))
    sc, state, tables = f.build_fused()
    small = dataclasses.replace(cfg, dense_skin_max_bytes=1000)
    f.config = small
    _, _, no_fit = f.build_fused()
    f.config = dataclasses.replace(cfg, lbs_impl="auto")
    sc_auto, _, auto = f.build_fused()
    f.config = cfg
    return f, sc, state, tables, no_fit, sc_auto, auto


def test_build_fused_makes_the_skin_where_dense_fits(fused):
    f, sc, _, tables, no_fit, sc_auto, auto = fused
    assert sc.lbs_impl == "dense" and sc_auto.lbs_impl == "auto"
    V = f.vox_points.shape[0]
    assert tables.vox_dense_hi.shape == (V, 128)
    assert tables.gn_scatter_plan is None
    ref = L.precompute_dense_skin(f.vox_table.anchors, f.vox_table.weights,
                                  f.vox_table.valid, 64)
    assert torch.equal(tables.vox_dense_hi, ref.s_hi)
    assert torch.equal(tables.vox_dense_lo, ref.s_lo)
    assert no_fit.vox_dense_hi is None and auto.vox_dense_hi is None


def test_lbs_impl_routes(fused, monkeypatch):
    _, sc, state, tables, no_fit, _, auto = fused
    calls = []

    def counting(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(FS, name, wrapped)

    counting("lbs_warp", FS.lbs_warp)
    counting("lbs_warp_dense", FS.lbs_warp_dense)
    n = tables.nodes.shape[0]
    R, t = (tt(x) for x in random_pose_field(n, 3, rot=0.05, trans=0.01))
    warp = WarpFieldState(tables.nodes, tables.node_valid, R, t)
    routes = {}
    for impl, tab in (("dense", tables), ("auto", tables), ("auto", auto),
                      ("pallas", tables), ("xla", tables)):
        calls.clear()
        out = FS.warp_voxels(sc._replace(lbs_impl=impl), tab, warp)
        routes[impl, tab is tables] = (calls[-1], out)
    assert {k: v[0] for k, v in routes.items()} == {
        ("dense", True): "lbs_warp_dense", ("auto", True): "lbs_warp_dense",
        ("auto", False): "lbs_warp", ("pallas", True): "lbs_warp",
        ("xla", True): "lbs_warp"}
    dense, gather = routes["dense", True][1], routes["xla", True][1]
    np.testing.assert_allclose(dense.numpy(), gather.numpy(),
                               atol=1e-5 * float(gather.abs().max()))
    with pytest.raises(ValueError, match="dense skin"):
        FS.warp_voxels(sc, no_fit, warp)
