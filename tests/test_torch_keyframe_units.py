"""The keyframe machinery's modules of the port against the JAX package on
the CPU, on the same seeded numpy inputs: left_compose_rigid, the brick
remap, the pyramid rebuild (equal arrays), the matrix-free GN-CG solve
with frozen nodes (1e-4), graph growth on tests/test_graph_growth.py's
fixtures (equal ids, edges and weights; R/t 1e-5), the cluster filter
(equal), the rigid alignment of tests/test_pose_graph_in_loop.py's
healthy, lost and feature-seeded cases, the pose graph on
tests/test_pose_graph.py's chains (1e-5), and snapshots in both
directions (same keys, equal arrays)."""

import numpy as np
import pytest

import jax.numpy as jnp

from occlusionfusion_tpu.fusion import bricks as BRJ
from occlusionfusion_tpu.fusion import correspondence as CJ
from occlusionfusion_tpu.fusion import graph_growth as GGJ
from occlusionfusion_tpu.fusion import loop_closure as LCJ
from occlusionfusion_tpu.fusion import pose_graph as PGJ
from occlusionfusion_tpu.fusion import warpfield as WJ
from occlusionfusion_tpu.fusion.tsdf import TSDFState as TSDFStateJ
from occlusionfusion_tpu.graph import edgraph as EGJ
from occlusionfusion_tpu.solvers import gauss_newton as GNJ
from occlusionfusion_tpu.utils import snapshot as SNJ
from occlusionfusion_tpu_torch.fusion import bricks as BR
from occlusionfusion_tpu_torch.fusion import correspondence as C
from occlusionfusion_tpu_torch.fusion import graph_growth as GG
from occlusionfusion_tpu_torch.fusion import loop_closure as LC
from occlusionfusion_tpu_torch.fusion import pose_graph as PG
from occlusionfusion_tpu_torch.fusion import warpfield as W
from occlusionfusion_tpu_torch.fusion.tsdf import TSDFState
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.graph import edgraph as EG
from occlusionfusion_tpu_torch.solvers import gauss_newton as GN
from occlusionfusion_tpu_torch.utils import snapshot as SN
from test_fusion_e2e import make_sequence
from test_gauss_newton import build_problem
from test_graph_growth import base_setup
from test_pose_graph import make_chain
from torch_port_impl import (  # noqa: F401
    gn_problem_to_torch,
    one_torch_thread,
    random_pose_field,
    tt,
)

RT_ATOL = 1e-5


def _warp_t(warp_j):
    return W.WarpFieldState(*(tt(x) for x in warp_j))


def _intr_t(intr):
    return Intrinsics(*(float(x) for x in intr))


def test_left_compose_rigid_matches_jax():
    rng = np.random.RandomState(0)
    n = 40
    nodes = (rng.randn(n, 3) * 0.1).astype(np.float32)
    R, t = random_pose_field(n, seed=1)
    Rg, tg = random_pose_field(1, seed=2, rot=0.5, trans=0.1)
    wj = WJ.WarpFieldState(jnp.asarray(nodes), jnp.ones(n, bool),
                           jnp.asarray(R), jnp.asarray(t))
    got = W.left_compose_rigid(_warp_t(wj), tt(Rg[0]), tt(tg[0]))
    ref = WJ.left_compose_rigid(wj, jnp.asarray(Rg[0]), jnp.asarray(tg[0]))
    np.testing.assert_allclose(got.rotations.numpy(),
                               np.asarray(ref.rotations), atol=1e-6)
    np.testing.assert_allclose(got.translations.numpy(),
                               np.asarray(ref.translations), atol=1e-6)


def test_remap_slots_and_apply_remap_match_jax():
    rng = np.random.RandomState(3)
    MB, B = 16, 4
    old = -np.ones(MB, np.int32)
    old[:10] = np.sort(rng.choice(200, 10, replace=False))
    new = -np.ones(MB, np.int32)
    new[:13] = np.sort(np.union1d(old[:7], rng.choice(200, 6,
                                                      replace=False))[:13])
    perm = BR.remap_slots(old, new)
    np.testing.assert_array_equal(perm, BRJ.remap_slots(old, new))
    assert (perm >= 0).sum() >= 7 and (perm < 0).sum() >= 3
    arrs = dict(tsdf=rng.rand(MB, B, B, B).astype(np.float32),
                weight=rng.rand(MB, B, B, B).astype(np.float32) * 5,
                color=rng.rand(MB, B, B, B, 3).astype(np.float32) * 255,
                origin=np.asarray([0.1, -0.2, 0.5], np.float32))
    got = BR.apply_remap(TSDFState(**{k: tt(v) for k, v in arrs.items()}),
                         perm)
    ref = BRJ.apply_remap(TSDFStateJ(**{k: jnp.asarray(v)
                                        for k, v in arrs.items()}), perm)
    for name in ("tsdf", "weight", "color", "origin"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("n, with_edges", [(1, False), (40, False),
                                           (60, True)])
def test_pyramid_from_nodes_matches_jax(n, with_edges):
    rng = np.random.RandomState(n)
    nodes = (rng.rand(n, 3) * 0.4).astype(np.float32)
    edges = None
    if with_edges:
        edges = -np.ones((n, 8), np.int32)
        edges[:, :3] = rng.randint(0, n, (n, 3))
    got = EG.build_pyramid_from_nodes(nodes, 0.05, edges=edges)
    ref = EGJ.build_pyramid_from_nodes(nodes, 0.05, edges=edges)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _frozen_gn_problem(w_motion):
    problem, _, _ = build_problem(n_pts=300, n_nodes=30, seed=4)
    rng = np.random.RandomState(5)
    frozen = rng.rand(30) < 0.3
    problem = problem._replace(
        solve_node_mask=jnp.asarray(~frozen),
        motion_targets=problem.nodes + jnp.asarray(
            rng.randn(30, 3).astype(np.float32) * 0.02),
        motion_confidence=jnp.asarray(rng.rand(30).astype(np.float32)))
    R0, t0 = random_pose_field(30, seed=6, rot=0.05, trans=0.01)
    return problem, frozen, R0, t0


def _assert_gn_solve_matches_jax(w_motion, **kw):
    problem, frozen, R0, t0 = _frozen_gn_problem(w_motion)
    cfg_j = GNJ.GNConfig(iters=4, cg_iters=24, w_motion=w_motion, **kw)
    cfg_t = GN.GNConfig(iters=4, cg_iters=24, w_motion=w_motion, **kw)
    ref = GNJ.solve(problem, cfg_j, jnp.asarray(R0), jnp.asarray(t0))
    got = GN.solve(gn_problem_to_torch(problem), cfg_t, tt(R0), tt(t0))
    assert bool(got.valid) and bool(ref.valid)
    np.testing.assert_allclose(got.rotations.numpy(),
                               np.asarray(ref.rotations), atol=1e-4)
    np.testing.assert_allclose(got.translations.numpy(),
                               np.asarray(ref.translations), atol=1e-4)
    np.testing.assert_allclose(got.residual_history.numpy(),
                               np.asarray(ref.residual_history), rtol=1e-3)
    # frozen nodes keep their transforms exactly
    np.testing.assert_array_equal(got.translations.numpy()[frozen],
                                  t0[frozen])


@pytest.mark.parametrize("w_motion", [0.0, 0.5])
def test_gn_solve_with_frozen_nodes_matches_jax(w_motion):
    _assert_gn_solve_matches_jax(w_motion)


def test_gn_solve_rejects_the_preconditioner():
    """precondition=True is ported and no longer refused: the
    block-Jacobi PCG with frozen nodes and a step length matches the JAX
    package's as the plain CG does."""
    _assert_gn_solve_matches_jax(0.5, precondition=True, step_length=0.8)


def _growth_points(case):
    if case == "covered":
        return np.asarray([[0.02, 0.0, 0.0]], np.float32)
    n = 5 if case == "line" else 4
    return np.stack([0.25 + np.arange(n) * 0.05, np.zeros(n), np.zeros(n)],
                    -1).astype(np.float32)


@pytest.mark.parametrize("case", ["line", "moving", "covered"])
def test_grow_graph_matches_jax(case):
    warp_j, edges, ew = base_setup()
    if case == "moving":
        t = jnp.broadcast_to(jnp.asarray([0.0, 0.02, 0.0]),
                             warp_j.translations.shape)
        warp_j = WJ.update_transforms(warp_j, warp_j.rotations, t)
    pts = _growth_points(case)
    valid = np.ones(len(pts), bool)
    un_j = GGJ.find_unreachable(jnp.asarray(pts), jnp.asarray(valid),
                                warp_j, 0.05)
    un_t = GG.find_unreachable(tt(pts), tt(valid), _warp_t(warp_j), 0.05)
    np.testing.assert_array_equal(un_t.numpy(), np.asarray(un_j))
    ref = GGJ.grow_graph(warp_j, 4, edges, ew, pts, valid,
                         node_coverage=0.05)
    got = GG.grow_graph(_warp_t(warp_j), 4, tt(edges), tt(ew), pts, valid,
                        node_coverage=0.05)
    assert got.n_new == ref.n_new and got.node_count == ref.node_count
    assert (got.n_new > 0) == (case != "covered")
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(ref.edges))
    np.testing.assert_array_equal(got.edge_weights.numpy(),
                                  np.asarray(ref.edge_weights))
    np.testing.assert_array_equal(got.warp.node_positions.numpy(),
                                  np.asarray(ref.warp.node_positions))
    np.testing.assert_array_equal(got.warp.node_valid.numpy(),
                                  np.asarray(ref.warp.node_valid))
    np.testing.assert_allclose(got.warp.rotations.numpy(),
                               np.asarray(ref.warp.rotations), atol=RT_ATOL)
    np.testing.assert_allclose(got.warp.translations.numpy(),
                               np.asarray(ref.warp.translations),
                               atol=RT_ATOL)


@pytest.mark.parametrize("threshold", [0.0, 3.0, 40.0])
def test_cluster_match_filter_matches_jax(threshold):
    rng = np.random.RandomState(7)
    P, N, K = 500, 64, 4
    anchors = rng.randint(0, 48, (P, K)).astype(np.int32)
    anchors[::17, 3] = -1
    weights = rng.rand(P, K).astype(np.float32)
    weights /= weights.sum(1, keepdims=True)
    corr = (rng.rand(P) * (rng.rand(P) > 0.3)).astype(np.float32)
    clusters = -np.ones(N, np.int32)
    clusters[:48] = np.repeat(np.arange(6), 8)
    corr[(np.isin(anchors, np.arange(16, 24))).any(1)] *= 0.01
    valid = clusters >= 0
    ref = CJ.cluster_match_filter(*(jnp.asarray(a) for a in (
        anchors, weights, corr, clusters, valid)), threshold)
    got = C.cluster_match_filter(*(tt(a) for a in (
        anchors, weights, corr, clusters, valid)), threshold)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    if threshold == 3.0:
        assert 0 < int(got[0].sum()) < 48


def _alignment_input(offset):
    seq, _ = make_sequence(n_frames=1, step=(0.0, 0.0, 0.0))
    frame = seq.load(0)
    v, u = np.nonzero(frame.depth > 0)
    d = frame.depth[v, u]
    i = seq.intrinsics
    pts = np.stack([(u - float(i.cx)) / float(i.fx) * d,
                    (v - float(i.cy)) / float(i.fy) * d, d],
                   -1).astype(np.float32)[::7]
    return pts + np.asarray(offset, np.float32), frame.depth, i


ALIGN_CASES = {
    "healthy": ([0.003, -0.002, 0.009], dict()),
    "lost_coarse": ([0.15, -0.08, 0.12], dict(coarse_init=True)),
    "lost_blind": ([0.15, -0.08, 0.12], dict(coarse_init=False)),
    "feat_init": ([0.15, -0.08, 0.12], dict(feat=True)),
    "healthy_garbage_feat": ([0.003, 0.0, 0.006], dict(flip=True)),
}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_rigid_depth_alignment_matches_jax(case):
    offset, opts = ALIGN_CASES[case]
    pts, depth, intr = _alignment_input(offset)
    kw = dict(iters=8, max_depth_diff=0.05,
              coarse_init=opts.get("coarse_init", True))
    feat = None
    if opts.get("feat"):
        feat = (np.eye(3, dtype=np.float32),
                -np.asarray(offset, np.float32))
    if opts.get("flip"):
        feat = (np.diag([1.0, -1.0, -1.0]).astype(np.float32),
                np.zeros(3, np.float32))
    valid = np.ones(len(pts), bool)
    ref = LCJ.rigid_depth_alignment(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(depth), intr,
        feat_init=None if feat is None else tuple(map(jnp.asarray, feat)),
        **kw)
    got = LC.rigid_depth_alignment(
        tt(pts), tt(valid), tt(depth), _intr_t(intr),
        feat_init=None if feat is None else tuple(map(tt, feat)), **kw)
    for name in ("rotation", "translation", "residual", "initial_residual"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=RT_ATOL, err_msg=name)
    for name in ("inlier_fraction", "initial_inlier_fraction"):
        assert float(getattr(got, name)) == float(getattr(ref, name)), name
    if case != "lost_blind":
        assert float(got.inlier_fraction) > 0.8


def _pose_graph_t(graph_j):
    return PG.PoseGraph(*(tt(x) for x in graph_j))


@pytest.mark.parametrize("drift", [0.0, 0.02])
def test_optimize_pose_graph_matches_jax(drift):
    graph, _, _ = make_chain(drift=drift)
    ref = PGJ.optimize_pose_graph(graph, iters=5)
    got = PG.optimize_pose_graph(_pose_graph_t(graph), iters=5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=RT_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=RT_ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-3, atol=1e-9)


def test_pose_graph_residuals_match_jax():
    graph, _, _ = make_chain(drift=0.02, seed=3)
    xi = np.random.RandomState(1).randn(6, 6).astype(np.float32) * 0.01
    np.testing.assert_allclose(
        PG._edge_residuals(tt(xi), _pose_graph_t(graph)).numpy(),
        np.asarray(PGJ._edge_residuals(jnp.asarray(xi), graph)), atol=1e-6)


def _snapshot_tree(lib):
    rng = np.random.RandomState(9)
    a = rng.rand(4, 3).astype(np.float32)
    b = rng.randint(0, 9, 5).astype(np.int32)
    if lib == "jax":
        state = TSDFStateJ(*(jnp.asarray(x) for x in (a, a, a[..., None], b)))
        return {"tsdf": dict(state._asdict()), "z": jnp.asarray(b),
                "count": np.asarray(3, np.int32),
                "nested": {"b": jnp.asarray(a), "a": {"c": jnp.asarray(b)}},
                "none": None}
    state = TSDFState(*(tt(x) for x in (a, a, a[..., None], b)))
    return {"tsdf": dict(state._asdict()), "z": tt(b),
            "count": np.asarray(3, np.int32),
            "nested": {"b": tt(a), "a": {"c": tt(b)}}, "none": None}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_load_in_the_other_package(tmp_path, writer):
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    SNJ.save_pytree(pj, _snapshot_tree("jax"))
    SN.save_pytree(pt, _snapshot_tree("port"))
    fj, ft = SNJ.load_flat(pj), SN.load_flat(pt)
    assert list(fj) == list(ft)
    for k in fj:
        assert fj[k].dtype == ft[k].dtype, k
        np.testing.assert_array_equal(fj[k], ft[k])
    src = pj if writer == "jax" else pt
    got, ref = SN.load_params(src), SNJ.load_params(src)

    def same(x, y):
        if isinstance(y, dict):
            assert isinstance(x, dict) and x.keys() == y.keys()
            for k in y:
                same(x[k], y[k])
        else:
            np.testing.assert_array_equal(x, y)

    same(got, ref)
    assert got["nested"]["a"]["c"].dtype == np.int32


def test_snapshot_manager_is_time_gated(tmp_path):
    m = SN.SnapshotManager(str(tmp_path / "snaps"), min_interval_s=1e6)
    assert m.maybe_save("a", {"x": np.zeros(2)})
    assert not m.maybe_save("b", {"x": np.zeros(2)})
    assert m.maybe_save("c", {"x": np.zeros(2)}, force=True)
    assert sorted(p.name for p in (tmp_path / "snaps").iterdir()) == [
        "a.npz", "c.npz"]
