"""The port's whole slice against the JAX package: DynamicFusion.run_fused
on the deforming sphere of tests/test_fusion_e2e.py (its small config,
switched to solver="gn_dense", a dense volume and the motion GNN with
the repo's checkpoint), 4 frames. Compared: the per-frame info vectors,
the node transforms (1e-4), the TSDF volume and get_deformed_mesh (faces
exactly, vertices 1e-4 m as the transforms)."""

import dataclasses

import numpy as np
import pytest

from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.models.checkpoint import load_motion_complete_params
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
from occlusionfusion_tpu_torch.models.checkpoint import (
    load_motion_complete_net,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from test_fusion_e2e import INTR, make_sequence, small_config
from torch_port_impl import one_torch_thread  # noqa: F401

# the GN weights the JAX package derives from this config's N-ICP weights
# (6 iterations, w_point 1, w_arap 10), with the motion prior switched on
# so that the motion GNN's output enters the solve
GN = dict(iters=6, w_point=1.0, w_arap=10.0, w_motion=1.0)


@pytest.fixture(scope="module")
def runs():
    seq_j, centers = make_sequence(n_frames=4)
    cfg_j = dataclasses.replace(
        small_config(), solver="gn_dense", brick_size=0,
        use_motion_model=True,
        gn=GNConfigJ(linear_solver="cholesky", assembly="blocks", **GN),
    )
    fj = DynamicFusionJ(seq_j, cfg_j)
    infos_j = fj.run_fused(motion_params=load_motion_complete_params())

    base = small_config()
    cfg = FusionConfig(
        vol_dim=base.vol_dim, voxel_size=base.voxel_size,
        node_coverage=base.node_coverage, max_nodes=base.max_nodes,
        max_points=base.max_points, max_depth_diff=base.max_depth_diff,
        graph=GraphConfig(node_coverage=base.graph.node_coverage,
                          min_neighbors=base.graph.min_neighbors),
        solver="gn_dense", gn=GNConfig(**GN),
    )
    seq = ArraySequence(
        seq_j.colors, seq_j.depths,
        Intrinsics(float(INTR.fx), float(INTR.fy), float(INTR.cx),
                   float(INTR.cy)),
    )
    ft = DynamicFusion(seq, cfg, device="cpu")
    infos_t = ft.run_fused(motion_net=load_motion_complete_net(device="cpu"))
    return fj, infos_j, ft, infos_t, centers


def test_graph_and_model_match(runs):
    fj, _, ft, _, _ = runs
    assert ft.node_count == fj.node_count > 5
    # mesh vertices may differ in the last bit (the volumes are summed in
    # another order)
    np.testing.assert_allclose(ft.nodes.numpy(), np.asarray(fj.nodes),
                               atol=1e-6)
    np.testing.assert_array_equal(ft.edges.numpy(), np.asarray(fj.edges))
    np.testing.assert_array_equal(ft.model_valid.numpy(),
                                  np.asarray(fj.model_valid))
    np.testing.assert_allclose(ft.model_points.numpy(),
                               np.asarray(fj.model_points), atol=1e-6)
    for a, b in ((ft.point_table, fj.point_table),
                 (ft.vox_table, fj.vox_table)):
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
        np.testing.assert_array_equal(a.anchors.numpy(), np.asarray(b.anchors))
        np.testing.assert_allclose(a.weights.numpy(), np.asarray(b.weights),
                                   atol=1e-4)


def test_info_vectors_match(runs):
    _, infos_j, _, infos_t, _ = runs
    assert len(infos_t) == len(infos_j) == 3
    for a, b in zip(infos_t, infos_j):
        assert a["frame"] == b["frame"]
        assert a["n_correspondences"] == b["n_correspondences"]
        assert a["n_visible_nodes"] == b["n_visible_nodes"]
        assert a["solve_valid"] and b["solve_valid"]
        assert abs(a["final_loss"] - b["final_loss"]) <= 1e-3 * b["final_loss"]
        assert abs(a["mean_confidence"] - b["mean_confidence"]) <= 0.015


def test_node_transforms_match(runs):
    fj, _, ft, _, _ = runs
    n = fj.node_count
    np.testing.assert_allclose(ft.warp.rotations.numpy()[:n],
                               np.asarray(fj.warp.rotations)[:n], atol=1e-4)
    np.testing.assert_allclose(ft.warp.translations.numpy()[:n],
                               np.asarray(fj.warp.translations)[:n],
                               atol=1e-4)


def test_tsdf_matches(runs):
    fj, _, ft, _, _ = runs
    w_t = ft.tsdf.weight.numpy()
    np.testing.assert_array_equal(w_t, np.asarray(fj.tsdf.weight))
    np.testing.assert_array_equal(ft.tsdf.color.numpy(),
                                  np.asarray(fj.tsdf.color))
    np.testing.assert_allclose(ft.tsdf.tsdf.numpy(), np.asarray(fj.tsdf.tsdf),
                               atol=1e-4)
    assert w_t.max() >= 3.0


def test_deformed_mesh_matches(runs):
    fj, _, ft, _, _ = runs
    v_j, f_j = fj.get_deformed_mesh()
    v, f = ft.get_deformed_mesh()
    np.testing.assert_array_equal(f, f_j)
    np.testing.assert_allclose(v, v_j, atol=1e-4)
    assert np.abs(v - ft._extract_mesh_host()[0]).max() > 1e-3


def test_tracks_the_sphere(runs):
    _, _, ft, _, centers = runs
    t = ft.warp.translations.numpy()[: ft.node_count]
    np.testing.assert_allclose(np.median(t, axis=0), centers[-1] - centers[0],
                               atol=4e-3)
