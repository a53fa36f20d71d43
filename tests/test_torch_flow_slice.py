"""The port's second slice against the JAX package: DynamicFusion.run_fused
on a textured version of tests/test_fusion_e2e.py's deforming sphere (its
small config, 4 frames) with a bricked volume (48^3, bricks of 8, 256
slots), PWC flow + MaskNet from checkpoints/flow.npz (fill mode, the JAX
defaults), the motion GNN and dense Gauss-Newton. The port assembles
with the K3 and K4 twins (the JAX "blocks_pallas_full"); the JAX
side runs "blocks", its XLA twin of both kernels, because its TPU
point-term kernel mishandles MaskNet's fractional weights (ROADMAP F1).

Compared at the tolerances of tests/test_torch_fusion_slice.py: brick
table, graph and skinning exactly; per-frame info; node transforms 1e-4;
TSDF weight and colour bit-equal, values 1e-4. Flow must have filled
points on the port's side, and the correspondence counts (which include
them) must match JAX's."""

import dataclasses

import numpy as np
import pytest

from occlusionfusion_tpu.fusion.frame_loader import ArraySequence as SeqJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.models.checkpoint import (
    load_motion_complete_params,
    normalize_indexed,
)
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.utils.snapshot import load_params
from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
from occlusionfusion_tpu_torch.models.checkpoint import (
    FLOW_NPZ,
    load_flow_nets,
    load_motion_complete_net,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from test_fusion_e2e import INTR, H, RADIUS, W, small_config
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    textured_sphere_frames,
)

GN = dict(iters=6, w_point=1.0, w_arap=10.0, w_motion=1.0)
BRICKS = dict(brick_size=8, max_bricks=256)
N_FRAMES = 4


@pytest.fixture(scope="module")
def runs():
    centers = [np.array([0.0, 0.0, 1.0]) + np.array([0.0, 0.0, 0.004]) * i
               for i in range(N_FRAMES)]
    depths, colors = textured_sphere_frames(centers, H, W, INTR, RADIUS)
    ck = normalize_indexed(load_params(FLOW_NPZ))
    cfg_j = dataclasses.replace(
        small_config(), solver="gn_dense", use_motion_model=True,
        use_flow=True, gn=GNConfigJ(linear_solver="cholesky",
                                    assembly="blocks", **GN), **BRICKS,
    )
    fj = DynamicFusionJ(SeqJ(colors, depths, INTR), cfg_j,
                        flow_params=ck["pwc"], mask_params=ck["mask"])
    infos_j = fj.run_fused(motion_params=load_motion_complete_params())

    base = small_config()
    cfg = FusionConfig(
        vol_dim=base.vol_dim, voxel_size=base.voxel_size,
        node_coverage=base.node_coverage, max_nodes=base.max_nodes,
        max_points=base.max_points, max_depth_diff=base.max_depth_diff,
        graph=GraphConfig(node_coverage=base.graph.node_coverage,
                          min_neighbors=base.graph.min_neighbors),
        solver="gn_dense", gn=GNConfig(**GN), use_flow=True,
        **BRICKS,
    )
    pwc, mask = load_flow_nets(device="cpu")
    seq = ArraySequence(colors, depths,
                        Intrinsics(*(float(x) for x in INTR)))
    ft = DynamicFusion(seq, cfg, device="cpu", flow_net=pwc, mask_net=mask)
    infos_t = ft.run_fused(motion_net=load_motion_complete_net(device="cpu"))
    return fj, infos_j, ft, infos_t, centers


def test_bricks_graph_and_skinning_match(runs):
    fj, _, ft, _, _ = runs
    assert ft.brick_size == 8
    np.testing.assert_array_equal(ft.brick_ids, fj.brick_ids)
    assert 0 < (ft.brick_ids >= 0).sum() < 256
    np.testing.assert_array_equal(ft.brick_valid.numpy(),
                                  np.asarray(fj.brick_valid))
    assert ft.node_count == fj.node_count > 5
    np.testing.assert_allclose(ft.nodes.numpy(), np.asarray(fj.nodes),
                               atol=1e-6)
    np.testing.assert_array_equal(ft.edges.numpy(), np.asarray(fj.edges))
    for a, b in ((ft.point_table, fj.point_table),
                 (ft.vox_table, fj.vox_table)):
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
        np.testing.assert_array_equal(a.anchors.numpy(), np.asarray(b.anchors))
        np.testing.assert_allclose(a.weights.numpy(), np.asarray(b.weights),
                                   atol=1e-4)


def test_info_vectors_match(runs):
    _, infos_j, _, infos_t, _ = runs
    assert len(infos_t) == len(infos_j) == N_FRAMES - 1
    for a, b in zip(infos_t, infos_j):
        assert a["frame"] == b["frame"]
        assert a["n_correspondences"] == b["n_correspondences"]
        assert a["n_visible_nodes"] == b["n_visible_nodes"]
        assert a["solve_valid"] and b["solve_valid"]
        assert abs(a["final_loss"] - b["final_loss"]) <= 1e-3 * b["final_loss"]
        assert abs(a["mean_confidence"] - b["mean_confidence"]) <= 0.015


def test_flow_filled_points(runs):
    _, _, _, infos_t, _ = runs
    filled = [i["n_flow_filled"] for i in infos_t]
    assert sum(filled) > 0, filled
    assert all(f < i["n_correspondences"] for f, i in zip(filled, infos_t))


def test_node_transforms_match(runs):
    fj, _, ft, _, _ = runs
    n = fj.node_count
    np.testing.assert_allclose(ft.warp.rotations.numpy()[:n],
                               np.asarray(fj.warp.rotations)[:n], atol=1e-4)
    np.testing.assert_allclose(ft.warp.translations.numpy()[:n],
                               np.asarray(fj.warp.translations)[:n],
                               atol=1e-4)


def test_bricked_tsdf_matches(runs):
    fj, _, ft, _, _ = runs
    assert ft.tsdf.tsdf.shape == (256, 8, 8, 8)
    np.testing.assert_array_equal(ft.tsdf.weight.numpy(),
                                  np.asarray(fj.tsdf.weight))
    np.testing.assert_array_equal(ft.tsdf.color.numpy(),
                                  np.asarray(fj.tsdf.color))
    np.testing.assert_allclose(ft.tsdf.tsdf.numpy(), np.asarray(fj.tsdf.tsdf),
                               atol=1e-4)
    assert ft.tsdf.weight.max() >= N_FRAMES


def test_tracks_the_sphere(runs):
    _, _, ft, _, centers = runs
    t = ft.warp.translations.numpy()[: ft.node_count]
    np.testing.assert_allclose(np.median(t, axis=0), centers[-1] - centers[0],
                               atol=4e-3)


def test_flow_needs_both_nets():
    seq = ArraySequence([np.zeros((4, 4, 3), np.float32)],
                        [np.zeros((4, 4), np.float32)],
                        Intrinsics(1.0, 1.0, 2.0, 2.0))
    with pytest.raises(ValueError, match="flow_net"):
        DynamicFusion(seq, FusionConfig(use_flow=True), device="cpu")
