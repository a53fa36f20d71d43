"""The chunked engine of the port on the CPU: fused_register_chunk runs
its F steps in order (bit for bit the eager steps), run_fused drives
start / end / skip / chunk as the JAX run_fused does and sets
track_lost, frame_id and prev_frame, and the launch counters count a
captured graph's launches once per replay. The CUDA graph itself (the
path on CUDA tensors) runs only on the card: chip_smoke.py's phases
`graph` and `headline` hold it to the eager steps there."""

import numpy as np
import pytest
import torch

from occlusionfusion_tpu_torch import device as D
from occlusionfusion_tpu_torch.fusion import fused_step as FS
from occlusionfusion_tpu_torch.fusion import warpfield as WF
from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
    _FrameStager,
)
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
from occlusionfusion_tpu_torch.models.checkpoint import (
    load_motion_complete_net,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from torch_port_impl import one_torch_thread  # noqa: F401 (autouse)

H = W = 64
INTR = Intrinsics(150.0, 150.0, 32.0, 32.0)


def sphere_frames(n, empty_from=None):
    """A sphere at 0.6 m receding 4 mm a frame; frames from
    ``empty_from`` on have no depth at all."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    d = np.stack([(u - INTR.cx) / INTR.fx, (v - INTR.cy) / INTR.fy,
                  np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depths = []
    for i in range(n):
        c = np.array([0.0, 0.0, 0.6 + 0.004 * i])
        b = d @ c
        disc = b * b - (c @ c - 0.1 * 0.1)
        t = b - np.sqrt(np.maximum(disc, 0))
        depth = np.where((disc > 0) & (t > 0), t * d[..., 2], 0.0)
        if empty_from is not None and i >= empty_from:
            depth = np.zeros_like(depth)
        depths.append(depth.astype(np.float32))
    colors = [np.full((H, W, 3), 128.0, np.float32)] * n
    return ArraySequence(colors, depths, INTR)


def config():
    return FusionConfig(
        vol_dim=(32, 32, 32), voxel_size=0.01, node_coverage=0.04,
        max_nodes=128, max_points=1024, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=0.04, min_neighbors=2),
        solver="gn_dense",
        gn=GNConfig(iters=2, w_point=1.0, w_arap=2.0, w_motion=1.0),
    )


@pytest.fixture(scope="module")
def net():
    return load_motion_complete_net(device="cpu")


def test_chunk_on_cpu_is_the_eager_steps(net):
    seq = sphere_frames(4)
    f = DynamicFusion(seq, config(), device="cpu")
    f.initialize(seq.load(0))
    sc, state, tables = f.build_fused(net)
    depths = torch.stack([torch.from_numpy(seq.load(i).depth)
                          for i in (1, 2, 3)])
    colors = torch.stack([torch.from_numpy(seq.load(i).color)
                          for i in (1, 2, 3)])
    st, rows = state, []
    for j in range(3):
        st, info = FS.fused_register_frame(sc, st, tables, net, depths[j],
                                           colors[j], INTR)
        rows.append(info)
    graphs = {}
    sc_state, infos = FS.fused_register_chunk(sc, state, tables, net, depths,
                                              colors, INTR, graphs=graphs)
    assert torch.equal(infos, torch.stack(rows))
    assert graphs == {}  # the CPU runs the steps; nothing is captured
    assert torch.equal(sc_state.rotations, st.rotations)
    assert torch.equal(sc_state.translations, st.translations)
    assert torch.equal(sc_state.tsdf.tsdf, st.tsdf.tsdf)
    assert torch.equal(sc_state.motion.history, st.motion.history)


@pytest.mark.parametrize("start,end,skip,chunk", [
    (0, None, 1, 2), (0, 7, 2, 2), (1, 6, 1, 16)])
def test_run_fused_frame_ids(start, end, skip, chunk):
    seq = sphere_frames(7)
    f = DynamicFusion(seq, config(), device="cpu")
    infos = f.run_fused(start=start, end=end, skip=skip, chunk=chunk)
    ids = list(range(start + skip, len(seq) if end is None else end, skip))
    assert [i["frame"] for i in infos] == ids
    assert f.frame_id == ids[-1] and f.prev_frame.index == ids[-1]
    assert all(i["solve_valid"] for i in infos)
    assert not f.track_lost


def test_run_fused_sets_track_lost():
    """Frames without depth leave fewer than 16 correspondences."""
    f = DynamicFusion(sphere_frames(5, empty_from=3), config(), device="cpu")
    infos = f.run_fused(chunk=2)
    assert [i["n_correspondences"] < 16 for i in infos] == [
        False, False, True, True]
    assert f.track_lost


def test_deformed_mesh_follows_the_warp():
    """The canonical mesh, its vertices skinned and warped by the node
    field (tests/test_torch_headline.py holds it to JAX's)."""
    seq = sphere_frames(4)
    f = DynamicFusion(seq, config(), device="cpu")
    f.run_fused()
    verts, faces = f.get_deformed_mesh()
    canon, faces_c = f._extract_mesh_host()
    assert np.array_equal(faces, faces_c) and np.isfinite(verts).all()
    c = torch.from_numpy(canon)
    warped = WF.deform_points(f.warp, c, WF.skin(f.warp, c,
                                                 f.config.node_coverage))
    np.testing.assert_array_equal(verts, warped.numpy())
    assert np.abs(verts - canon).max() > 1e-3


def test_captured_launches_count_per_replay():
    D.reset_launch_counts()
    D.count_launch("lbs_warp")
    with D.capturing() as captured:
        D.count_launch("lbs_warp")
        D.count_launch("point_term_blocks")
        D.count_launch("point_term_blocks")
    assert D.launch_counts["lbs_warp"] == 1
    assert D.launch_counts["point_term_blocks"] == 0
    assert captured == {"knn": 0, "lbs_warp": 1, "point_term_blocks": 2,
                        "arap_term_blocks": 0}
    for _ in range(3):
        D.count_replay(captured)
    assert D.launch_counts["lbs_warp"] == 4
    assert D.launch_counts["point_term_blocks"] == 6
    D.reset_launch_counts()


def test_state_copy_helpers():
    a = FS.FusionStepState(
        tsdf=None, rotations=torch.zeros(2, 3, 3),
        translations=torch.zeros(2, 3), motion=None, prev_rgbxyz=None)
    b = FS._map_state(lambda x: x + 1, a)
    assert b.prev_rgbxyz is None and torch.equal(b.translations,
                                                 torch.ones(2, 3))
    FS._copy_state_(a, b)
    assert torch.equal(a.rotations, torch.ones(2, 3, 3))


def test_frame_stager_on_cpu():
    seq = sphere_frames(3)
    depths, colors = _FrameStager(torch.device("cpu")).upload(
        [seq.load(1), seq.load(2)])
    assert depths.shape == (2, H, W) and colors.shape == (2, H, W, 3)
    assert torch.equal(depths[1], torch.from_numpy(seq.load(2).depth))


@pytest.mark.parametrize("kw,err", [
    (dict(flow_lift="nearest"), ValueError),
    (dict(lepard_subsample="random"), ValueError),
    (dict(lepard_every=0), ValueError),
    (dict(flow_bf16=True), ValueError),  # bf16 takes the sparse lift
    (dict(mask_downscale=2), ValueError),
])
def test_invalid_settings_are_refused(kw, err):
    with pytest.raises(err):
        FusionConfig(**kw)


def test_perception_nets_are_required():
    seq = sphere_frames(1)
    with pytest.raises(ValueError, match="lepard_net"):
        DynamicFusion(seq, FusionConfig(use_lepard=True), device="cpu")
    with pytest.raises(ValueError, match="flow_net"):
        DynamicFusion(seq, FusionConfig(use_flow=True), device="cpu")
    # flow without MaskNet weighs each valid flow target 1
    DynamicFusion(seq, FusionConfig(use_flow=True), device="cpu",
                  flow_net=object())
