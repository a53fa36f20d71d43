"""The port's stepwise loop (DynamicFusion.register_frame / run), its fused
step with N-ICP (run_fused) and MotionCompletionRunner against the JAX
package on the CPU.

The loops run the deforming sphere of tests/test_fusion_e2e.py (48^3,
128x128, initialize + 4 frames) with the motion GNN from the repo's
checkpoint; the stepwise N-ICP run drops depth-boundary pixels from the
association (Frame.boundary from boundary_mask_np). Tolerances: equal
correspondence and visible-node counts; final losses within 1e-3
relative; node translations and rotation entries within 1e-4, as
tests/test_torch_fusion_slice.py (readings: 2.6e-7 m and 5.0e-6 with
N-ICP); TSDF values within 1e-4 (readings 2.3e-5) where the integration
weights agree, and the weights equal but for at most 1e-4 of the voxels
(a voxel at the truncation band's edge may take one observation more:
1 of 110,592 with the fused N-ICP step); the runner within the GNN's
documented drift (0.35 mm motion, 0.015 confidence)."""

import dataclasses

import numpy as np
import pytest
import torch


from occlusionfusion_tpu.fusion import frame_loader as FLJ
from occlusionfusion_tpu.fusion import motion_runner as MRJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.models.checkpoint import load_motion_complete_params
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.nicp import NICPConfig as NICPConfigJ
from occlusionfusion_tpu_torch.fusion import frame_loader as FLT
from occlusionfusion_tpu_torch.fusion import motion_runner as MR
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
from occlusionfusion_tpu_torch.models import motion_complete as MC
from occlusionfusion_tpu_torch.models.checkpoint import (
    load_motion_complete_net,
    params_from_jax,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig
from test_fusion_e2e import INTR, make_sequence, small_config
from test_torch_motion import _pyramid_lists
from torch_port_impl import one_torch_thread  # noqa: F401

NICP_ITERS = 20
GN = dict(iters=6, w_point=1.0, w_arap=10.0, w_motion=1.0)
RT_ATOL = 1e-4
TSDF_ATOL = 1e-4
WEIGHT_DIFF_SHARE = 1e-4
N0 = 128
MOTION_TOL = 3.5e-4
CONF_TOL = 0.015
BOUNDARY_DIST = 0.01


class BoundarySequence:
    """A sequence whose frames carry the depth-boundary mask."""

    def __init__(self, seq, mask_fn):
        self.seq, self.mask_fn = seq, mask_fn
        self.intrinsics = seq.intrinsics

    def __len__(self):
        return len(self.seq)

    def load(self, i):
        f = self.seq.load(i)
        f.boundary = self.mask_fn(f.depth, self.intrinsics, BOUNDARY_DIST)
        return f


def configs(solver):
    base = small_config()
    cfg_j = dataclasses.replace(
        base, solver=solver, brick_size=0, use_motion_model=True,
        dense_skin_max_bytes=0, nicp=NICPConfigJ(iters=NICP_ITERS),
        gn=GNConfigJ(linear_solver="cholesky", assembly="blocks", **GN),
    )
    cfg_t = FusionConfig(
        vol_dim=base.vol_dim, voxel_size=base.voxel_size,
        node_coverage=base.node_coverage, max_nodes=base.max_nodes,
        max_points=base.max_points, max_depth_diff=base.max_depth_diff,
        graph=GraphConfig(node_coverage=base.graph.node_coverage,
                          min_neighbors=base.graph.min_neighbors),
        solver=solver, brick_size=0, nicp=NICPConfig(iters=NICP_ITERS),
        gn=GNConfig(**GN),
    )
    return cfg_j, cfg_t


def sequences(boundary):
    seq_j, centers = make_sequence(n_frames=5)
    seq_t = FLT.ArraySequence(
        seq_j.colors, seq_j.depths,
        Intrinsics(float(INTR.fx), float(INTR.fy), float(INTR.cx),
                   float(INTR.cy)))
    if boundary:
        seq_j = BoundarySequence(seq_j, FLJ.boundary_mask_np)
        seq_t = BoundarySequence(seq_t, FLT.boundary_mask_np)
    return seq_j, seq_t, centers


@pytest.fixture(scope="module")
def runs():
    """case -> (JAX fusion, JAX infos, port fusion, port infos, centres)."""
    params = load_motion_complete_params()
    net = load_motion_complete_net(device="cpu")
    out = {}
    for case, solver, loop, boundary in (
            ("stepwise_nicp", "nicp", "run", True),
            ("stepwise_gn", "gn_dense", "run", False),
            ("fused_nicp", "nicp", "run_fused", False)):
        cfg_j, cfg_t = configs(solver)
        seq_j, seq_t, centers = sequences(boundary)
        if loop == "run":
            fj = DynamicFusionJ(seq_j, cfg_j, motion_params=params)
            infos_j = fj.run()
        else:
            fj = DynamicFusionJ(seq_j, cfg_j)
            infos_j = fj.run_fused(motion_params=params)
        ft = DynamicFusion(seq_t, cfg_t, device="cpu")
        infos_t = getattr(ft, loop)(motion_net=net)
        out[case] = (fj, infos_j, ft, infos_t, centers)
    return out


CASES = ["stepwise_nicp", "stepwise_gn", "fused_nicp"]


def test_boundary_pixels_exist():
    _, seq_t, _ = sequences(True)
    assert seq_t.load(1).boundary.sum() > 50


@pytest.mark.parametrize("case", CASES)
def test_info_matches_jax(runs, case):
    _, infos_j, _, infos_t, _ = runs[case]
    assert len(infos_t) == len(infos_j) == 4
    for a, b in zip(infos_t, infos_j):
        assert a["n_correspondences"] == b["n_correspondences"]
        assert a["n_visible_nodes"] == b["n_visible_nodes"]
        assert a["solve_valid"] and b["solve_valid"]
        assert abs(a["final_loss"] - b["final_loss"]) <= 1e-3 * b[
            "final_loss"] + 1e-7


@pytest.mark.parametrize("case", CASES)
def test_node_transforms_match_jax(runs, case):
    fj, _, ft, _, _ = runs[case]
    n = fj.node_count
    assert ft.node_count == n > 5
    np.testing.assert_allclose(ft.warp.rotations.numpy()[:n],
                               np.asarray(fj.warp.rotations)[:n],
                               atol=RT_ATOL)
    np.testing.assert_allclose(ft.warp.translations.numpy()[:n],
                               np.asarray(fj.warp.translations)[:n],
                               atol=RT_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_tsdf_matches_jax(runs, case):
    fj, _, ft, _, _ = runs[case]
    w_t, w_j = ft.tsdf.weight.numpy(), np.asarray(fj.tsdf.weight)
    same = w_t == w_j
    assert np.mean(~same) <= WEIGHT_DIFF_SHARE
    assert np.abs(w_t - w_j).max() <= 1.0 and w_t.max() >= 4.0
    np.testing.assert_allclose(ft.tsdf.tsdf.numpy()[same],
                               np.asarray(fj.tsdf.tsdf)[same],
                               atol=TSDF_ATOL)


def test_stepwise_and_fused_nicp_agree(runs):
    """Without boundary pixels the stepwise loop is the fused step run
    eagerly, frame by frame."""
    cfg_j, cfg_t = configs("nicp")
    _, seq_t, _ = sequences(False)
    ft = DynamicFusion(seq_t, cfg_t, device="cpu")
    infos = ft.run(motion_net=load_motion_complete_net(device="cpu"))
    _, _, fused, infos_f, _ = runs["fused_nicp"]
    assert [i["n_correspondences"] for i in infos] == [
        i["n_correspondences"] for i in infos_f]
    torch.testing.assert_close(ft.warp.translations, fused.warp.translations,
                               atol=1e-6, rtol=0)
    assert ft.frame_id == 4 and ft.prev_frame.index == 4


@pytest.fixture(scope="module")
def runners():
    params = load_motion_complete_params()
    net = MC.MotionCompleteNet()
    net.load_state_dict(params_from_jax(params))
    return (lambda: MRJ.MotionCompletionRunner(params, n0_cap=N0),
            lambda: MR.MotionCompletionRunner(net.eval(), n0_cap=N0))


def _runner_frames(n_frames=6):
    """Frames of a growing graph (90 nodes, then 100), moving nodes, a
    changing visible set."""
    rng = np.random.RandomState(11)
    pos = rng.randn(100, 3).astype(np.float32) * 0.1
    frames = []
    for i in range(n_frames):
        n = 90 if i < 3 else 100
        nn, down, up = _pyramid_lists(n, seed=20 + (i >= 3))
        motion = (rng.randn(n, 3) * 0.003 + [0, 0, 0.004]).astype(np.float32)
        frames.append(dict(node_pos=pos[:n].copy(), node_motion=motion,
                           visible=rng.rand(n) > 0.3, nn_indexes=nn,
                           down_idxs=down, up_idxs=up))
        pos[:n] += motion
    return frames


def _assert_outputs(got, ref):
    (m_t, c_t), (m_j, c_j) = got, ref
    assert m_t.shape == np.asarray(m_j).shape and c_t.shape == np.asarray(
        c_j).shape
    np.testing.assert_allclose(m_t, np.asarray(m_j), atol=MOTION_TOL)
    np.testing.assert_allclose(c_t, np.asarray(c_j), atol=CONF_TOL)


def test_runner_run_frame_and_run_chunk_match_jax(runners):
    """Three frames through run_frame, then three through one run_chunk
    (the graph grows between them), state carried; then reset."""
    make_j, make_t = runners
    rj, rt = make_j(), make_t()
    frames = _runner_frames()
    for f in frames[:3]:
        _assert_outputs(rt.run_frame(**f), rj.run_frame(**f))
    for got, ref in zip(rt.run_chunk(frames[3:]), rj.run_chunk(frames[3:])):
        _assert_outputs(got, ref)
    assert int(rt.state.frame_idx) == int(rj.state.frame_idx) == 6
    assert int(rt.state.history_len) == int(rj.state.history_len)
    rt.reset()
    rj.reset()
    assert int(rt.state.frame_idx) == 0
    _assert_outputs(rt.run_frame(**frames[0]), rj.run_frame(**frames[0]))


def test_runner_chunk_equals_frames(runners):
    """run_chunk is run_frame in order, bit for bit."""
    _, make_t = runners
    frames = _runner_frames(4)
    a, b = make_t(), make_t()
    per_frame = [a.run_frame(**f) for f in frames]
    for (m1, c1), (m2, c2) in zip(per_frame, b.run_chunk(frames)):
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(c1, c2)


def test_motion_step_packed_is_motion_step():
    net = load_motion_complete_net(device="cpu")
    f = _runner_frames(1)[0]
    levels = MR.level_sizes_for(N0)
    ints, floats = MR.pack_frame(f["node_pos"], f["node_motion"],
                                 f["visible"], f["nn_indexes"],
                                 f["down_idxs"], f["up_idxs"], levels)
    ints, floats = torch.from_numpy(ints), torch.from_numpy(floats)
    with torch.no_grad():
        _, (m1, c1) = MR.motion_step_packed(
            net, MR.init_state(N0, "cpu"), ints, floats, levels)
        _, out = MR.motion_scan(net, MR.init_state(N0, "cpu"), ints[None],
                                floats[None], levels)
    assert torch.equal(out[0, :, :3], m1) and torch.equal(out[0, :, 3:], c1)
