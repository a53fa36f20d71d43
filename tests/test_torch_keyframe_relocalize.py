"""Relocalization and the keyframe pose graph in the port's stepwise
loop against the JAX package on the CPU.

- Drift correction, as tests/test_pose_graph_in_loop.py:181-221 runs it
  (keyframe_interval 1, a rigid 3 cm offset left-composed into the warp
  before the third keyframe): equal loop counts, ``pose_correction``
  within 1e-4, the corrected warp and the trajectory within 1e-5, and the
  model's drift cut below 0.35 of what was injected.
- Two stepwise frames with a keyframe each: their pose fields equal, or
  within 1e-4.
- Recovery from a lost track with the matcher's feature seed
  (``relocalize_recovery``, ``relocalize_feat_min_points``;
  checkpoints/lepard_trained.npz at tests/test_torch_lepard.py's small
  pyramid, used by the recovery only): the sphere, a frame with no depth
  (the track is lost), then the sphere again 2 cm to the side. The
  recovering keyframe's correction within 1e-4 and its matcher count
  equal to JAX's, ``track_lost`` cleared in both, the warp within
  1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occlusionfusion_tpu.fusion import warpfield as WJ
from occlusionfusion_tpu.fusion.frame_loader import ArraySequence as SeqJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.models.checkpoint import (
    load_lepard_checkpoint as load_lepard_checkpoint_jax,
)
from occlusionfusion_tpu_torch.fusion import warpfield as W
from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
from occlusionfusion_tpu_torch.models.checkpoint import (
    LEPARD_NPZ,
    load_lepard_checkpoint,
)
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig
from test_fusion_e2e import H, W as WIDTH, make_sequence, small_config
from test_fusion_e2e import sphere_depth
from test_torch_lepard import small
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    port_fusion_config,
    port_sequence,
)

RT_ATOL = 1e-5


def _assert_transforms(ft, fj, atol=RT_ATOL):
    n = fj.node_count
    assert ft.node_count == n
    for name in ("rotations", "translations"):
        np.testing.assert_allclose(
            getattr(ft.warp, name).numpy()[:n],
            np.asarray(getattr(fj.warp, name))[:n], atol=atol, rtol=0,
            err_msg=name)
# ----------------------------------------------------------------------
# drift correction (tests/test_pose_graph_in_loop.py)


def _pose_cfg():
    return dataclasses.replace(small_config(), keyframe_interval=1,
                               loop_radius=1.0, loop_align_iters=16,
                               loop_min_separation=2)


def _pose_fusions():
    seq, _ = make_sequence(n_frames=3, step=(0.0, 0.0, 0.0))
    cfg_j = _pose_cfg()
    fj = DynamicFusionJ(seq, cfg_j)
    ft = DynamicFusion(port_sequence(seq), port_fusion_config(
        cfg_j, nicp=NICPConfig(iters=60, w_motion=0.0, lr=0.02)),
        device="cpu")
    return seq, fj, ft


def _model_error(warp, points, table, valid, canonical):
    pts = np.asarray(W.deform_points(warp, points, table))
    return float(np.linalg.norm(pts[valid].mean(0)
                                - canonical[valid].mean(0)))


def test_drift_correction_matches_jax():
    seq, fj, ft = _pose_fusions()
    t_err = np.asarray([0.005, 0.0, 0.03], np.float32)
    out = {}
    for name, f in (("jax", fj), ("port", ft)):
        f.initialize(seq.load(0))
        assert len(f.keyframes) == 1
        f._record_keyframe(seq.load(1))
        if name == "jax":
            f.warp = WJ.left_compose_rigid(f.warp, jnp.eye(3),
                                           jnp.asarray(t_err))
        else:
            f.warp = W.left_compose_rigid(f.warp, torch.eye(3),
                                          torch.from_numpy(t_err))
        f._record_keyframe(seq.load(2))
        correction = f._relocalize(f.keyframes[-1])
        out[name] = (correction, f._pose_graph_update())
    (c_t, loops_t), (c_j, loops_j) = out["port"], out["jax"]
    assert loops_t == loops_j >= 1
    assert c_t > 1e-3 and abs(c_t - c_j) <= 1e-4, (c_t, c_j)
    _assert_transforms(ft, fj)
    for a, b in zip(ft.trajectory(), fj.trajectory()):
        np.testing.assert_allclose(a, b, atol=RT_ATOL)
    canonical = ft.model_points.numpy()
    valid = (ft.model_valid & ft.point_table.valid).numpy()
    before = float(np.linalg.norm(t_err))
    after = _model_error(ft.warp, ft.model_points, ft.point_table, valid,
                         canonical)
    assert after < 0.35 * before, (before, after)


def test_stepwise_pose_fields_match_jax():
    seq, fj, ft = _pose_fusions()
    for f in (fj, ft):
        f.initialize(seq.load(0))
    for i in (1, 2):
        a, b = ft.register_frame(seq.load(i)), fj.register_frame(seq.load(i))
        for k in ("n_correspondences", "n_new_nodes", "reloc_feat_matches",
                  "loop_closures"):
            assert a[k] == b[k], (k, a, b)
        assert abs(a["pose_correction"] - b["pose_correction"]) <= 1e-4
    assert len(ft.keyframes) == len(fj.keyframes) == 3
    assert a["loop_closures"] >= 1
    _assert_transforms(ft, fj, atol=1e-4)


# ----------------------------------------------------------------------
# recovery from a lost track, seeded by the matcher


def _lost_and_back_sequence():
    centers = [[0.0, 0.0, 1.0], [0.0, 0.0, 1.004], None, [0.02, 0.0, 1.004]]
    depths = [np.zeros((H, WIDTH), np.float32) if c is None
              else sphere_depth(c) for c in centers]
    colors = [np.full((H, WIDTH, 3), 128.0, np.float32)] * len(depths)
    return SeqJ(colors, depths, make_sequence(1)[0].intrinsics)


@pytest.fixture(scope="module")
def recovery():
    seq = _lost_and_back_sequence()
    cfg_j = dataclasses.replace(
        small_config(), keyframe_interval=1, loop_min_separation=2,
        relocalize_recovery=True, relocalize_feat_min_points=8,
        lepard_max_target_points=512)
    params, lcfg_j = load_lepard_checkpoint_jax(LEPARD_NPZ)
    fj = DynamicFusionJ(seq, cfg_j, lepard_params=params,
                        lepard_config=small(lcfg_j))
    infos_j = fj.run()
    _, lcfg = load_lepard_checkpoint(device="cpu")
    net, _ = load_lepard_checkpoint(device="cpu", config=small(lcfg))
    ft = DynamicFusion(port_sequence(seq), port_fusion_config(
        cfg_j, nicp=NICPConfig(iters=60, w_motion=0.0, lr=0.02)),
        device="cpu", lepard_net=net)
    lost = []
    register = ft.register_frame

    def tracked(frame, motion_net=None):
        info = register(frame, motion_net)
        lost.append(ft.track_lost)
        return info

    ft.register_frame = tracked
    infos_t = ft.run()
    return fj, infos_j, ft, infos_t, lost


def test_recovery_with_feature_seed_matches_jax(recovery):
    fj, infos_j, ft, infos_t, lost = recovery
    # lost at frame 2 (no depth), recovered at frame 3
    assert lost == [False, True, False]
    assert not fj.track_lost
    assert infos_t[1]["n_correspondences"] == 0
    for a, b in zip(infos_t, infos_j):
        for k in ("n_correspondences", "reloc_feat_matches",
                  "loop_closures"):
            assert a[k] == b[k], (k, a, b)
        assert abs(a["pose_correction"] - b["pose_correction"]) <= 1e-4
    # the feature seed ran on the recovering keyframe and the correction
    # was applied
    assert infos_t[2]["reloc_feat_matches"] >= 8
    assert infos_t[2]["pose_correction"] > 1e-2
    _assert_transforms(ft, fj, atol=1e-4)
