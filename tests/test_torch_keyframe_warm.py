"""ROADMAP F11 against the JAX package on the CPU: the stepwise loop's
first solve after a growth starts the new nodes at identity in JAX, and
the port keeps that warm start, across a snapshot too (tests/
test_torch_keyframe_growth.py's appearing sphere at 48^3, dense
Gauss-Newton, growth every 2nd frame; transforms within 1e-5 of JAX's,
the resumed port run equal to the uninterrupted one)."""

import dataclasses

import numpy as np
import pytest

from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig
from test_fusion_e2e import small_config
from test_torch_keyframe_growth import appearing_sequence
from test_torch_keyframe_loops import _assert_transforms, _gn_pair
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    port_fusion_config,
    port_sequence,
)


def test_f11_stepwise_warm_start_after_growth(tmp_path):
    """ROADMAP F11. After a growth that adds nodes, the JAX stepwise loop
    deforms with the grown warp but starts its next solve from the last
    solve's transforms, where the new nodes sit at identity; the port's
    stepwise loop keeps that warm start (``_warm``). The port's snapshot
    carries it, so a resumed port run repeats the uninterrupted one; the
    JAX loader reads the same file and ignores it."""
    gn_j, gn_t = _gn_pair()
    cfg_j = dataclasses.replace(small_config(), solver="gn_dense", gn=gn_j,
                                growth_interval=2)
    seq_j = appearing_sequence(4)
    fj = DynamicFusionJ(seq_j, cfg_j)
    ft = DynamicFusion(port_sequence(seq_j), port_fusion_config(
        cfg_j, nicp=NICPConfig(iters=60, w_motion=0.0, lr=0.02), gn=gn_t),
        device="cpu")
    for f in (fj, ft):
        f.initialize(f.seq.load(0))
        f.register_frame(f.seq.load(1))
    grown = [f.register_frame(f.seq.load(2))["n_new_nodes"]
             for f in (fj, ft)]
    assert grown[0] == grown[1] > 0
    new = slice(ft.node_count - grown[1], ft.node_count)
    assert not np.asarray(fj.prev_t)[new].any()
    assert np.abs(np.asarray(fj.warp.translations)[new]).max() > 1e-3
    assert ft._warm is not None and not ft._warm[1][new].any()
    path = str(tmp_path / "grown.npz")
    ft.save_state(path)
    for f in (fj, ft):
        f.register_frame(f.seq.load(3))
    _assert_transforms(ft, fj)
    resumed = DynamicFusion(ft.seq, ft.config, device="cpu")
    resumed.load_state(path)
    resumed.register_frame(resumed.seq.load(3))
    for name in ("rotations", "translations"):
        np.testing.assert_array_equal(getattr(resumed.warp, name).numpy(),
                                      getattr(ft.warp, name).numpy())
    fj2 = DynamicFusionJ(seq_j, cfg_j)
    fj2.load_state(path)
    assert fj2.node_count == ft.node_count


@pytest.mark.parametrize("drift", [False, True])
def test_resume_at_a_growth_keyframe_repeats_the_run(tmp_path, drift):
    """The port's stepwise loop saved at a frame that is a growth keyframe
    and a keyframe (appearing sphere, bricks, N-ICP with the motion GNN,
    growth and keyframes every 2nd frame) and resumed in a fresh object:
    the resumed loop's next fused step gets exactly the uninterrupted
    loop's arguments (state, motion history, tables, the growth's warm
    start), and the next two frames (the second a growth keyframe again)
    end bit-identical. With ``drift`` a rigid 3 cm offset before the
    keyframe work of the saved frame makes the relocalization correct the
    warp, which drops the warm start."""
    import chip_smoke as CS
    import torch

    from occlusionfusion_tpu_torch.fusion import warpfield as W
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    cfg_j = dataclasses.replace(
        small_config(), use_motion_model=True, dense_skin_max_bytes=0,
        brick_size=4, max_bricks=1024, growth_interval=2,
        keyframe_interval=2)
    cfg = port_fusion_config(cfg_j, nicp=NICPConfig(iters=20))
    net = load_motion_complete_net(device="cpu")
    seq = port_sequence(appearing_sequence(5))
    ft = DynamicFusion(seq, cfg, device="cpu")
    ft.initialize(seq.load(0))
    ft.register_frame(seq.load(1), net)
    if drift:
        record = ft._record_keyframe

        def drifted(frame):
            ft.warp = W.left_compose_rigid(ft.warp, torch.eye(3),
                                           torch.tensor([0.005, 0.0, 0.03]))
            return record(frame)

        ft._record_keyframe = drifted
    info = ft.register_frame(seq.load(2), net)
    ft._record_keyframe = DynamicFusion._record_keyframe.__get__(ft)
    assert info["n_new_nodes"] > 0 and ft.n_new_bricks > 0
    assert (info["pose_correction"] > 1e-3) == drift
    assert (ft._warm is None) == drift
    path = str(tmp_path / "keyframe.npz")
    ft.save_state(path)
    resumed = DynamicFusion(seq, cfg, device="cpu")
    resumed.load_state(path)
    steps = []
    for f in (ft, resumed):
        with CS.StepArgumentTap() as tap:
            grown = [f.register_frame(seq.load(i), net)["n_new_nodes"]
                     for i in (3, 4)]
        steps.append(tap.calls)
    assert grown[1] > 0
    assert CS.tree_differences(steps[0][0], steps[1][0]) == []
    for name in ("rotations", "translations"):
        np.testing.assert_array_equal(getattr(resumed.warp, name).numpy(),
                                      getattr(ft.warp, name).numpy())
    for a, b in zip(resumed.tsdf, ft.tsdf):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
