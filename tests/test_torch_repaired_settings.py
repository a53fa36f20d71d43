"""Two settings of the JAX FusionConfig that the port fixed at their
defaults until this slice, against the JAX package on the CPU at values
other than the defaults:

- ``flow_mask_threshold`` 0.6 (default 0.35): the MaskNet weight a flow
  target must exceed, in fill (one fused step, dense lift), override
  (one stepwise step) and advect mode (one fused step, sparse lift, the
  advect gate taking the same threshold) on tests/test_torch_flow_modes.py's
  textured pair; counts equal, loss within 1e-4 relative, node transforms
  within 1e-5, as there. A check that the threshold changes the step.
- ``brick_dilate`` 0 and 2 (default 1): the active bricks from a depth
  frame and from points, equal; and ``initialize`` of a bricked volume
  with ``brick_dilate=2``, its brick table equal to JAX's."""

import dataclasses

import numpy as np
import pytest

from occlusionfusion_tpu.fusion import bricks as BRJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu_torch.fusion import bricks as BR
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
)
from test_fusion_e2e import make_sequence, small_config
from test_torch_flow_modes import (  # noqa: F401 (fixtures)
    assert_step_matches,
    flow_tree,
    frames,
    one_step,
)
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    port_fusion_config,
    port_sequence,
)

THRESHOLD = 0.6
CASES = {
    "fill": ("fused", dict()),
    "override": ("stepwise", dict()),
    "advect": ("fused", dict(flow_lift="sparse")),
}


@pytest.fixture(scope="module")
def threshold_runs(frames, flow_tree):  # noqa: F811
    return {mode: one_step(frames, flow_tree, engine, flow_mode=mode,
                           flow_mask_threshold=THRESHOLD, **kw)
            for mode, (engine, kw) in CASES.items()}


@pytest.mark.parametrize("mode", list(CASES))
def test_flow_mask_threshold_matches_jax(threshold_runs, mode):
    info_j, fj, info_t, ft = threshold_runs[mode]
    assert ft.config.flow_mask_threshold == THRESHOLD
    assert_step_matches(info_j, fj, info_t, ft)


def test_flow_mask_threshold_changes_the_step(threshold_runs, frames,
                                              flow_tree):  # noqa: F811
    """At the default threshold the fill step differs: the setting is
    read, not ignored."""
    _, _, info_t, ft = one_step(frames, flow_tree, "fused", flow_mode="fill")
    _, _, info_hi, ft_hi = threshold_runs["fill"]
    assert FusionConfig().flow_mask_threshold == 0.35
    assert (info_t[1] != info_hi[1] or np.abs(
        ft.warp.translations.numpy() - ft_hi.warp.translations.numpy()
    ).max() > 1e-6)


@pytest.mark.parametrize("dilate", [0, 2])
def test_active_bricks_with_dilation_match_jax(dilate):
    seq, _ = make_sequence(n_frames=1)
    depth, intr = seq.load(0).depth, seq.intrinsics
    grid_j = BRJ.BrickGrid(vol_dim=(48, 48, 48), voxel_size=0.008, brick=4,
                           max_bricks=1024)
    grid = BR.BrickGrid(*grid_j)
    origin = np.asarray([-0.19, -0.19, 0.76], np.float32)
    intr_t = port_sequence(seq).intrinsics
    ids = BR.active_bricks_from_depth(grid, origin, depth, intr_t, 0.032,
                                      dilate=dilate)
    np.testing.assert_array_equal(
        ids, BRJ.active_bricks_from_depth(grid_j, origin, depth, intr, 0.032,
                                          dilate=dilate))
    pts = BR._backproject_valid(depth, intr_t)[::5]
    np.testing.assert_array_equal(
        BR.active_bricks_from_points(grid, origin, pts, 0.02, dilate=dilate),
        BRJ.active_bricks_from_points(grid_j, origin, pts, 0.02,
                                      dilate=dilate))
    one = BR.active_bricks_from_depth(grid, origin, depth, intr_t, 0.032)
    assert (len(ids) > len(one)) == (dilate > 1)


def test_initialize_with_brick_dilate_matches_jax():
    seq, _ = make_sequence(n_frames=1)
    cfg_j = dataclasses.replace(small_config(), brick_size=4,
                                max_bricks=1024, brick_dilate=2)
    fj = DynamicFusionJ(seq, cfg_j)
    fj.initialize(seq.load(0))
    ft = DynamicFusion(port_sequence(seq), port_fusion_config(cfg_j),
                       device="cpu")
    ft.initialize(ft.seq.load(0))
    assert ft.config.brick_dilate == 2
    np.testing.assert_array_equal(ft.brick_ids, np.asarray(fj.brick_ids))
    default = DynamicFusion(port_sequence(seq), port_fusion_config(
        dataclasses.replace(cfg_j, brick_dilate=1)), device="cpu")
    default.initialize(default.seq.load(0))
    assert (ft.brick_ids >= 0).sum() > (default.brick_ids >= 0).sum()
