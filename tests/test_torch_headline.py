"""The port's fifth slice against the JAX package: DynamicFusion.run_fused
(chunk=2) with the headline's perception as bench.py's ENVELOPE_ENV runs
it, PWC-Net + MaskNet in bfloat16 (cast once) with the sparse lift and
MaskNet at half resolution, and the Lepard matcher from
checkpoints/lepard_trained.npz at the JAX suite's small pyramid on a
strided 512-point target subsample, every frame; the motion GNN and
2-iteration dense Gauss-Newton (ENVELOPE_ENV's weights) on
tests/test_fusion_e2e.py's small bricked sphere (48^3, bricks of 8, 256
slots), textured, 3 frames (one chunk of 2). The JAX side assembles with
"blocks", the XLA twin (ROADMAP F1).

bf16 rounds at other places in XLA and in PyTorch, so the runs differ by
more than f32 rounding. Read on this input: the per-frame counts equal,
the final loss within 1.4%, node translations within 0.39 mm (median
0.022 mm) and rotation entries within 0.0123 (median 7.2e-4). Held to:
the counts within 0.5%, the loss within 5%, translations within 3 mm
(median 0.25 mm) and rotation entries within 0.1 (median 7e-3). With
the Lepard branch of the port's fused step taken out (its mask zeroed),
the second frame's loss is 0.32 against 0.036, the median translation
5.9 mm and the median rotation entry 0.13. The Lepard matches per frame
are held to the JAX matcher's, read through a host callback
(torch_port_impl.jax_lepard_match_counts).

The Lepard branch alone (flow off, f32) is held tightly on the same
sphere with max_depth_diff at 1 mm, where the projective association
fails for most points and the matcher supplies their targets and
weights: counts equal, node transforms within 5e-6 m and 1e-4 (read:
2.9e-7 m and 6.4e-6). Without the branch's weight raise the median
translation moves by 3.4 mm. In f32 the pieces are held tightly on their own:
tests/test_torch_sparse_flow.py (the lift, f32 and bf16),
tests/test_torch_lepard.py (the matcher) and
tests/test_torch_fusion_slice.py (the loop and get_deformed_mesh)."""

import dataclasses

import numpy as np
import pytest

from occlusionfusion_tpu.fusion.frame_loader import ArraySequence as SeqJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.models.checkpoint import (
    load_lepard_checkpoint as load_lepard_checkpoint_jax,
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
    LEPARD_NPZ,
    load_flow_nets,
    load_lepard_checkpoint,
    load_motion_complete_net,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from test_fusion_e2e import INTR, H, RADIUS, W, small_config
from test_torch_lepard import small
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    jax_lepard_match_counts,
    one_torch_thread,
    textured_sphere_frames,
)

GN = dict(iters=2, w_point=1.0, w_arap=2.0, w_motion=1.0)


HEADLINE_PERCEPTION = dict(
    use_flow=True, flow_lift="sparse", flow_bf16=True, mask_downscale=2,
    use_lepard=True, lepard_max_target_points=512,
    lepard_subsample="strided", brick_size=8, max_bricks=256,
)


def headline_runs(n_frames, perception=HEADLINE_PERCEPTION,
                  max_depth_diff=None):
    """(JAX fusion, JAX infos, JAX Lepard matches per frame, port fusion,
    port infos) of run_fused (chunk=2) on the textured sphere."""
    centers = [np.array([0.0, 0.0, 1.0]) + np.array([0.0, 0.0, 0.004]) * i
               for i in range(n_frames)]
    depths, colors = textured_sphere_frames(centers, H, W, INTR, RADIUS)
    ck = normalize_indexed(load_params(FLOW_NPZ))
    lep_params, lep_cfg = load_lepard_checkpoint_jax(LEPARD_NPZ)
    base = small_config()
    if max_depth_diff is not None:
        base = dataclasses.replace(base, max_depth_diff=max_depth_diff)
    cfg_j = dataclasses.replace(
        base, solver="gn_dense", use_motion_model=True,
        gn=GNConfigJ(linear_solver="cholesky", assembly="blocks", **GN),
        **perception,
    )
    fj = DynamicFusionJ(SeqJ(colors, depths, INTR), cfg_j,
                        flow_params=ck["pwc"], mask_params=ck["mask"],
                        lepard_params=lep_params,
                        lepard_config=small(lep_cfg))
    with jax_lepard_match_counts() as matches_j:
        infos_j = fj.run_fused(chunk=2,
                               motion_params=load_motion_complete_params())

    cfg = FusionConfig(
        vol_dim=base.vol_dim, voxel_size=base.voxel_size,
        node_coverage=base.node_coverage, max_nodes=base.max_nodes,
        max_points=base.max_points, max_depth_diff=base.max_depth_diff,
        graph=GraphConfig(node_coverage=base.graph.node_coverage,
                          min_neighbors=base.graph.min_neighbors),
        solver="gn_dense", gn=GNConfig(**GN), **perception,
    )
    pwc, mask = load_flow_nets(device="cpu")
    lep, lcfg = load_lepard_checkpoint(device="cpu")
    lep, _ = load_lepard_checkpoint(device="cpu", config=small(lcfg))
    seq = ArraySequence(colors, depths, Intrinsics(*(float(x) for x in INTR)))
    ft = DynamicFusion(seq, cfg, device="cpu", flow_net=pwc, mask_net=mask,
                       lepard_net=lep)
    infos_t = ft.run_fused(chunk=2,
                           motion_net=load_motion_complete_net(device="cpu"))
    return fj, infos_j, matches_j, ft, infos_t


LEPARD_ONLY = dict(use_lepard=True, lepard_max_target_points=512,
                   lepard_subsample="strided", brick_size=8, max_bricks=256)


@pytest.fixture(scope="module")
def runs():
    return headline_runs(3)


@pytest.fixture(scope="module")
def lepard_runs():
    return headline_runs(3, LEPARD_ONLY, max_depth_diff=0.001)


def test_info_vectors_near_jax(runs):
    _, infos_j, _, _, infos_t = runs
    assert len(infos_t) == len(infos_j) == 2
    for a, b in zip(infos_t, infos_j):
        assert a["solve_valid"] and b["solve_valid"]
        assert abs(a["n_correspondences"] - b["n_correspondences"]) <= (
            0.005 * b["n_correspondences"])
        assert abs(a["final_loss"] - b["final_loss"]) <= 0.05 * b["final_loss"]


def test_lepard_matches_near_jax(runs):
    _, _, matches_j, _, infos_t = runs
    assert len(matches_j) == len(infos_t) == 2
    assert max(matches_j) > 0
    for a, b in zip(infos_t, matches_j):
        assert abs(a["n_lepard_matches"] - b) <= 0.005 * max(b, 1)


def test_node_translations_near_jax(runs):
    fj, _, _, ft, _ = runs
    n = fj.node_count
    d = np.abs(ft.warp.translations.numpy()[:n]
               - np.asarray(fj.warp.translations)[:n])
    assert d.max() <= 3e-3
    assert np.median(d) <= 2.5e-4


def test_node_rotations_near_jax(runs):
    fj, _, _, ft, _ = runs
    n = fj.node_count
    d = np.abs(ft.warp.rotations.numpy()[:n]
               - np.asarray(fj.warp.rotations)[:n])
    assert d.max() <= 0.1
    assert np.median(d) <= 7e-3


def test_lepard_step_infos_match_jax(lepard_runs):
    _, infos_j, matches_j, _, infos_t = lepard_runs
    assert [i["n_lepard_matches"] for i in infos_t] == matches_j
    assert matches_j[-1] > 0.5 * infos_t[-1]["n_correspondences"]
    for a, b in zip(infos_t, infos_j):
        assert a["solve_valid"] and b["solve_valid"]
        assert a["n_correspondences"] == b["n_correspondences"]
        assert a["n_visible_nodes"] == b["n_visible_nodes"]
        assert abs(a["final_loss"] - b["final_loss"]) <= 1e-4 * b["final_loss"]
        assert abs(a["mean_confidence"] - b["mean_confidence"]) <= 1e-5


def test_lepard_step_transforms_match_jax(lepard_runs):
    fj, _, _, ft, _ = lepard_runs
    n = fj.node_count
    assert ft.node_count == n
    np.testing.assert_allclose(ft.warp.translations.numpy()[:n],
                               np.asarray(fj.warp.translations)[:n],
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(ft.warp.rotations.numpy()[:n],
                               np.asarray(fj.warp.rotations)[:n],
                               rtol=0, atol=1e-4)
