"""The reference algorithm's overshoot of a receding sphere at 1 m,
reproduced by the port. The JAX package and the port run the main path's
settings (gn_dense, 4 iterations, w_point 1, w_arap 2, w_motion 1, the
motion GNN, 16 frames) on chip_smoke.py's sphere at 1 m, at half its
image and a coarser grid over the same extent (chip_smoke.NEAR). Both
overshoot the true 64 mm alike, and the JAX result is the value
chip_smoke.py holds the card to (NEAR_REFERENCE_Z)."""

import numpy as np
import pytest

import chip_smoke as CS
from occlusionfusion_tpu.fusion.frame_loader import ArraySequence as ArraySequenceJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.fusion.pipeline import FusionConfig as FusionConfigJ
from occlusionfusion_tpu.geometry.camera import Intrinsics as IntrinsicsJ
from occlusionfusion_tpu.graph.edgraph import GraphConfig as GraphConfigJ
from occlusionfusion_tpu.models.checkpoint import load_motion_complete_params
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
from occlusionfusion_tpu_torch.models.checkpoint import (
    load_motion_complete_net,
)
from torch_port_impl import one_torch_thread  # noqa: F401


def _jax_config(cfg):
    """The JAX package's FusionConfig with the same settings as ``cfg``."""
    gn = cfg.gn
    return FusionConfigJ(
        vol_dim=cfg.vol_dim, voxel_size=cfg.voxel_size,
        node_coverage=cfg.node_coverage, max_nodes=cfg.max_nodes,
        max_points=cfg.max_points, max_depth_diff=cfg.max_depth_diff,
        graph=GraphConfigJ(node_coverage=cfg.graph.node_coverage,
                           min_neighbors=cfg.graph.min_neighbors),
        solver="gn_dense", brick_size=0, use_motion_model=True,
        gn=GNConfigJ(iters=gn.iters, w_point=gn.w_point, w_arap=gn.w_arap,
                     w_motion=gn.w_motion, linear_solver="cholesky",
                     assembly="blocks"),
    )


@pytest.fixture(scope="module")
def runs():
    seq, centers = CS.near_sequence()
    n = CS.NEAR
    cfg = CS.sphere_config(n["vol"], n["voxel"], n["max_points"])
    ft = DynamicFusion(seq, cfg, device="cpu")
    infos_t = ft.run_fused(motion_net=load_motion_complete_net(device="cpu"))

    i = seq.intrinsics
    seq_j = ArraySequenceJ(seq.colors, seq.depths,
                           IntrinsicsJ(i.fx, i.fy, i.cx, i.cy))
    fj = DynamicFusionJ(seq_j, _jax_config(cfg))
    infos_j = fj.run_fused(motion_params=load_motion_complete_params())
    tr_t = ft.warp.translations.numpy()[: ft.node_count]
    tr_j = np.asarray(fj.warp.translations)[: fj.node_count]
    return infos_t, infos_j, tr_t, tr_j, centers[-1] - centers[0]


def test_the_input_is_the_main_paths_kind(runs):
    infos_t, infos_j, tr_t, tr_j, _ = runs
    assert len(infos_t) == len(infos_j) == CS.N_FRAMES
    assert all(a["solve_valid"] and b["solve_valid"]
               for a, b in zip(infos_t, infos_j))
    assert 200 <= tr_t.shape[0] == tr_j.shape[0] <= CS.MAX_NODES


def test_both_overshoot_alike(runs):
    _, _, tr_t, tr_j, motion = runs
    med_t, med_j = np.median(tr_t, axis=0), np.median(tr_j, axis=0)
    np.testing.assert_allclose(med_t, med_j, atol=2.5e-4)
    assert med_j[2] > motion[2] + 4e-3 and med_t[2] > motion[2] + 4e-3


def test_node_translations_match(runs):
    _, _, tr_t, tr_j, _ = runs
    np.testing.assert_allclose(tr_t, tr_j, atol=5e-4)


def test_chip_smoke_reference_is_the_jax_result(runs):
    _, _, _, tr_j, _ = runs
    assert abs(np.median(tr_j[:, 2]) - CS.NEAR_REFERENCE_Z) <= 5e-5
