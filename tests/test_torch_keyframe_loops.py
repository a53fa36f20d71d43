"""Keyframes, loop closures, relocalization and cluster freezing in the
port's loops against the JAX package on the CPU.

- ``run_fused(chunk=2)`` with growth and keyframes every 2nd frame on
  tests/test_fused_perception.py's fixture (32^3, 64x64, a textured
  sphere moving 1 mm sideways and 3 mm back a frame, dense Gauss-Newton
  without the motion GNN, loops closed two keyframes apart): the info of
  every frame (counts equal, losses within 1e-4 relative, the growth,
  correction and loop fields equal or within 1e-4), the keyframe
  trajectory within 1e-5, node transforms within 1e-5.
- Cluster freezing on tests/test_cluster_filter.py's two-component
  fixture (min_cluster_matches 400, dense Gauss-Newton), stepwise and one
  fused step: the frozen component keeps its transforms exactly, the
  rest within 1e-5 of JAX's.
Then the three keyframe switches, accepted with JAX's results, and the
port's FusionConfig against the JAX one's fields."""

import dataclasses

import numpy as np
import pytest

from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.fusion.pipeline import FusionConfig as FusionConfigJ
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.nicp import NICPConfig as NICPConfigJ
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig
import test_cluster_filter as TCF
import test_fused_perception as TFP
from test_fusion_e2e import small_config
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    port_fusion_config,
    port_sequence,
)

RT_ATOL = 1e-5
GN = dict(iters=6, w_point=1.0, w_arap=10.0, w_motion=0.0)


def _gn_pair():
    return (GNConfigJ(linear_solver="cholesky", assembly="blocks", **GN),
            GNConfig(**GN))


def _assert_transforms(ft, fj, atol=RT_ATOL):
    n = fj.node_count
    assert ft.node_count == n
    for name in ("rotations", "translations"):
        np.testing.assert_allclose(
            getattr(ft.warp, name).numpy()[:n],
            np.asarray(getattr(fj.warp, name))[:n], atol=atol, rtol=0,
            err_msg=name)


# ----------------------------------------------------------------------
# run_fused with growth and keyframes


@pytest.fixture(scope="module")
def fused():
    gn_j, gn_t = _gn_pair()
    cfg_j = TFP.config(growth_interval=2, keyframe_interval=2,
                       loop_min_separation=2, gn=gn_j)
    seq = TFP.make_seq(n=5)
    fj = DynamicFusionJ(seq, cfg_j)
    infos_j = fj.run_fused(chunk=2)
    ft = DynamicFusion(port_sequence(seq), port_fusion_config(
        cfg_j, nicp=NICPConfig(iters=20, w_motion=0.0, lr=0.02), gn=gn_t),
        device="cpu")
    seen = []
    infos_t = ft.run_fused(chunk=2,
                           keyframe_cb=lambda f, fr: seen.append(fr.index))
    return fj, infos_j, ft, infos_t, seen


def test_fused_keyframe_infos_match_jax(fused):
    _, infos_j, _, infos_t, seen = fused
    assert len(infos_t) == len(infos_j) == 4
    for a, b in zip(infos_t, infos_j):
        assert b.keys() <= a.keys()
        for k in ("n_correspondences", "n_visible_nodes", "solve_valid",
                  "n_new_nodes", "reloc_feat_matches", "loop_closures"):
            assert a.get(k) == b.get(k), (k, a, b)
        assert abs(a["final_loss"] - b["final_loss"]) <= 1e-4 * b[
            "final_loss"]
        if "pose_correction" in b:
            assert abs(a["pose_correction"] - b["pose_correction"]) <= 1e-4
    # growth and keyframes at each chunk's last frame; a loop closed at the
    # third keyframe (frame 4, two keyframes after frame 0)
    assert [i.get("n_new_nodes") for i in infos_t][1::2] == [
        b["n_new_nodes"] for b in infos_j[1::2]]
    assert infos_t[1]["n_new_nodes"] > 0
    assert infos_t[3]["loop_closures"] >= 1
    assert seen == [2, 4]


def test_fused_keyframe_trajectory_and_state_match_jax(fused):
    fj, _, ft, _, _ = fused
    ids_t, R_t, t_t = ft.trajectory()
    ids_j, R_j, t_j = fj.trajectory()
    np.testing.assert_array_equal(ids_t, ids_j)
    assert list(ids_t) == [0, 2, 4]
    np.testing.assert_allclose(R_t, R_j, atol=RT_ATOL)
    np.testing.assert_allclose(t_t, t_j, atol=RT_ATOL)
    _assert_transforms(ft, fj)
    np.testing.assert_array_equal(ft.edges.numpy(), np.asarray(fj.edges))


# ----------------------------------------------------------------------
# cluster freezing (tests/test_cluster_filter.py)


def _cluster_fusions(threshold):
    seq = TCF.make_two_component_seq()
    gn_j, gn_t = _gn_pair()
    cfg_j = FusionConfigJ(
        vol_dim=(48, 48, 48), voxel_size=0.008, node_coverage=0.035,
        max_nodes=256, max_points=2048, max_depth_diff=0.05,
        graph=dataclasses.replace(small_config().graph, node_coverage=0.035),
        nicp=NICPConfigJ(iters=40, w_motion=0.0, lr=0.02),
        use_motion_model=False, solver="gn_dense",
        min_cluster_matches=threshold, gn=gn_j)
    fj = DynamicFusionJ(seq, cfg_j)
    ft = DynamicFusion(port_sequence(seq), port_fusion_config(
        cfg_j, nicp=NICPConfig(iters=40, w_motion=0.0, lr=0.02), gn=gn_t),
        device="cpu")
    return seq, fj, ft


@pytest.fixture(scope="module")
def clusters():
    """engine -> (JAX fusion, port fusion) after frame 1 with
    min_cluster_matches 400: the stepwise register_frame, and one fused
    step (register_frame_fused)."""
    out = {}
    for engine in ("stepwise", "fused"):
        seq, fj, ft = _cluster_fusions(400.0)
        for f in (fj, ft):
            f.initialize(seq.load(0))
            if engine == "stepwise":
                f.register_frame(seq.load(1))
            else:
                sc, state, tables = f.build_fused(None)
                state, _ = f.register_frame_fused(sc, state, tables,
                                                  seq.load(1))
                f.adopt_fused_state(state)
        out[engine] = (fj, ft)
    return out


@pytest.mark.parametrize("engine", ["stepwise", "fused"])
def test_starved_component_freezes_as_in_jax(clusters, engine):
    fj, ft = clusters[engine]
    n = fj.node_count
    np.testing.assert_array_equal(ft.node_clusters.numpy(),
                                  np.asarray(fj.node_clusters))
    assert len(np.unique(ft.node_clusters.numpy()[:n])) >= 2
    is_b = ft.nodes.numpy()[:n, 0] > 0.0
    t = ft.warp.translations.numpy()[:n]
    # sphere B's component is frozen at identity, exactly; A tracks
    assert np.abs(t[is_b]).max() == 0.0
    assert np.abs(np.asarray(fj.warp.translations)[:n][is_b]).max() == 0.0
    assert np.abs(t[~is_b]).max() > 1e-3
    _assert_transforms(ft, fj)


# ----------------------------------------------------------------------
# the switches that raised before this slice


@pytest.mark.parametrize("name", ["growth_interval", "keyframe_interval",
                                  "min_cluster_matches"])
def test_keyframe_settings_are_ported(name, fused, clusters):
    """Each switch is accepted and gives JAX's result: growth and
    keyframes in the fused run above, cluster freezing in the stepwise
    run above (its frozen nodes would move without the switch)."""
    value = {"growth_interval": 2, "keyframe_interval": 2,
             "min_cluster_matches": 400.0}[name]
    assert getattr(FusionConfig(), name) == getattr(FusionConfigJ(), name)
    assert getattr(FusionConfig(**{name: value}), name) == value
    if name == "min_cluster_matches":
        fj, ft = clusters["stepwise"]
        assert ft.config.min_cluster_matches == value
        _assert_transforms(ft, fj)
        return
    fj, infos_j, ft, infos_t, _ = fused
    assert getattr(ft.config, name) == value
    key = "n_new_nodes" if name == "growth_interval" else "loop_closures"
    got = [i.get(key) for i in infos_t]
    assert got == [i.get(key) for i in infos_j]
    assert any(got)


def test_fusion_config_has_every_jax_field():
    """All but the TPU-only dense skinning switches, with JAX's defaults
    (the solver configs are the port's own types)."""
    fields_j = {f.name: f for f in dataclasses.fields(FusionConfigJ)}
    fields_t = {f.name: f for f in dataclasses.fields(FusionConfig)}
    assert set(fields_j) - set(fields_t) == {"lbs_impl",
                                             "dense_skin_max_bytes"}
    assert set(fields_t) <= set(fields_j)
    cj, ct = FusionConfigJ(), FusionConfig()
    for name in set(fields_t) - {"graph", "nicp", "gn"}:
        assert getattr(ct, name) == getattr(cj, name), name
