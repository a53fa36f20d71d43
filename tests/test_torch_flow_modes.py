"""The port's flow settings against the JAX package on the CPU, with the
repo's checkpoints/flow.npz: fusion/flow_correspondence.py's
``flow_downscale`` on the dense and the sparse lift (PWC and MaskNet at
1/2 of a frame whose sides do not divide by 2, so each flow axis takes
its own ratio), ``patchwise_max_weights`` (patchwise NMS) and the
nearest sampling of an NMS'd field; then one fused step
(``register_frame_fused``) and one stepwise step (``register_frame``) in
each flow mode (fill, override, advect) with non-default
``flow_advect_*`` values, and flow without MaskNet, on a textured sphere
that moves sideways (~1.5 px of flow a frame) at the small size of
tests/test_fused_perception.py (32^3, 64x64), dense Gauss-Newton (the
JAX side assembles with "blocks", ROADMAP F1).

Tolerances: the lifts to 1e-4 (m, px and weight) and their validity
exactly, as tests/test_torch_sparse_flow.py:103-104 holds the lift; NMS
and the nearest sample exactly; a step's counts equal, its loss within
1e-4 relative and node transforms within 1e-5 (m and rotation entry),
which a point's flow target flipping across a gate would exceed."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from occlusionfusion_tpu.fusion.flow_correspondence import (
    flow_correspondences as flow_correspondences_jax,
    flow_targets_at_points as flow_targets_at_points_jax,
    patchwise_max_weights as patchwise_max_weights_jax,
    sample_weight_field as sample_weight_field_jax,
)
from occlusionfusion_tpu.fusion.frame_loader import ArraySequence as SeqJ
from occlusionfusion_tpu.fusion.fused_step import _rgbxyz_image as rgbxyz_jax
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.fusion.pipeline import FusionConfig as FusionConfigJ
from occlusionfusion_tpu.geometry.camera import Intrinsics as IntrJ
from occlusionfusion_tpu.graph.edgraph import GraphConfig as GraphConfigJ
from occlusionfusion_tpu.models.checkpoint import normalize_indexed
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.utils.snapshot import load_params
from occlusionfusion_tpu_torch.fusion.flow_correspondence import (
    flow_correspondences,
    flow_targets_at_points,
    patchwise_max_weights,
    sample_weight_field,
)
from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
from occlusionfusion_tpu_torch.fusion.fused_step import _rgbxyz_image
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
from occlusionfusion_tpu_torch.models.checkpoint import (
    FLOW_NPZ,
    load_flow_nets,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    textured_sphere_frames,
    tt,
)

# non-default advect knobs, so that each one shows in the result
ADVECT = dict(flow_advect_min_px=0.5, flow_advect_weight=0.7,
              flow_advect_mask_threshold=0.3, flow_advect_alpha=0.6)
GN = dict(iters=2, w_point=1.0, w_arap=2.0, w_motion=1.0)


@pytest.fixture(scope="module")
def flow_tree():
    return normalize_indexed(load_params(FLOW_NPZ)), load_flow_nets(
        device="cpu")


@pytest.fixture(scope="module")
def odd_pair():
    """Two textured 73x101 frames (odd sides) of a sphere moving sideways,
    as JAX and port RGB-XYZ images, and query pixels."""
    intr = IntrJ(np.float32(120.0), np.float32(120.0), np.float32(50.0),
                 np.float32(36.0))
    depths, colors = textured_sphere_frames(
        [[0.0, 0.0, 0.6], [0.008, 0.0, 0.602]], 73, 101, intr, 0.12)
    it = Intrinsics(*(float(x) for x in intr))
    j = [rgbxyz_jax(jnp.asarray(d), jnp.asarray(c), intr)
         for d, c in zip(depths, colors)]
    t = [_rgbxyz_image(tt(d), tt(c), it) for d, c in zip(depths, colors)]
    uv = np.random.RandomState(0).uniform([4, 4], [97, 69],
                                          (300, 2)).astype(np.float32)
    return j, t, uv


def test_dense_lift_downscale_matches_jax(flow_tree, odd_pair):
    (tree, (pwc, mask)), (j, t, _) = flow_tree, odd_pair
    ref = [np.asarray(x) for x in flow_correspondences_jax(
        tree["pwc"], j[0], j[1], mask_params=tree["mask"], downscale=2)]
    with torch.no_grad():
        got = [x.numpy() for x in flow_correspondences(pwc, t[0], t[1], mask,
                                                       downscale=2)]
    valid = ref[2]
    assert got[0].shape == (73, 101, 2) and valid.sum() > 1000
    assert np.abs(ref[0][valid, 0]).mean() > 1.0  # the sideways flow
    np.testing.assert_array_equal(got[2], valid)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(got[1][valid], ref[1][valid], atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-4)


def test_sparse_lift_downscale_matches_jax(flow_tree, odd_pair):
    (tree, (pwc, mask)), (j, t, uv) = flow_tree, odd_pair
    ref = [np.asarray(x) for x in flow_targets_at_points_jax(
        tree["pwc"], j[0], j[1], jnp.asarray(uv), mask_params=tree["mask"],
        downscale=2, return_uv2=True)]
    with torch.no_grad():
        got = [x.numpy() for x in flow_targets_at_points(
            pwc, t[0], t[1], tt(uv), mask, downscale=2, return_uv2=True)]
    np.testing.assert_array_equal(got[1], ref[1])
    assert 60 < ref[1].sum() < 300
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-4)


@pytest.mark.parametrize("shape,patch", [((16, 16), 4), ((13, 18), 4),
                                         ((20, 31), 3), ((7, 5), 8)])
def test_patchwise_max_weights_matches_jax(shape, patch):
    rng = np.random.RandomState(sum(shape) + patch)
    w = rng.rand(*shape).astype(np.float32)
    w[w < 0.2] = 0.0  # zero runs, as the validity masking leaves them
    w[1, 1] = w[0, 0]  # a tie inside one patch keeps both pixels
    ref = np.asarray(patchwise_max_weights_jax(jnp.asarray(w), patch))
    got = patchwise_max_weights(tt(w), patch).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < (got > 0).sum() < (w > 0).sum()


def test_nearest_sample_of_nms_field_matches_jax():
    rng = np.random.RandomState(7)
    w = patchwise_max_weights(tt(rng.rand(13, 18).astype(np.float32)), 4)
    u = np.concatenate([rng.uniform(-3, 21, 200),
                        [0.5, 1.5, 2.5, 16.5, 17.5, -0.6]]).astype(np.float32)
    v = np.concatenate([rng.uniform(-3, 16, 200),
                        [0.5, 1.5, 2.5, 11.5, 12.5, 13.2]]).astype(np.float32)
    ref = np.asarray(sample_weight_field_jax(jnp.asarray(w.numpy()), u, v,
                                             nms_active=True))
    got = sample_weight_field(w, tt(u), tt(v), nms_active=True).numpy()
    np.testing.assert_array_equal(got, ref)
    # bilinear sampling of the same field would shrink the survivors
    bil = sample_weight_field(w, tt(u), tt(v)).numpy()
    assert (bil < got - 1e-3).any()


# one step of each engine: tests/test_fused_perception.py's small size
H = W = 64
INTR_J = IntrJ(np.float32(150.0), np.float32(150.0), np.float32(32.0),
               np.float32(32.0))
SMALL = dict(vol_dim=(32, 32, 32), voxel_size=0.01, node_coverage=0.04,
             max_nodes=128, max_points=1024, max_depth_diff=0.05,
             use_motion_model=False, solver="gn_dense")


@pytest.fixture(scope="module")
def frames():
    centers = [np.array([0.0, 0.0, 0.6]) + np.array([0.006, 0.0, 0.002]) * i
               for i in range(2)]
    return textured_sphere_frames(centers, H, W, INTR_J, 0.1)


def one_step(frames, flow_tree, engine, use_mask=True, **flow):
    """(JAX info, JAX fusion, port info, port fusion) of one step after
    initialize, ``engine`` "fused" (register_frame_fused) or "stepwise"
    (register_frame), flow on with the settings ``flow``."""
    (tree, _), (depths, colors) = flow_tree, frames
    cfg_j = FusionConfigJ(
        graph=GraphConfigJ(node_coverage=0.04, min_neighbors=2),
        gn=GNConfigJ(linear_solver="cholesky", assembly="blocks", **GN),
        use_flow=True, **SMALL, **flow)
    fj = DynamicFusionJ(SeqJ(colors, depths, INTR_J), cfg_j,
                        flow_params=tree["pwc"],
                        mask_params=tree["mask"] if use_mask else None)
    return (_step(fj, engine)
            + one_step_port(frames, flow_tree, engine, use_mask, **flow))


def one_step_port(frames, flow_tree, engine="fused", use_mask=True, **flow):
    """(port info, port fusion) of one_step."""
    (_, (pwc, mask)), (depths, colors) = flow_tree, frames
    cfg = FusionConfig(graph=GraphConfig(node_coverage=0.04, min_neighbors=2),
                       gn=GNConfig(**GN), use_flow=True, **SMALL, **flow)
    ft = DynamicFusion(
        ArraySequence(colors, depths, Intrinsics(*(float(x) for x in INTR_J))),
        cfg, device="cpu", flow_net=pwc, mask_net=mask if use_mask else None)
    return _step(ft, engine)


def _step(f, engine):
    f.initialize(f.seq.load(0))
    if engine == "stepwise":
        info = f.register_frame(f.seq.load(1))
        info = [info[k] for k in ("final_loss", "n_correspondences",
                                  "n_visible_nodes")]
    else:
        sc, state, tables = f.build_fused(None)
        state, info = f.register_frame_fused(sc, state, tables,
                                             f.seq.load(1), None)
        f.adopt_fused_state(state)
        info = [float(x) for x in np.asarray(info)[:3]]
    return [info, f]


def assert_step_matches(info_j, fj, info_t, ft):
    assert info_t[1:] == info_j[1:]  # correspondences, visible nodes
    assert abs(info_t[0] - info_j[0]) <= 1e-4 * abs(info_j[0])
    n = fj.node_count
    assert ft.node_count == n
    for a, b in ((ft.warp.translations, fj.warp.translations),
                 (ft.warp.rotations, fj.warp.rotations)):
        np.testing.assert_allclose(a.numpy()[:n], np.asarray(b)[:n],
                                   rtol=0, atol=1e-5)


# each fused case another lift: fill on the sparse lift with PWC at 1/2,
# override on the sparse lift with patchwise NMS (which takes the dense
# lift in both packages), advect on the sparse lift with the knobs above
FUSED_CASES = {
    "fill": dict(flow_lift="sparse", flow_downscale=2),
    "override": dict(flow_lift="sparse", flow_mask_patch=4),
    "advect": dict(flow_lift="sparse", **ADVECT),
}


@pytest.fixture(scope="module")
def fused_runs(frames, flow_tree):
    return {mode: one_step(frames, flow_tree, "fused", flow_mode=mode, **kw)
            for mode, kw in FUSED_CASES.items()}


@pytest.mark.parametrize("mode", ["fill", "override", "advect"])
def test_fused_step_flow_mode_matches_jax(fused_runs, mode):
    assert_step_matches(*fused_runs[mode])


@pytest.mark.parametrize("mode", ["fill", "override", "advect"])
def test_stepwise_step_flow_mode_matches_jax(frames, flow_tree, mode):
    info_j, fj, info_t, ft = one_step(frames, flow_tree, "stepwise",
                                      flow_mode=mode, **ADVECT)
    assert_step_matches(info_j, fj, info_t, ft)


@pytest.mark.parametrize("engine", ["fused", "stepwise"])
def test_flow_without_masknet_matches_jax(frames, flow_tree, engine):
    """Weights are the flow's validity (JAX's ``max(corr_weight, ok)``
    branch); advect without MaskNet weighs its targets
    flow_advect_weight. Fused: advect on the sparse lift; stepwise:
    override on the dense lift."""
    mode = "advect" if engine == "fused" else "override"
    info_j, fj, info_t, ft = one_step(frames, flow_tree, engine,
                                      use_mask=False, flow_lift="sparse",
                                      flow_mode=mode, **ADVECT)
    assert_step_matches(info_j, fj, info_t, ft)


def test_flow_mode_changes_the_step(fused_runs):
    """The three fused cases give three different steps (each test above
    would pass on a setting the step ignored otherwise)."""
    t = {m: r[3].warp.translations.numpy() for m, r in fused_runs.items()}
    for a, b in (("fill", "override"), ("fill", "advect"),
                 ("override", "advect")):
        assert np.abs(t[a] - t[b]).max() > 1e-5, (a, b)


def test_bad_flow_settings_rejected():
    with pytest.raises(ValueError, match="flow_mode"):
        FusionConfig(flow_mode="telepathy")
    with pytest.raises(ValueError, match="flow_downscale"):
        FusionConfig(flow_downscale=0)
    # patchwise NMS takes the dense lift, whatever flow_lift and bf16 say
    FusionConfig(flow_lift="sparse", flow_bf16=True, mask_downscale=2,
                 flow_mask_patch=4)


@pytest.mark.parametrize("setting", [dict(flow_bf16=True),
                                     dict(mask_downscale=2)])
def test_dense_lift_runs_bf16_and_mask_downscale_in_f32(frames, flow_tree,
                                                        setting):
    """ROADMAP F16: the dense lift (the default) accepts flow_bf16 and
    mask_downscale and runs in f32 at full resolution, as JAX's fused step
    does (occlusionfusion_tpu/fusion/fused_step.py:308-309, :337-341): the
    port's step equals its plain dense step bit for bit and JAX's with the
    same setting at assert_step_matches' tolerances."""
    info_j, fj, info_t, ft = one_step(frames, flow_tree, "fused",
                                      flow_lift="dense", **setting)
    assert_step_matches(info_j, fj, info_t, ft)
    plain = one_step_port(frames, flow_tree, flow_lift="dense")
    assert info_t == plain[0]
    assert torch.equal(ft.warp.translations, plain[1].warp.translations)
    assert torch.equal(ft.warp.rotations, plain[1].warp.rotations)
