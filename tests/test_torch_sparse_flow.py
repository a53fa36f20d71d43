"""Port of the headline's perception settings against the JAX package on
the CPU: geometry/camera.py's resize_bilinear (jax.image.resize's
antialiased bilinear resize), fusion/flow_correspondence.py's sparse lift
flow_targets_at_points with the repo's checkpoints/flow.npz (f32, and
bf16 with MaskNet at half resolution), and fusion/fused_step.py's
deterministic target subsample of the Lepard branch.

Tolerances: the resize to 1e-6 (two sums of a few taps); the f32 sparse
lift to 1e-4 (m and weight), its validity exactly; the bf16 lift is held
to the JAX bf16 run with tests/test_fused_perception.py:390-430's bounds
(median target 2 mm, median weight 0.1: bf16 rounds at other places in
the two frameworks); the subsample picks the same pixels in the same
order (its points within 1e-6 m, the rounding of the back-projection,
where neighbouring pixels lie ~4 mm apart)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from occlusionfusion_tpu.fusion.flow_correspondence import (
    flow_targets_at_points as flow_targets_at_points_jax,
)
from occlusionfusion_tpu.fusion.fused_step import (
    _deterministic_target_subsample as subsample_jax,
    _rgbxyz_image as rgbxyz_jax,
)
from occlusionfusion_tpu.geometry.camera import Intrinsics as IntrJ
from occlusionfusion_tpu.models.checkpoint import normalize_indexed
from occlusionfusion_tpu.utils.snapshot import load_params
from occlusionfusion_tpu_torch.fusion.flow_correspondence import (
    flow_targets_at_points,
)
from occlusionfusion_tpu_torch.fusion.fused_step import (
    _deterministic_target_subsample,
    _rgbxyz_image,
)
from occlusionfusion_tpu_torch.geometry.camera import (
    Intrinsics,
    resize_bilinear,
)
from occlusionfusion_tpu_torch.models.checkpoint import (
    FLOW_NPZ,
    load_flow_nets,
)
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    textured_sphere_frames,
    tt,
)

H, W = 64, 96
INTR = Intrinsics(150.0, 150.0, W / 2, H / 2)
INTR_J = IntrJ(*(np.float32(x) for x in INTR))


@pytest.mark.parametrize("size,out", [
    ((16, 12), (8, 6)),  # x2
    ((64, 64), (16, 16)),  # x4
    ((15, 9), (7, 4)),  # odd sizes
    ((13, 17), (3, 5)),
    ((9, 11), (9, 5)),  # one axis only
    ((20, 20), (40, 40)),  # upsampling
])
def test_resize_bilinear_matches_jax(size, out):
    x = np.random.RandomState(sum(size)).randn(2, 3, *size).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 3) + out, method="bilinear")
    got = resize_bilinear(tt(x), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    """Two textured sphere frames 4 mm apart (the port's and JAX's
    RGB-XYZ images), query pixels, the JAX flow tree and the port's nets."""
    depths, colors = textured_sphere_frames(
        [[0.0, 0.0, 0.6], [0.002, 0.0, 0.603]], H, W, INTR, 0.1)
    rgbxyz = [_rgbxyz_image(tt(d), tt(c), INTR) for d, c in zip(depths,
                                                                 colors)]
    rgbxyz_j = [rgbxyz_jax(jnp.asarray(d), jnp.asarray(c), INTR_J)
                for d, c in zip(depths, colors)]
    uv = np.random.RandomState(0).uniform(
        [6, 6], [W - 6, H - 6], (300, 2)).astype(np.float32)
    tree = normalize_indexed(load_params(FLOW_NPZ))
    return rgbxyz, rgbxyz_j, uv, tree, load_flow_nets(device="cpu")


def _lift(pair, **kw):
    rgbxyz, rgbxyz_j, uv, tree, (pwc, mask) = pair
    ref = flow_targets_at_points_jax(tree["pwc"], *rgbxyz_j, jnp.asarray(uv),
                                     mask_params=tree["mask"], **kw)
    with torch.no_grad():
        got = flow_targets_at_points(pwc, *rgbxyz, tt(uv), mask, **kw)
    return [x.numpy() for x in got], [np.asarray(x) for x in ref]


@pytest.mark.parametrize("mask_downscale", [1, 2])
def test_sparse_lift_f32_matches_jax(pair, mask_downscale):
    (t, v, w), (t_j, v_j, w_j) = _lift(pair, mask_downscale=mask_downscale)
    np.testing.assert_array_equal(v, v_j)
    assert 100 < v.sum() < 300
    np.testing.assert_allclose(t, t_j, atol=1e-4)
    np.testing.assert_allclose(w, w_j, atol=1e-4)


def test_sparse_lift_bf16_half_res_mask_near_jax(pair):
    (t, v, w), (t_j, v_j, w_j) = _lift(pair, bf16=True, mask_downscale=2)
    both = v & v_j
    assert both.sum() > 0.95 * max(v.sum(), v_j.sum()) > 100
    assert np.median(np.linalg.norm(t[both] - t_j[both], axis=-1)) < 2e-3
    assert np.median(np.abs(w[both] - w_j[both])) < 0.1


@pytest.mark.parametrize("method", ["topk", "strided"])
@pytest.mark.parametrize("cap", [256, 2048])
def test_target_subsample_matches_jax(method, cap):
    """The same pixels, in the same order, for both methods; 2048 exceeds
    the sphere's valid pixels, so topk's tail is the invalid ones."""
    depth = textured_sphere_frames([[0.01, 0.0, 0.6]], H, W, INTR, 0.1)[0][0]
    p_j, v_j = jax.jit(lambda d: subsample_jax(d, INTR_J, cap, method))(
        jnp.asarray(depth))
    p, v = _deterministic_target_subsample(tt(depth), INTR, cap, method)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=0, atol=1e-6)
    assert 0 < v.sum() <= min(cap, (depth > 0).sum())
