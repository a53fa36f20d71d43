"""Port of fusion/tsdf.py (dense volume) and geometry/camera.py against the
JAX package: integrate with bit-equal colour and weight, the visibility
test, the truncated-region mask and the voxel grid."""

import numpy as np
import pytest
import jax.numpy as jnp

from occlusionfusion_tpu.fusion import tsdf as TJ
from occlusionfusion_tpu.geometry.camera import Intrinsics as IntrJ
from occlusionfusion_tpu.geometry.camera import backproject_depth as bp_jax
from occlusionfusion_tpu_torch.fusion import tsdf as T
from occlusionfusion_tpu_torch.geometry.camera import (
    Intrinsics,
    backproject_depth,
)
from torch_port_impl import one_torch_thread, tt  # noqa: F401

H, W = 40, 48
FX, FY, CX, CY = 60.0, 62.0, 23.5, 19.25
DIM = (20, 18, 16)


def _frame(seed):
    rng = np.random.RandomState(seed)
    depth = (0.8 + 0.3 * rng.rand(H, W)).astype(np.float32)
    depth[rng.rand(H, W) < 0.1] = 0.0
    color = (rng.rand(H, W, 3) * 255).astype(np.float32)
    return depth, color


def _intr():
    return (IntrJ(np.float32(FX), np.float32(FY), np.float32(CX),
                  np.float32(CY)), Intrinsics(FX, FY, CX, CY))


def _config(mod):
    return mod.TSDFConfig(vol_dim=DIM, voxel_size=0.02, trunc_margin=0.06)


def test_volume_grid_matches_jax():
    depth, _ = _frame(0)
    ij, it = _intr()
    o_j = TJ.volume_bounds_from_frame(depth, ij, DIM, 0.02)
    o_t = T.volume_bounds_from_frame(depth, it, DIM, 0.02)
    np.testing.assert_array_equal(o_t, o_j)
    v_j = TJ.voxel_world_points(_config(TJ), jnp.asarray(o_j, jnp.float32))
    v_t = T.voxel_world_points(_config(T), tt(o_j.astype(np.float32)))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)


def test_backproject_matches_jax():
    depth, _ = _frame(1)
    ij, it = _intr()
    np.testing.assert_allclose(backproject_depth(tt(depth), it).numpy(),
                               np.asarray(bp_jax(jnp.asarray(depth), ij)),
                               atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3])
def test_integrate_matches_jax(steps):
    ij, it = _intr()
    depth0, _ = _frame(2)
    origin = TJ.volume_bounds_from_frame(depth0, ij, DIM, 0.02)
    st_j = TJ.create_volume(_config(TJ), origin)
    st_t = T.create_volume(_config(T), origin, "cpu")
    vox = np.asarray(TJ.voxel_world_points(_config(TJ), st_j.origin))
    rng = np.random.RandomState(3)
    for s in range(steps):
        depth, color = _frame(10 + s)
        warped = vox + (rng.randn(*vox.shape) * 0.01).astype(np.float32)
        valid = rng.rand(vox.shape[0]) > 0.1
        st_j = TJ.integrate(_config(TJ), st_j, jnp.asarray(warped),
                            jnp.asarray(valid), jnp.asarray(depth),
                            jnp.asarray(color), ij)
        st_t = T.integrate(_config(T), st_t, tt(warped), tt(valid), tt(depth),
                           tt(color), it)
    np.testing.assert_array_equal(st_t.weight.numpy(), np.asarray(st_j.weight))
    np.testing.assert_array_equal(st_t.color.numpy(), np.asarray(st_j.color))
    np.testing.assert_allclose(st_t.tsdf.numpy(), np.asarray(st_j.tsdf),
                               atol=1e-6)
    assert st_t.weight.max() >= 1 and st_t.color.max() > 0


def test_visibility_matches_jax():
    ij, it = _intr()
    depth, _ = _frame(4)
    rng = np.random.RandomState(5)
    pts = np.stack([rng.uniform(-0.4, 0.4, 500), rng.uniform(-0.4, 0.4, 500),
                    rng.uniform(-0.2, 1.3, 500)], -1).astype(np.float32)
    vis_j, diff_j = TJ.check_visibility(jnp.asarray(pts), jnp.asarray(depth),
                                        ij, 0.06)
    vis_t, diff_t = T.check_visibility(tt(pts), tt(depth), it, 0.06)
    np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
    np.testing.assert_allclose(diff_t.numpy(), np.asarray(diff_j), atol=1e-6)


def test_truncated_region_mask_matches_jax():
    rng = np.random.RandomState(6)
    tsdf = np.clip(rng.randn(*DIM) * 0.5, -1, 1).astype(np.float32)
    weight = (rng.rand(*DIM) > 0.3).astype(np.float32)
    m_j = TJ.truncated_region_mask(jnp.asarray(tsdf), jnp.asarray(weight))
    m_t = T.truncated_region_mask(tt(tsdf), tt(weight))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert m_t.any()
