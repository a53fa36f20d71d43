"""Port of the sparse bricked TSDF (fusion/bricks.py) against the JAX
package on tests/test_bricks.py's setup (a 64x64 sphere frame, 48^3
voxels of 6 mm, bricks of 8, 256 slots): active brick ids, the slot
table, the voxel points, the bricked integrate, ``scatter_to_dense`` and
the truncated-region mask of the scattered volume. Ids, slots, voxel points, weights,
colours, dense scatters and masks are bit-equal; the TSDF values within
1e-6 (the tolerance of tests/test_torch_tsdf.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from occlusionfusion_tpu.fusion import bricks as BRJ
from occlusionfusion_tpu.fusion import tsdf as TJ
from occlusionfusion_tpu_torch.fusion import bricks as BR
from occlusionfusion_tpu_torch.fusion import tsdf as T
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from test_bricks import INTR, setup  # noqa: F401  (module fixture)
from torch_port_impl import one_torch_thread, tt  # noqa: F401

INTR_T = Intrinsics(*(float(x) for x in INTR))


def _grid(grid_j):
    return BR.BrickGrid(*grid_j)


def _config(cfg_j):
    return T.TSDFConfig(cfg_j.vol_dim, cfg_j.voxel_size, cfg_j.trunc_margin)


@pytest.mark.parametrize("trunc_scale", [0.5, 1.0, 3.0])
def test_active_ids_and_slots_match_jax(setup, trunc_scale):  # noqa: F811
    """At the JAX default dilation, for truncation bands narrower than,
    equal to and wider than the setup's (3x spans several bricks)."""
    depth, _, cfg, grid, origin = setup
    trunc = cfg.trunc_margin * trunc_scale
    ids_j = BRJ.active_bricks_from_depth(grid, origin, depth, INTR, trunc,
                                         dilate=1)
    ids_t = BR.active_bricks_from_depth(_grid(grid), origin, depth, INTR_T,
                                        trunc)
    assert ids_t.dtype == ids_j.dtype and len(ids_t) > 0
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(BR.pack_brick_ids(_grid(grid), ids_t),
                                  BRJ.pack_brick_ids(grid, ids_j))
    assert _grid(grid).grid_dim == grid.grid_dim


def test_points_activation_matches_jax(setup):  # noqa: F811
    _, _, cfg, grid, origin = setup
    rng = np.random.RandomState(0)
    pts = origin + rng.rand(300, 3) * 0.28
    np.testing.assert_array_equal(
        BR.active_bricks_from_points(_grid(grid), origin, pts,
                                     cfg.trunc_margin),
        BRJ.active_bricks_from_points(grid, origin, pts, cfg.trunc_margin,
                                      dilate=1),
    )
    assert len(BR.active_bricks_from_points(_grid(grid), origin,
                                            np.zeros((0, 3)), 0.02)) == 0


def test_too_many_bricks_raise(setup):  # noqa: F811
    _, _, _, grid, _ = setup
    ids = np.arange(grid.max_bricks + 1, dtype=np.int32)
    with pytest.raises(ValueError, match="max_bricks"):
        BR.pack_brick_ids(_grid(grid), ids)


def _packed(setup_):
    depth, _, cfg, grid, origin = setup_
    ids = BRJ.active_bricks_from_depth(grid, origin, depth, INTR,
                                       cfg.trunc_margin, dilate=1)
    return BRJ.pack_brick_ids(grid, ids)


def test_voxel_points_match_jax(setup):  # noqa: F811
    _, _, _, grid, origin = setup
    packed = _packed(setup)
    vox_j, valid_j = BRJ.brick_voxel_points(grid, origin, packed)
    vox_t, valid_t = BR.brick_voxel_points(_grid(grid), origin, packed)
    assert vox_t.dtype == np.float32 and vox_t.shape == (256 * 512, 3)
    np.testing.assert_array_equal(vox_t, vox_j)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert 0 < valid_t.sum() < len(valid_t)


@pytest.mark.parametrize("steps", [1, 3])
def test_bricked_integrate_matches_jax(setup, steps):  # noqa: F811
    """The [MB, 8, 8, 8] state raveled in C order with the brick-valid
    mask, integrated ``steps`` times through jittered voxel positions."""
    depth, color, cfg, grid, origin = setup
    packed = _packed(setup)
    vox, valid = BRJ.brick_voxel_points(grid, origin, packed)
    st_j = BRJ.create_brick_volume(grid, origin)
    st_t = BR.create_brick_volume(_grid(grid), origin, "cpu")
    rng = np.random.RandomState(steps)
    for _ in range(steps):
        warped = vox + (rng.randn(*vox.shape) * 0.002).astype(np.float32)
        st_j = TJ.integrate(cfg, st_j, jnp.asarray(warped), jnp.asarray(valid),
                            jnp.asarray(depth), jnp.asarray(color), INTR)
        st_t = T.integrate(_config(cfg), st_t, tt(warped), tt(valid),
                           tt(depth), tt(color), INTR_T)
    assert st_t.tsdf.shape == (256, 8, 8, 8)
    np.testing.assert_array_equal(st_t.weight.numpy(), np.asarray(st_j.weight))
    np.testing.assert_array_equal(st_t.color.numpy(), np.asarray(st_j.color))
    np.testing.assert_allclose(st_t.tsdf.numpy(), np.asarray(st_j.tsdf),
                               atol=1e-6)
    assert st_t.weight.max() >= steps
    # free slots stay untouched
    free = torch.from_numpy(packed < 0)
    assert float(st_t.weight[free].abs().max()) == 0.0


def test_scatter_to_dense_and_mask_match_jax(setup):  # noqa: F811
    """Bit-equal dense scatters and masks; inside the active bricks the
    port's bricked volume equals its dense volume, as in the JAX test."""
    depth, color, cfg, grid, origin = setup
    packed = _packed(setup)
    vox, valid = BR.brick_voxel_points(_grid(grid), origin, packed)
    st = T.integrate(_config(cfg),
                     BR.create_brick_volume(_grid(grid), origin, "cpu"),
                     tt(vox), tt(valid), tt(depth), tt(color), INTR_T)
    tsdf_b, w_b = st.tsdf.numpy(), st.weight.numpy()
    d_t, w_t = BR.scatter_to_dense(_grid(grid), packed, tsdf_b, w_b)
    d_j, w_j = BRJ.scatter_to_dense(grid, packed, tsdf_b, w_b)
    assert d_t.shape == cfg.vol_dim
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(w_t, w_j)
    # the mask mesh extraction takes of a bricked volume
    m_t = T.truncated_region_mask(torch.from_numpy(d_t),
                                  torch.from_numpy(w_t)).numpy()
    np.testing.assert_array_equal(m_t.astype(np.uint8),
                                  BRJ.truncated_region_mask_np(d_j, w_j))
    assert m_t.any()

    dense = T.create_volume(_config(cfg), origin, "cpu")
    pts = T.voxel_world_points(_config(cfg), dense.origin)
    dense = T.integrate(_config(cfg), dense, pts,
                        torch.ones(len(pts), dtype=torch.bool), tt(depth),
                        tt(color), INTR_T)
    inside = np.zeros(cfg.vol_dim, bool)
    B = grid.brick
    GX, GY, GZ = grid.grid_dim
    for bid in packed[packed >= 0]:
        bx, by, bz = bid // (GY * GZ), (bid // GZ) % GY, bid % GZ
        inside[bx * B:(bx + 1) * B, by * B:(by + 1) * B,
               bz * B:(bz + 1) * B] = True
    np.testing.assert_array_equal(w_t[inside], dense.weight.numpy()[inside])
    np.testing.assert_allclose(d_t[inside], dense.tsdf.numpy()[inside],
                               atol=1e-6)


def test_create_brick_volume(setup):  # noqa: F811
    _, _, _, grid, origin = setup
    st = BR.create_brick_volume(_grid(grid), origin, "cpu")
    ref = BRJ.create_brick_volume(grid, origin)
    for a, b in zip(st, ref):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
