"""Port of ops/lbs.py and fusion/warpfield.py: the K2 twin against the JAX
warpfield.deform_points (2e-4 m, the JAX suite's own LBS tolerance), and
the kernel's origin-form arithmetic, emulated in numpy, against the twin."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from occlusionfusion_tpu.fusion import warpfield as WJ
from occlusionfusion_tpu.ops.lbs import _pack_transforms
from occlusionfusion_tpu_torch.fusion import warpfield as W
from occlusionfusion_tpu_torch.ops.lbs import (
    lbs_warp,
    lbs_warp_cuda,
    lbs_warp_torch,
    pack_transforms,
)
from torch_port_impl import random_pose_field, tt

TOL = 2e-4


def _field(P=900, N=64, seed=0):
    rng = np.random.RandomState(seed)
    nodes = (rng.rand(N, 3) * 0.4).astype(np.float32)
    pts = (rng.rand(P, 3) * 0.4).astype(np.float32)
    node_valid = np.ones(N, bool)
    node_valid[-5:] = False
    R, t = random_pose_field(N, seed + 1)
    warp_j = WJ.WarpFieldState(jnp.asarray(nodes), jnp.asarray(node_valid),
                               jnp.asarray(R), jnp.asarray(t))
    warp_t = W.WarpFieldState(tt(nodes), tt(node_valid), tt(R), tt(t))
    return pts, warp_j, warp_t


def test_skin_matches_jax():
    pts, warp_j, warp_t = _field()
    tab_j = WJ.skin(warp_j, jnp.asarray(pts), 0.03)
    tab_t = W.skin(warp_t, tt(pts), 0.03)
    np.testing.assert_array_equal(tab_t.valid.numpy(), np.asarray(tab_j.valid))
    assert tab_t.valid.any() and not tab_t.valid.all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_matches_deform_points(seed):
    pts, warp_j, warp_t = _field(seed=seed)
    tab_j = WJ.skin(warp_j, jnp.asarray(pts), 0.03)
    ref = np.asarray(WJ.deform_points(warp_j, jnp.asarray(pts), tab_j))
    got = lbs_warp_torch(tt(pts), tt(tab_j.anchors), tt(tab_j.weights),
                         tt(tab_j.valid), warp_t)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # unreachable points pass through
    inval = ~np.asarray(tab_j.valid)
    np.testing.assert_array_equal(got.numpy()[inval], pts[inval])


def test_pack_transforms_matches_jax():
    _, warp_j, warp_t = _field()
    np.testing.assert_allclose(
        pack_transforms(warp_t).numpy(), np.asarray(_pack_transforms(warp_j)),
        atol=1e-6, rtol=0,
    )


def test_kernel_arithmetic_matches_twin():
    """csrc/lbs.cu computes B = sum_k w_k T_k over origin-form rows, then
    y = B_R x + B_t (invalid points pass through); emulate it in numpy."""
    pts, warp_j, warp_t = _field(seed=5)
    tab = W.skin(warp_t, tt(pts), 0.03)
    T = pack_transforms(warp_t).numpy()
    a, w, ok = tab.anchors.numpy(), tab.weights.numpy(), tab.valid.numpy()
    B = np.einsum("pk,pkc->pc", w, T[a])
    y = np.stack([
        B[:, 0] * pts[:, 0] + B[:, 1] * pts[:, 1] + B[:, 2] * pts[:, 2] + B[:, 9],
        B[:, 3] * pts[:, 0] + B[:, 4] * pts[:, 1] + B[:, 5] * pts[:, 2] + B[:, 10],
        B[:, 6] * pts[:, 0] + B[:, 7] * pts[:, 1] + B[:, 8] * pts[:, 2] + B[:, 11],
    ], -1)
    y = np.where(ok[:, None], y, pts)
    twin = lbs_warp_torch(tt(pts), tab.anchors, tab.weights, tab.valid, warp_t)
    np.testing.assert_allclose(y, twin.numpy(), atol=TOL, rtol=0)


def test_front_door_uses_twin_on_cpu():
    pts, _, warp_t = _field(seed=7)
    tab = W.skin(warp_t, tt(pts), 0.03)
    a = lbs_warp(tt(pts), tab.anchors, tab.weights, tab.valid, warp_t)
    b = lbs_warp_torch(tt(pts), tab.anchors, tab.weights, tab.valid, warp_t)
    assert torch.equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    pts, _, warp_t = _field(P=20, seed=8)
    tab = W.skin(warp_t, tt(pts), 0.03)
    with pytest.raises(ValueError, match="CUDA"):
        lbs_warp_cuda(tt(pts), tab.anchors, tab.weights, tab.valid, warp_t)
