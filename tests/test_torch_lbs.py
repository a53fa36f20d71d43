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
    MAX_NODES,
    lbs_warp,
    lbs_warp_cuda,
    lbs_warp_torch,
    pack_transforms,
)
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    random_pose_field,
    tt,
)

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


def _kernel_table(warp):
    """The origin-form table csrc/lbs.cu forms in shared memory, in f32:
    row-major R, then t' = (t + g) - R g."""
    g = warp.node_positions.numpy()
    R = warp.rotations.numpy()
    t = warp.translations.numpy()
    Rg = R[:, :, 0] * g[:, None, 0] + R[:, :, 1] * g[:, None, 1] \
        + R[:, :, 2] * g[:, None, 2]
    return np.concatenate([R.reshape(-1, 9), (t + g) - Rg], -1)


def test_kernel_table_matches_pack_transforms():
    _, _, warp_t = _field(seed=4)
    np.testing.assert_allclose(_kernel_table(warp_t),
                               pack_transforms(warp_t).numpy(), atol=1e-6,
                               rtol=0)


def test_kernel_arithmetic_matches_twin():
    """csrc/lbs.cu forms the origin-form table itself, computes B = sum_k
    w_k T_k over its rows, then y = B_R x + B_t; an invalid point keeps
    its staged xyz and passes through bit for bit. Emulated in numpy f32
    over the warps' chunks of 32 points (the last one partial)."""
    pts, warp_j, warp_t = _field(P=901, seed=5)
    tab = W.skin(warp_t, tt(pts), 0.03)
    T = _kernel_table(warp_t)
    a, w, ok = tab.anchors.numpy(), tab.weights.numpy(), tab.valid.numpy()
    assert ok.any() and not ok.all()
    N = T.shape[0]
    y = np.empty_like(pts)
    for base in range(0, pts.shape[0], 32):
        stage = pts[base : base + 32].copy()
        for lane in np.flatnonzero(ok[base : base + 32]):
            p = base + lane
            B = np.zeros(12, np.float32)
            for k in range(4):
                B += w[p, k] * T[min(max(a[p, k], 0), N - 1)]
            x = stage[lane]
            stage[lane] = [B[0] * x[0] + B[1] * x[1] + B[2] * x[2] + B[9],
                           B[3] * x[0] + B[4] * x[1] + B[5] * x[2] + B[10],
                           B[6] * x[0] + B[7] * x[1] + B[8] * x[2] + B[11]]
        y[base : base + 32] = stage
    twin = lbs_warp_torch(tt(pts), tab.anchors, tab.weights, tab.valid, warp_t)
    np.testing.assert_allclose(y, twin.numpy(), atol=TOL, rtol=0)
    np.testing.assert_array_equal(y[~ok], twin.numpy()[~ok])
    np.testing.assert_array_equal(y[~ok], pts[~ok])


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


# the node table must fit in shared memory: one node more than fits is
# refused before any launch; at the limit the wrapper goes on to its
# tensor checks
@pytest.mark.parametrize("extra, match", [(0, "CUDA tensor"), (1, "at most")])
def test_kernel_wrapper_refuses_too_many_nodes(extra, match):
    N, P = MAX_NODES + extra, 8
    warp = W.create_warpfield(torch.zeros((N, 3)),
                              torch.ones(N, dtype=torch.bool))
    with pytest.raises(ValueError, match=match):
        lbs_warp_cuda(torch.zeros((P, 3)),
                      torch.zeros((P, 4), dtype=torch.int32),
                      torch.zeros((P, 4)), torch.ones(P, dtype=torch.bool),
                      warp)


# K2 reads each voxel's anchors and weights as one 16-byte vector: a
# contiguous view whose base is off a 16-byte boundary is refused before
# any launch
@pytest.mark.parametrize("name", ["anchors", "weights"])
def test_kernel_wrapper_refuses_unaligned_tables(name):
    P, N = 8, 16
    warp = W.create_warpfield(torch.zeros((N, 3)),
                              torch.ones(N, dtype=torch.bool))
    args = {"anchors": torch.zeros((P, 4), dtype=torch.int32),
            "weights": torch.zeros((P, 4))}
    flat = torch.zeros(P * 4 + 1, dtype=args[name].dtype)
    args[name] = flat[1:].view(P, 4)
    assert args[name].is_contiguous() and args[name].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte-aligned"):
        lbs_warp_cuda(torch.zeros((P, 3)), args["anchors"], args["weights"],
                      torch.ones(P, dtype=torch.bool), warp)
