"""Shared helpers of the tests/test_torch_*.py port tests: the same numpy
inputs go to a JAX function and to its PyTorch port on the CPU."""

import numpy as np
import torch

import jax.numpy as jnp


def tt(x, dtype=None):
    """numpy / jax array -> CPU torch tensor (same dtype unless given)."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def gn_problem_to_torch(problem):
    """A JAX GNProblem -> the port's GNProblem (CPU tensors)."""
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNProblem

    f = {}
    for name in GNProblem._fields:
        a = np.array(getattr(problem, name))
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        f[name] = torch.from_numpy(a)
    return GNProblem(**f)


def random_pose_field(n, seed, rot=0.3, trans=0.04):
    """Random (R [n, 3, 3], t [n, 3]) as numpy f32, via the JAX so3_exp."""
    from occlusionfusion_tpu.geometry.so3 import so3_exp

    rng = np.random.RandomState(seed)
    R = np.asarray(so3_exp(jnp.asarray(rng.randn(n, 3).astype(np.float32) * rot)))
    t = (rng.randn(n, 3) * trans).astype(np.float32)
    return R, t


def hat_entry(v, i, j):
    """hat(v)[i][j] by the index rule of the CUDA kernels' hat_entry
    (occlusionfusion_tpu_torch/csrc/accumulate.cuh), over v's last axis."""
    if j == i:
        return np.zeros_like(v[..., 0])
    return -v[..., (i + 2) % 3] if j == (i + 1) % 3 else v[..., (i + 1) % 3]


def assert_knn_equivalent(d2_a, idx_a, d2_b, idx_b, queries, refs, atol):
    """Two k-NN results agree: sorted distances within ``atol``, and every
    row's anchor set equal except where the two differ only among refs at
    (near-)equal distance — the order among ties is free."""
    d2_a, d2_b = np.asarray(d2_a), np.asarray(d2_b)
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    np.testing.assert_allclose(d2_a, d2_b, atol=atol, rtol=0)
    sa = np.sort(idx_a, axis=1)
    sb = np.sort(idx_b, axis=1)
    for row in np.flatnonzero(np.any(sa != sb, axis=1)):
        q = np.asarray(queries)[row]
        for idx, d2 in ((idx_a[row], d2_b[row]), (idx_b[row], d2_a[row])):
            true = np.sum((np.asarray(refs)[idx] - q) ** 2, axis=1)
            np.testing.assert_allclose(np.sort(true), d2, atol=10 * atol)


def textured_sphere_frames(centers, h, w, intr, r):
    """(depths, colors) of a sphere at each centre, ray-cast in closed form
    as in test_fusion_e2e.sphere_depth, with a smooth procedural RGB
    texture fixed to its surface (a function of the surface normal), so
    that optical flow has something to follow. Background depth 0, grey."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([(u - float(intr.cx)) / float(intr.fx),
                  (v - float(intr.cy)) / float(intr.fy), np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depths, colors = [], []
    for c in centers:
        c = np.asarray(c, np.float32)
        b = d @ c
        disc = b * b - (c @ c - r * r)
        t = b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (t > 0)
        depths.append(np.where(hit, t * d[..., 2], 0.0).astype(np.float32))
        n = (t[..., None] * d - c) / r
        tex = np.stack([np.sin(12 * n[..., 0] + 3 * n[..., 1]),
                        np.sin(10 * n[..., 1] - 5 * n[..., 2]),
                        np.sin(9 * n[..., 2] + 7 * n[..., 0])], -1)
        colors.append(np.where(hit[..., None], 128 + 100 * tex, 128.0)
                      .astype(np.float32))
    return depths, colors
