"""N-ICP's chamfer and rendered costs in the port against the JAX package
on the CPU: the point-splat rasterizer (ops/rasterize.py: depth, mask,
the nearest point's colour; the gradient through the z-buffer where
points tie), the truncated chamfer, silhouette and projective-depth
costs with their gradients (the silhouette's is zero in both: ROADMAP
F15), and nicp.solve with the rendered costs on a target depth map.

Tolerances: depth maps and masks equal (the same f32 projections and
rounding); costs within 1e-6 relative and gradients within 1e-5 of their
scale (another summation order); the solve as tests/test_torch_nicp.py
(loss history 1e-5 relative, R and t 2e-5) over 5 Adam steps, since the
hard splat makes the objective noisy in the pixels
(tests/test_nicp.py:171-176)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occlusionfusion_tpu.geometry.camera import Intrinsics as IntrinsicsJ
from occlusionfusion_tpu.ops import rasterize as RJ
from occlusionfusion_tpu.solvers import losses as LJ
from occlusionfusion_tpu.solvers import nicp as NJ
from occlusionfusion_tpu_torch.ops import rasterize as RT
from occlusionfusion_tpu_torch.solvers import losses as LT
from occlusionfusion_tpu_torch.solvers import nicp as NT
from test_torch_nicp import (
    assert_result,
    build_problem,
    jax_problem,
    to_torch,
)
from torch_port_impl import (  # noqa: F401
    jax_chamfer_table,
    one_torch_thread,
    tt,
)

INTR = (60.0, 62.0, 24.0, 20.0)
HW = (40, 48)
# the JAX rasterizer compiled whole (far fewer XLA compiles than its ops
# one by one)
render_depth_j = jax.jit(RJ.render_depth,
                         static_argnames=("image_hw", "splat_radius"))
render_depth_color_j = jax.jit(RJ.render_depth_color,
                               static_argnames=("image_hw", "splat_radius"))


def _cloud(seed, n=400):
    """Points in front of the camera, some off the image, some behind it,
    and a validity mask."""
    rng = np.random.RandomState(seed)
    p = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n),
                  rng.uniform(0.6, 1.4, n)], -1).astype(np.float32)
    p[:5, 2] = -0.3
    return p, rng.rand(n) > 0.1


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_render_depth_and_color_match_jax(radius):
    pts, valid = _cloud(radius)
    colors = (np.random.RandomState(5).rand(pts.shape[0], 3) * 255).astype(
        np.float32)
    dj, cj, mj = render_depth_color_j(
        jnp.asarray(pts), jnp.asarray(colors), IntrinsicsJ(*INTR),
        image_hw=HW, point_valid=jnp.asarray(valid), splat_radius=radius)
    dt, ct, mt = RT.render_depth_color(tt(pts), tt(colors), INTR, HW,
                                       tt(valid), splat_radius=radius)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    d2, m2 = RT.render_depth(tt(pts), INTR, HW, None, splat_radius=radius)
    dj2, mj2 = render_depth_j(jnp.asarray(pts), IntrinsicsJ(*INTR),
                              image_hw=HW, splat_radius=radius)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(dj2))
    assert mt.sum() > 100


def test_render_gradient_through_ties_matches_jax():
    """Two points at one pixel and one depth (a tie inside one offset's
    scatter-min), two points one pixel apart at one depth (a tie across
    offsets in the running minimum), and a nearer point that wins: the
    gradient of a weighted sum of the depth map reaches the points as in
    the JAX package."""
    fx, fy, cx, cy = INTR
    z = np.float32(1.0)
    uv = [(10, 10), (10, 10), (20, 15), (21, 15), (30, 25), (30, 25)]
    zs = [z, z, z, z, np.float32(0.9), np.float32(1.1)]
    pts = np.asarray([[(u - cx) * d / fx, (v - cy) * d / fy, d]
                      for (u, v), d in zip(uv, zs)], np.float32)
    wmap = np.random.RandomState(0).rand(*HW).astype(np.float32)

    def fj(p):
        d, _ = RJ.render_depth(p, IntrinsicsJ(*INTR), HW, None, 1)
        return jnp.sum(d * wmap)

    gj = np.asarray(jax.jit(jax.grad(fj))(jnp.asarray(pts)))
    p = tt(pts).requires_grad_(True)
    d, _ = RT.render_depth(p, INTR, HW, None, 1)
    (gt,) = torch.autograd.grad(torch.sum(d * tt(wmap)), p)
    assert gj[0, 2] == gj[1, 2] != 0 and gj[5, 2] == 0
    np.testing.assert_allclose(gt.numpy(), gj, atol=1e-5 * np.abs(gj).max())


def test_chamfer_cost_and_gradient_match_jax():
    rng = np.random.RandomState(3)
    src = (rng.randn(300, 3) * 0.2 + [0, 0, 1.5]).astype(np.float32)
    tgt = (src[rng.permutation(300)[:250]]
           + rng.randn(250, 3) * 0.01).astype(np.float32)
    sv, tv = rng.rand(300) > 0.1, rng.rand(250) > 0.2
    key = jax.random.PRNGKey(0)
    table = jax_chamfer_table(0, 200, 300, 250)[0]  # drawn from key

    def fj(s, t):
        return LJ.truncated_chamfer_cost(key, s, t, jnp.asarray(sv),
                                         jnp.asarray(tv), 200, 0.05)

    # eager: the port's k-NN rounds as XLA's plain CPU program does; the
    # compiled one rounds the distances otherwise (3.7e-6 of this loss)
    vj, (gsj, gtj) = jax.value_and_grad(fj, argnums=(0, 1))(
        jnp.asarray(src), jnp.asarray(tgt))
    s, t = tt(src).requires_grad_(True), tt(tgt).requires_grad_(True)
    v = LT.truncated_chamfer_cost(s, t, tt(table[0]), tt(table[1]), tt(sv),
                                  tt(tv), 0.05)
    gs, gt = torch.autograd.grad(v, (s, t))
    np.testing.assert_allclose(float(v), float(vj), rtol=1e-6)
    for g, r in ((gs, gsj), (gt, gtj)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max())


def test_rendered_costs_match_jax_and_silhouette_has_no_gradient():
    """The projective-depth cost and its gradient through the splat; the
    silhouette cost's value, and its gradient, zero in both packages
    (F15: the boolean splat mask is cast to f32)."""
    pts, valid = _cloud(7)
    tgt_pts, _ = _cloud(8)
    tdepth, tmask = RT.render_depth(tt(tgt_pts), INTR, HW)

    def fj(p):
        d, m = RJ.render_depth(p, IntrinsicsJ(*INTR), HW, jnp.asarray(valid))
        return (LJ.projective_depth_cost(d, jnp.asarray(tdepth.numpy())),
                LJ.silhouette_cost(m, jnp.asarray(tmask.numpy())))

    (dj, sj) = jax.jit(fj)(jnp.asarray(pts))
    gdj, gsj = (np.asarray(jax.jit(jax.grad(lambda p, i=i: fj(p)[i]))(
        jnp.asarray(pts))) for i in (0, 1))
    p = tt(pts).requires_grad_(True)
    d, m = RT.render_depth(p, INTR, HW, tt(valid))
    dc = LT.projective_depth_cost(d, tdepth)
    sc = LT.silhouette_cost(m, tmask)
    (gd,) = torch.autograd.grad(dc, p)
    np.testing.assert_allclose(float(dc), float(dj), rtol=1e-6)
    np.testing.assert_allclose(float(sc), float(sj), rtol=1e-6)
    np.testing.assert_allclose(gd.numpy(), gdj, atol=1e-5 * np.abs(gdj).max())
    assert float(sc) > 0 and np.abs(gdj).max() > 0
    assert not np.any(gsj) and not sc.requires_grad


def _rendered_problem(seed):
    """tests/test_torch_nicp.py's problem moved 1.5 m in front of a camera
    with the target points' depth map as the rendered costs' target."""
    p = build_problem(seed)
    off = np.asarray([0.0, 0.0, 1.5], np.float32)
    p = p._replace(source_points=p.source_points + off,
                   nodes=p.nodes + off, target_points=p.target_points + off,
                   motion_targets=p.motion_targets + off)
    tdepth, _ = RT.render_depth(tt(p.target_points), INTR, HW,
                                tt(p.point_valid))
    return p._replace(render_intrinsics=np.asarray(INTR, np.float32),
                      target_depth=tdepth.numpy())


def test_solve_with_rendered_costs_matches_jax():
    problem = _rendered_problem(2)
    cfg = NT.NICPConfig(iters=5, w_silh=0.5, w_depth=2.0, render_hw=HW)
    ref = NJ.solve(jax_problem(problem), cfg)
    got = NT.solve(to_torch(problem), cfg)
    assert_result(ref, got)
    base = NT.solve(to_torch(problem), NT.NICPConfig(iters=5))
    assert float(got.loss_history[0]) != float(base.loss_history[0])


def test_default_chamfer_table_is_fixed_and_in_range():
    cfg = NT.NICPConfig(iters=7, chamfer_samples=50)
    a = NT.default_chamfer_table(cfg, 40, 300)
    b = NT.default_chamfer_table(cfg, 40, 300)
    assert a.shape == (8, 2, 50) and torch.equal(a, b)
    assert int(a[:, 0, :40].max()) < 40 and int(a[:, 0, 40:].max()) == 0
    assert int(a[:, 1].max()) < 300 and int(a.min()) >= 0
