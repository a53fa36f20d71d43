"""Port of the Lepard matcher (geometry/kabsch.py's sync-free
weighted_kabsch, models/kpconv.py, models/transformer3d.py,
models/lepard.py and models/checkpoint.py's Lepard loader) against the
JAX package on the CPU, with the repo's checkpoints/lepard_trained.npz
carried across by the port's loader, at the JAX suite's small pyramid
(tests/test_fused_perception.py:62-66: level sizes 128/48/24/12).

Tolerances: the rigid fit to 1e-5 (the JAX SVD and the port's Horn
quaternion form solve the same problem; both round in f32); the
pyramid's centres to f32 rounding and its neighbour tables exactly; the
encoder's features to 1e-5 of their scale (sums of up to 30 x 15 x 512
terms in another order); matches exactly; flows to 1e-5 m."""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from occlusionfusion_tpu.geometry.kabsch import (
    weighted_kabsch as weighted_kabsch_jax,
)
from occlusionfusion_tpu.geometry.so3 import so3_exp
from occlusionfusion_tpu.models import kpconv as KJ
from occlusionfusion_tpu.models import lepard as LJ
from occlusionfusion_tpu.models import transformer3d as TJ
from occlusionfusion_tpu.models.checkpoint import (
    load_lepard_checkpoint as load_lepard_checkpoint_jax,
)
from occlusionfusion_tpu_torch.geometry.kabsch import weighted_kabsch
from occlusionfusion_tpu_torch.models import kpconv as K
from occlusionfusion_tpu_torch.models import lepard as L
from occlusionfusion_tpu_torch.models import transformer3d as TR
from occlusionfusion_tpu_torch.models.checkpoint import (
    LEPARD_NPZ,
    lepard_params_from_jax,
    load_lepard_checkpoint,
)
from torch_port_impl import one_torch_thread, tt  # noqa: F401

SMALL_LEVELS = (128, 48, 24, 12)


def small(config):
    pyr = config.kpfcn.pyramid._replace(level_sizes=SMALL_LEVELS)
    return config._replace(kpfcn=config.kpfcn._replace(pyramid=pyr))


@pytest.fixture(scope="module")
def nets():
    """(JAX params, JAX small config, port's small LepardNet, config)."""
    params, cfg_j = load_lepard_checkpoint_jax(LEPARD_NPZ)
    net, cfg = load_lepard_checkpoint(device="cpu")
    net_s, cfg_s = load_lepard_checkpoint(device="cpu", config=small(cfg))
    assert net.config == cfg
    return params, small(cfg_j), net_s, cfg_s


def sphere_cap(rng, n, center, r=0.1):
    """Points on the camera-facing half of a sphere (a depth view)."""
    v = rng.randn(n, 3)
    v[:, 2] = -np.abs(v[:, 2])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (np.asarray(center) + r * v).astype(np.float32)


def clouds(seed=0):
    """A deformed-model cloud (2048 points, the last 100 invalid) and a
    target depth cloud (512 points) moved 4 mm, at 1 m."""
    rng = np.random.RandomState(seed)
    src = sphere_cap(rng, 2048, [0.0, 0.0, 1.0])
    tgt = sphere_cap(rng, 512, [0.004, 0.0, 1.004])
    sv = np.ones(2048, bool)
    sv[-100:] = False
    return src, sv, tgt, np.ones(512, bool)


@pytest.mark.parametrize("case", ["random", "planar", "reflected",
                                  "near_identity", "zero_weights"])
def test_weighted_kabsch_matches_jax(case):
    rng = np.random.RandomState(7)
    src = rng.randn(4, 60, 3).astype(np.float32)
    if case == "planar":
        src[..., 2] = 0.0
    R0 = np.asarray(so3_exp(jnp.asarray(rng.randn(4, 3).astype(np.float32))))
    dst = (np.einsum("bij,bnj->bni", R0, src) + rng.randn(4, 1, 3)
           + 0.01 * rng.randn(4, 60, 3)).astype(np.float32)
    if case == "reflected":
        dst = dst * np.array([1.0, 1.0, -1.0], np.float32)
    if case == "near_identity":
        dst = (src + 1e-4 * rng.randn(4, 60, 3)).astype(np.float32)
    w = rng.rand(4, 60).astype(np.float32)
    if case == "zero_weights":
        w[:] = 0.0
    R_j, t_j = weighted_kabsch_jax(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(w))
    R, t = weighted_kabsch(tt(src), tt(dst), tt(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)


def test_checkpoint_loads_as_jax(nets):
    """The loader maps every array of the npz, the positioning layer has
    none (its empty dict is dropped by the flat npz), and the side-car's
    configuration matches the JAX loader's field by field."""
    params, _, _, _ = nets
    net, cfg = load_lepard_checkpoint(device="cpu")
    data = np.load(LEPARD_NPZ)
    sd = net.state_dict()
    assert len(sd) == len(data.files)
    for key in data.files:
        np.testing.assert_array_equal(sd[key.replace("/", ".")].numpy(),
                                      data[key])
    assert not list(net.reposition.layers[2].parameters())
    _, cfg_j = load_lepard_checkpoint_jax(LEPARD_NPZ)
    assert json.dumps(cfg, default=list) == json.dumps(cfg_j, default=list)
    assert sum(p.numel() for p in net.parameters()) > 18_000_000


def test_legacy_single_block_params_map():
    """A resnetb list saved as one bare block (the JAX _as_blocks legacy
    case) maps to block 0."""
    blk = {n: {"w": np.zeros((2, 2), np.float32)} for n in ("down", "up")}
    tree = {"kpfcn": {"enc": {"0": {"res": blk, "strided": blk}}},
            "proj": {"w": np.ones((1, 1), np.float32)}}
    sd = lepard_params_from_jax(tree)
    assert set(sd) == {"kpfcn.enc.0.res.0.down.w", "kpfcn.enc.0.res.0.up.w",
                       "kpfcn.enc.0.strided.down.w",
                       "kpfcn.enc.0.strided.up.w", "proj.w"}


def test_grid_subsample_matches_jax():
    src, sv, _, _ = clouds()
    pts = (src - src.mean(0)) * 3.0  # the scale scene_flow normalizes to
    c_j, v_j = jax.jit(lambda p, v: KJ.grid_subsample(p, v, 0.06, 256))(
        jnp.asarray(pts), jnp.asarray(sv))
    c, v = K.grid_subsample(tt(pts), tt(sv), 0.06, 256)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    assert 20 < v.sum() < 256
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-7)


def test_pyramid_matches_jax(nets):
    """Neighbour tables hold the same supports row by row. Their order
    within a row is compared sorted: XLA's jitted program itself orders
    two near-equal distances differently from its op-by-op run (which
    the port matches entry for entry), and KPConv's sum and the max pool
    do not depend on it."""
    _, cfg_j, _, cfg = nets
    src, sv, _, _ = clouds(1)
    pts = (src - src.mean(0)) * 3.0
    lev_j = jax.jit(lambda p, v: KJ.build_pyramid(p, v, cfg_j.kpfcn.pyramid))(
        jnp.asarray(pts), jnp.asarray(sv))
    lev = K.build_pyramid(tt(pts), tt(sv), cfg.kpfcn.pyramid)
    assert len(lev) == len(lev_j) == 4
    for a, b in zip(lev, lev_j):
        np.testing.assert_allclose(a.points.numpy(), np.asarray(b.points),
                                   atol=1e-7)
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
        for name in ("neighbors", "pool"):
            if getattr(b, name) is None:
                assert getattr(a, name) is None
            else:
                np.testing.assert_array_equal(
                    np.sort(getattr(a, name).numpy(), axis=1),
                    np.sort(np.asarray(getattr(b, name)), axis=1))
        if b.up is not None:
            np.testing.assert_array_equal(a.up.numpy(), np.asarray(b.up))


def test_kpfcn_encode_matches_jax(nets):
    params, cfg_j, net, cfg = nets
    src, sv, _, _ = clouds(2)
    pts = (src - src.mean(0)) * 3.0
    f_j, c_j = jax.jit(lambda prm, p, v: KJ.kpfcn_encode(
        prm, cfg_j.kpfcn, KJ.build_pyramid(p, v, cfg_j.kpfcn.pyramid)))(
        params["kpfcn"], jnp.asarray(pts), jnp.asarray(sv))
    with torch.no_grad():
        f, c = K.kpfcn_encode(net.kpfcn, K.build_pyramid(
            tt(pts), tt(sv), cfg.kpfcn.pyramid))
    f_j = np.asarray(f_j)
    assert f.shape == f_j.shape == (SMALL_LEVELS[2], cfg.kpfcn.out_dim)
    np.testing.assert_allclose(f.numpy(), f_j, atol=1e-5 * np.abs(f_j).max())
    np.testing.assert_array_equal(c.valid.numpy(), np.asarray(c_j.valid))


def test_reposition_transformer_matches_jax(nets):
    params, cfg_j, net, _ = nets
    rng = np.random.RandomState(3)
    S, T, D = 24, 20, 256
    fs = rng.randn(S, D).astype(np.float32)
    ft = rng.randn(T, D).astype(np.float32)
    ps = rng.randn(S, 3).astype(np.float32) * 0.3
    pt = (ps[:T] + 0.02).astype(np.float32)
    vs = np.arange(S) < 21
    vt = np.arange(T) < 18
    out_j = jax.jit(lambda prm, *a: TJ.reposition_transformer(
        prm, cfg_j.reposition, *a))(
        params["reposition"], *(jnp.asarray(x) for x in (
            fs, ft, ps, pt, vs, vt)))
    with torch.no_grad():
        out = TR.reposition_transformer(
            net.reposition, *(tt(x) for x in (fs, ft, ps, pt, vs, vt)))
    for a, b in zip(out, out_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0))


def test_scene_flow_matches_jax(nets):
    params, cfg_j, net, _ = nets
    src, sv, tgt, tv = clouds(4)
    flow_j, mask_j, m_j = jax.jit(
        lambda *a: LJ.scene_flow(params, cfg_j, *a)
    )(*(jnp.asarray(x) for x in (src, sv, tgt, tv)))
    with torch.no_grad():
        flow, mask, m = L.scene_flow(net, *(tt(x) for x in (src, sv, tgt, tv)))
    assert m.match_valid.sum() > 5 and mask.sum() > 1000
    np.testing.assert_array_equal(m.match_valid.numpy(),
                                  np.asarray(m_j.match_valid))
    np.testing.assert_array_equal(m.match_tgt.numpy()[m.match_valid.numpy()],
                                  np.asarray(m_j.match_tgt)[
                                      np.asarray(m_j.match_valid)])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(flow.numpy(), np.asarray(flow_j), atol=1e-5)
    np.testing.assert_allclose(m.rigid_R.numpy(), np.asarray(m_j.rigid_R),
                               atol=1e-5)
