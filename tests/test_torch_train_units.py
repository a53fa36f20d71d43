"""The port's training pieces against the JAX package's on the CPU: image
warps, the losses, the optimiser module against optax, the Lloyd kernel
dispositions, the neighbour calibration, the initialisers' layout and
scale, and checkpoints in both directions."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from occlusionfusion_tpu.geometry.camera import Intrinsics as JIntrinsics
from occlusionfusion_tpu.models import deform_loss as JL
from occlusionfusion_tpu.ops import image_warp as JW

from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.models import checkpoint as C
from occlusionfusion_tpu_torch.models import deform_loss as PL
from occlusionfusion_tpu_torch.models import optim as O
from occlusionfusion_tpu_torch.ops import image_warp as PW

from torch_port_impl import jax_run_once, one_torch_thread, tt  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 32
TOL = 1e-4  # tests/test_flow_augment.py's


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol,
                               rtol=tol)


def test_image_warps_match_jax():
    """Each JAX function compiled once (XLA opt level 0) on the same inputs
    as the port's."""
    from occlusionfusion_tpu.geometry.so3 import so3_exp

    rng = np.random.RandomState(0)
    img = rng.rand(H, W, 3).astype(np.float32)
    flow = (rng.randn(H, W, 2) * 2).astype(np.float32)
    close(PW.warp_image_with_flow(tt(img), tt(flow)),
          jax_run_once(JW.warp_image_with_flow, img, flow))
    pts = np.stack([rng.randn(H, W) * 0.1, rng.randn(H, W) * 0.1,
                    1 + rng.rand(H, W)], -1).astype(np.float32)
    pts[0, :3, 2] = 0.0
    R = np.asarray(so3_exp(jnp.asarray([0.02, -0.03, 0.01])), np.float32)
    t = np.float32([0.01, -0.02, 0.03])
    ji, pi = JIntrinsics(60.0, 62.0, 16.0, 12.0), Intrinsics(60.0, 62.0,
                                                           16.0, 12.0)
    for got, ref in zip(
            PW.warp_rigid(tt(pts), tt(R), tt(t), pi),
            jax_run_once(lambda p, r, s: JW.warp_rigid(p, r, s, ji), pts, R,
                         t)):
        close(got, ref)
    sf = (rng.randn(H, W, 3) * 0.01).astype(np.float32)
    for got, ref in zip(PW.warp_3d(tt(pts), tt(sf), pi),
                        jax_run_once(lambda p, f: JW.warp_3d(p, f, ji), pts,
                                     sf)):
        close(got, ref)
    depth = (1 + rng.rand(H, W)).astype(np.float32)
    depth[rng.rand(H, W) < 0.2] = 0.0
    depth[5, 5] = 3.0
    close(PW.median_filter_depth(tt(depth)),
          jax_run_once(JW.median_filter_depth, depth))


def test_rotation_augmentation_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.rand(H, W, 3).astype(np.float32)
    gt = (rng.randn(H, W, 2) * 1.5).astype(np.float32)
    valid = rng.rand(H, W) > 0.1
    a_s, a_t = np.float32(0.2), np.float32(-0.15)

    def jax_side(img, gt, valid, a_s, a_t):
        return (JW.rotation_flow(H, W, a_s), JW.rotate_image(img, a_s),
                JW.augmented_flow_from_rotation(
                    JW.rotation_flow(H, W, a_s), gt, valid,
                    JW.rotation_flow(H, W, -a_t)))

    rf, ri, (af, av) = jax_run_once(jax_side, img, gt, valid, a_s, a_t)
    close(PW.rotation_flow(H, W, a_s), rf)
    close(PW.rotate_image(tt(img), a_s), ri)
    got = PW.augmented_flow_from_rotation(
        PW.rotation_flow(H, W, a_s), tt(gt), tt(valid),
        PW.rotation_flow(H, W, -a_t))
    close(got[0], af)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(av))


def test_losses_match_jax():
    rng = np.random.RandomState(2)
    a, b = rng.randn(2, 50, 3).astype(np.float32)
    m = rng.rand(50) > 0.3
    close(PL.robust_l1(tt(a), tt(b), tt(m)),
          JL.robust_l1(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)), 1e-6)
    close(PL.graph_l2(tt(a), tt(b), tt(m)),
          JL.graph_l2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)), 1e-6)
    logits = rng.randn(50).astype(np.float32) * 3
    lab = (rng.rand(50) > 0.5).astype(np.float32)
    w = JL.DeformLossWeights()
    args = (a, b, m, a[:20], b[:20], m[:20], a, b * 0.9, m)
    close(PL.deform_loss(PL.DeformLossWeights(), *map(tt, args),
                         mask_pred=tt(logits), mask_gt=tt(lab),
                         mask_valid=tt(m)),
          JL.deform_loss(w, *map(jnp.asarray, args),
                         mask_pred=jnp.asarray(logits),
                         mask_gt=jnp.asarray(lab),
                         mask_valid=jnp.asarray(m)), 1e-5)
    conf = rng.rand(12, 9).astype(np.float32)
    gt = (rng.rand(12, 9) > 0.8).astype(np.float32)
    valid = rng.rand(12, 9) > 0.2
    negw = (1 + rng.rand(12, 9)).astype(np.float32)
    for nw in (None, negw):
        c = tt(conf).requires_grad_()
        got = PL.focal_correspondence_loss(
            c, tt(gt), tt(valid), neg_weight=None if nw is None else tt(nw))
        (gc,) = torch.autograd.grad(got, c)
        ref, gr = jax.value_and_grad(
            lambda x: JL.focal_correspondence_loss(
                x, jnp.asarray(gt), jnp.asarray(valid),
                neg_weight=None if nw is None else jnp.asarray(nw)))(
            jnp.asarray(conf))
        close(got.detach(), ref, 1e-6)
        close(gc, gr, 1e-5)


def _optax_run(opt, params, grads):
    state = opt.init(params)
    out = []
    for g in grads:
        up, state = opt.update(g, state, params)
        params = optax.apply_updates(params, up)
        out.append(np.asarray(params))
    return out


@pytest.mark.parametrize("kind", ["adam", "adamw_schedule_clip"])
def test_optimiser_matches_optax(kind):
    """Five updates on synthetic gradients, held to optax within 1e-6 (the
    first adam step moves every parameter by ~lr sign(g))."""
    rng = np.random.RandomState(3)
    p0 = rng.randn(40).astype(np.float32)
    grads = [(rng.randn(40) * s).astype(np.float32)
             for s in (3.0, 0.01, 1.0, 0.5, 2.0)]
    if kind == "adam":
        ref = _optax_run(optax.adam(1e-2), jnp.asarray(p0),
                         map(jnp.asarray, grads))
        make = lambda p: O.Adam([p], 1e-2)  # noqa: E731
    else:
        sched = optax.warmup_cosine_decay_schedule(0.0, 3e-2, 2, 5, 6e-4)
        ref = _optax_run(optax.chain(optax.clip_by_global_norm(1.0),
                                     optax.adamw(sched, weight_decay=1e-2)),
                         jnp.asarray(p0), map(jnp.asarray, grads))
        psched = O.warmup_cosine_decay_schedule(0.0, 3e-2, 2, 5, 6e-4)
        for c in range(8):
            assert abs(psched(c) - float(sched(c))) <= 1e-9
        make = lambda p: O.Adam([p], psched, weight_decay=1e-2,  # noqa: E731
                                clip_norm=1.0)
    p = tt(p0).requires_grad_(False)
    opt = make(p)
    for g, r in zip(grads, ref):
        p.grad = tt(g)
        opt.step()
        np.testing.assert_allclose(p.numpy(), r, atol=1e-6, rtol=0)
    clipped, norm = O.clip_by_global_norm([tt(g) for g in grads[:2]], 1.0)
    up, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads[:2]], optax.EmptyState())
    assert abs(float(norm) - float(optax.global_norm(
        [jnp.asarray(g) for g in grads[:2]]))) <= 1e-5
    for a, b in zip(clipped, up):
        close(a, b, 1e-6)


def test_lloyd_kernel_points_bitwise_and_calibration(monkeypatch):
    from occlusionfusion_tpu.models import kpconv as JK
    from occlusionfusion_tpu_torch.models import kpconv as PK

    np.testing.assert_array_equal(
        PK.kernel_points(8, 0.3, "lloyd").numpy(),
        np.asarray(JK.kernel_points(8, 0.3, "lloyd")))
    rng = np.random.RandomState(4)
    clouds = [((rng.randn(100, 3) * 0.3).astype(np.float32),
               rng.rand(100) > 0.1) for _ in range(2)]
    sizes = dict(level_sizes=(64, 32, 16, 8), first_voxel=0.08)
    # the JAX calibration builds its pyramids eagerly; jitted (one
    # compile) it computes the same
    monkeypatch.setattr(JK, "build_pyramid", jax.jit(
        JK.build_pyramid, static_argnums=2))
    got = PK.calibrate_neighbor_limits(clouds, PK.PyramidConfig(**sizes),
                                       samples_threshold=50)
    ref = JK.calibrate_neighbor_limits(clouds, JK.PyramidConfig(**sizes),
                                       samples_threshold=50)
    assert tuple(got.max_neighbors) == tuple(ref.max_neighbors)
    assert PK.full_depth_config() == PK.KPFCNConfig(
        blocks_per_stage=2, num_stages=3, coarse_upsamples=1)


def _leaf_map(tree, prefix=()):
    """{normalized path: leaf} of a nested dict/list tree (empty dicts
    dropped, as a flat npz drops them)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_leaf_map(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = (
                v if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v))
    return out


def _init_std(path, shape):
    """The std of the JAX initialiser's draw for a leaf (its formula:
    He-normal convs, sqrt(2 / in) KPFCN linears and sqrt(2 / (K in))
    kernel weights, sqrt(1 / in) projection and attention linears,
    U(+-1/sqrt(in)) motion linears, U(+-0.1) LSTM weights); None for the
    constant leaves (biases 0, norms 1 or 0)."""
    leaf = path[-1]
    if (leaf in ("b", "bias") or "norm" in leaf or leaf.startswith("bias_")
            or (len(path) > 1 and "norm" in path[-2])):
        return None
    if leaf.startswith("weight_"):  # the LSTM's
        return 0.1 / 3**0.5
    if path[0] in ("proj", "reposition"):
        return (1.0 / shape[0]) ** 0.5
    if leaf == "weight":  # motion linears, [out, in]
        return 1.0 / (3 * shape[1]) ** 0.5
    if leaf == "weights":  # KPConv [K, in, out]
        return (2.0 / (shape[0] * shape[1])) ** 0.5
    if len(shape) == 4:  # HWIO conv
        return (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
    return (2.0 / shape[0]) ** 0.5  # KPFCN linear [in, out]


def _assert_init_like(ours, jax_init, key):
    """The JAX initialiser's key structure and shapes (``eval_shape``,
    nothing drawn), each drawn leaf's std within 15% of the JAX formula's
    (leaves of 256 or more entries) and the constant leaves equal to
    JAX's constants."""
    a = _leaf_map(ours)
    b = _leaf_map(jax.eval_shape(jax_init, key))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == tuple(b[k].shape), k
        std = _init_std(k, a[k].shape)
        if std is None:
            assert np.all(a[k] == (1.0 if "scale" in k[-1] or (
                "norm" in k[-2] and k[-1] == "weight") else 0.0)), k
        elif a[k].size >= 256:
            assert abs(a[k].std() / std - 1) < 0.15, (k, a[k].std(), std)


def test_initialisers_match_jax_layout_and_scale():
    """Key structure and shapes against the JAX initialisers, the scale
    against their formulas."""
    from occlusionfusion_tpu.models import kpconv as JK
    from occlusionfusion_tpu.models import lepard as JLep
    from occlusionfusion_tpu.models import motion_complete as JMC
    from occlusionfusion_tpu.models import pwcnet as JP
    from occlusionfusion_tpu.models.transformer3d import (
        RepositionConfig as JR,
    )
    from occlusionfusion_tpu_torch.models import kpconv as PK
    from occlusionfusion_tpu_torch.models import lepard as PLep
    from occlusionfusion_tpu_torch.models.motion_complete import (
        init_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.models.pwcnet import (
        init_masknet,
        init_pwcnet,
    )
    from occlusionfusion_tpu_torch.models.transformer3d import (
        RepositionConfig as PR,
    )

    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    _assert_init_like(C.pwc_params_to_jax(init_pwcnet(g, "cpu")),
                      JP.init_pwcnet_params, key)
    _assert_init_like(C.masknet_params_to_jax(init_masknet(g, "cpu")),
                      JP.init_masknet_params, key)
    _assert_init_like(C.params_to_jax(init_motion_complete_net(g, "cpu")),
                      JMC.init_params, key)
    # narrow widths: the shipped configs' layout at a smaller width
    narrow = dict(first_dim=16, out_dim=48)
    for full in (False, True):
        jcfg = JLep.LepardConfig(
            kpfcn=JK.full_depth_config(**narrow) if full
            else JK.KPFCNConfig(**narrow), reposition=JR(dim=48))
        pcfg = PLep.LepardConfig(
            kpfcn=PK.full_depth_config(**narrow) if full
            else PK.KPFCNConfig(**narrow), reposition=PR(dim=48))
        _assert_init_like(C.lepard_params_to_jax(
            PLep.init_lepard(pcfg, g, "cpu")),
            lambda k: JLep.init_lepard_params(k, jcfg), key)


@pytest.mark.parametrize("name", ["flow", "motion_complete",
                                  "lepard_bridge_r5e"])
def test_checkpoint_round_trip_jax_port_jax(name, tmp_path):
    """A JAX checkpoint loads in the port and writes back equal: the same
    keys and arrays, bit for bit (the Lepard side-car too)."""
    import json

    from occlusionfusion_tpu_torch.scripts.train_flow import flow_checkpoint
    from occlusionfusion_tpu_torch.utils.snapshot import (
        load_flat,
        save_pytree,
    )

    src = os.path.join(REPO, "checkpoints", f"{name}.npz")
    out = str(tmp_path / f"{name}.npz")
    if name == "flow":
        save_pytree(out, flow_checkpoint(*C.load_flow_nets(src, "cpu")))
    elif name == "motion_complete":
        save_pytree(out, C.params_to_jax(C.load_motion_complete_net(
            src, "cpu")))
    else:
        net, cfg = C.load_lepard_checkpoint(src, device="cpu")
        C.save_lepard_checkpoint(out, net, cfg)
        with open(src + ".json") as fh, open(out + ".json") as gh:
            assert json.load(fh) == json.load(gh)
    ref, got = load_flat(src), load_flat(out)
    if name == "motion_complete":  # its npz keys are dotted
        got = {k.replace("/", "."): v for k, v in got.items()}
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k])
