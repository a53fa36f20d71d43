"""The flow trainer of the port against the JAX package's on the CPU, from
checkpoints/flow.npz: PWC-Net's multi-scale forward per level, the
multi-scale loss, EPE (``epe_px``'s arithmetic on JAX's level-2 flow),
and one ``flow_loss_fn`` gradient with and
without MaskNet (each leaf within 1e-4 of JAX's, relative to that leaf's
norm). The JAX side is one compiled program for the module."""

import jax
import numpy as np
import pytest
import torch

from occlusionfusion_tpu.models import flow_train as JFT
from occlusionfusion_tpu.models.checkpoint import normalize_indexed
from occlusionfusion_tpu.models.pwcnet import pwcnet_forward_multiscale
from occlusionfusion_tpu.utils.snapshot import load_params

from occlusionfusion_tpu_torch.models import checkpoint as C
from occlusionfusion_tpu_torch.models import flow_train as PFT

from torch_port_impl import jax_run_once, one_torch_thread, tt  # noqa: F401

GRAD_TOL = 1e-4  # per leaf, relative to the leaf's norm


@pytest.fixture(scope="module")
def setup():
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_train_flow", os.path.join(repo, "scripts", "train_flow.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jb = mod.make_batch(np.random.RandomState(0), 2, 64, 64, True)
    tree = normalize_indexed(load_params(C.FLOW_NPZ))
    params = {"pwc": tree["pwc"], "mask": tree["mask"]}

    def jax_side(p, b):
        flows, _ = pwcnet_forward_multiscale(p["pwc"], b.im1, b.im2)
        with_mask, g_mask = jax.value_and_grad(
            lambda q: JFT.flow_loss_fn(q["pwc"], q["mask"], b))(p)
        flow_only, g_flow = jax.value_and_grad(
            lambda q: JFT.flow_loss_fn(q, None, b))(p["pwc"])
        return flows, with_mask, g_mask, flow_only, g_flow

    out = jax_run_once(jax_side, params, jb)
    # the multi-scale loss and epe_px's arithmetic on JAX's flows, eagerly
    # (a second PWC forward in the compiled program costs more than both)
    flows = out[0]
    ms = JFT.multiscale_flow_loss(flows, jb.flow_gt, jb.flow_valid)
    up = jax.image.resize(flows[2], (2, 64, 64, 2), method="bilinear") * (
        JFT.FLOW_NORM)
    err = jax.numpy.linalg.norm(up - jb.flow_gt, axis=-1)
    m = jb.flow_valid.astype(np.float32)
    epe = jax.numpy.sum(err * m) / jax.numpy.maximum(jax.numpy.sum(m), 1.0)
    ref = jax.tree.map(np.asarray, (*out, ms, epe))
    batch = PFT.FlowBatch(*(tt(np.asarray(x)) for x in jb))
    return batch, ref


def _grads_close(net, grads_sd):
    worst = 0.0
    for k, p in net.named_parameters():
        r = grads_sd[k]
        worst = max(worst, float((p.grad - r).norm() / r.norm()))
    assert worst <= GRAD_TOL, worst
    return worst


def test_multiscale_forward_loss_and_epe(setup):
    batch, (flows, *_, ms, epe) = setup
    pwc, _ = C.load_flow_nets(device="cpu")
    with torch.no_grad():
        got, _ = pwc.forward_multiscale(batch.im1.permute(0, 3, 1, 2),
                                        batch.im2.permute(0, 3, 1, 2))
        for lvl in (2, 3, 4, 5, 6):
            np.testing.assert_allclose(
                got[lvl].permute(0, 2, 3, 1).numpy(), flows[lvl],
                atol=1e-4, rtol=1e-4)
        loss = PFT.multiscale_flow_loss(got, batch.flow_gt, batch.flow_valid)
        np.testing.assert_allclose(float(loss), ms, rtol=1e-5)
        e = PFT.epe_px(pwc, batch.im1, batch.im2, batch.flow_gt,
                       batch.flow_valid)
        np.testing.assert_allclose(float(e), epe, rtol=1e-5)


def test_flow_loss_gradient_with_and_without_masknet(setup):
    batch, (_, with_mask, g_mask, flow_only, g_flow, *_) = setup
    pwc, mask = C.load_flow_nets(device="cpu")
    loss = PFT.flow_loss_fn(pwc, mask, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), with_mask, rtol=1e-5)
    _grads_close(pwc, C.pwc_params_from_jax(g_mask["pwc"]))
    _grads_close(mask, C.masknet_params_from_jax(g_mask["mask"]))
    pwc.zero_grad()
    loss = PFT.flow_loss_fn(pwc, None, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), flow_only, rtol=1e-5)
    _grads_close(pwc, C.pwc_params_from_jax(g_flow))


def test_train_step_moves_the_loss(setup):
    """``make_flow_train_step`` with the optax-semantics Adam: two steps on
    one batch lower the loss."""
    from occlusionfusion_tpu_torch.models.optim import Adam

    batch = setup[0]
    pwc, mask = C.load_flow_nets(device="cpu")
    opt = Adam([*pwc.parameters(), *mask.parameters()], 1e-4)
    step = PFT.make_flow_train_step(pwc, opt, mask_net=mask)
    first = float(step(batch))
    step(batch)
    with torch.no_grad():
        assert float(PFT.flow_loss_fn(pwc, mask, batch)) < first
