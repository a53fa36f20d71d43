"""The motion-completion and Lepard trainers of the port against the JAX
package's on the CPU: the motion recipe's procedural samples (the same
draws in both packages), ``nll_loss`` / ``batched_loss`` and their
gradient from checkpoints/motion_complete.npz; the focal correspondence
loss of a Lepard pair from lepard_bridge_r5e's weights (its KPFCN and
transformer at a smaller pyramid) and its gradient. Gradients per leaf
within the stated tolerance of JAX's, relative to the leaf's norm."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from occlusionfusion_tpu_torch.models import checkpoint as C

from torch_port_impl import jax_run_once, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _worst_leaf_gap(net, grads_sd):
    """The largest per-leaf gap relative to the leaf's norm; a leaf whose
    JAX gradient is zero up to rounding (under 1e-5 of the global norm,
    as the attention keys' biases, which a softmax cancels) is held
    relative to 1e-5 of the global norm instead."""
    total = float(torch.sqrt(sum(torch.sum(g**2) for g in grads_sd.values())))
    return max(float((p.grad - grads_sd[k]).norm())
               / max(float(grads_sd[k].norm()), 1e-5 * total)
               for k, p in net.named_parameters())


def test_motion_samples_loss_and_gradient_match_jax():
    from occlusionfusion_tpu.models.motion_train import batched_loss as jbl
    from occlusionfusion_tpu.models.checkpoint import load_params

    from occlusionfusion_tpu_torch.models.motion_train import (
        batched_loss,
        nll_loss,
        sample_to_torch,
    )
    from occlusionfusion_tpu_torch.scripts.train_motion import (
        synthetic_sample,
    )

    caps = (128, 32, 16, 8)
    js = [jax_script("train_motion").synthetic_sample(
        np.random.RandomState(0), caps=caps, hist_len=16)]
    rng = np.random.RandomState(0)
    ps = [synthetic_sample(rng, caps=caps, hist_len=16)]
    js.append(jax_script("train_motion").synthetic_sample(
        np.random.RandomState(0).__class__(1), caps=caps, hist_len=16))
    ps.append(synthetic_sample(np.random.RandomState(1), caps=caps,
                               hist_len=16))
    for j, p in zip(js, ps):
        for a, b in zip(jax.tree.leaves(j), jax.tree.leaves(tuple(p))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *js)
    params = jax.tree.map(jnp.asarray, load_params(C.MOTION_COMPLETE_NPZ))
    ref, g = jax_run_once(jax.value_and_grad(jbl), params, batch)
    net = C.load_motion_complete_net(device="cpu").train()
    samples = [sample_to_torch(p, "cpu") for p in ps]
    loss = batched_loss(net, samples)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    with torch.no_grad():
        single = nll_loss(net, samples[0]).item()
    assert abs((single + nll_loss(net, samples[1]).item()) / 2
               - loss.item()) <= 1e-5 * abs(loss.item())
    grads = C.params_from_jax(jax.tree.map(np.asarray, g))
    assert _worst_leaf_gap(net, grads) <= 1e-4


def test_lepard_focal_loss_and_gradient_match_jax():
    """lepard_bridge_r5e's weights at a smaller pyramid (the full-depth
    KPFCN and the transformer unchanged) on the recipe's synthetic pair:
    the loss within 1e-5, the gradient's global norm within 1e-4 and each
    leaf within 5e-3 of JAX's (measured 2.6e-3 at the first encoder block,
    which collects the rounding of every later layer, the positioning
    layers' rigid fits included: the JAX package's SVD, the port's Horn
    form)."""
    from occlusionfusion_tpu.models import kpconv as JK
    from occlusionfusion_tpu.models.checkpoint import (
        load_lepard_checkpoint as jload,
    )
    from occlusionfusion_tpu.models.deform_loss import (
        focal_correspondence_loss,
    )
    from occlusionfusion_tpu.models.lepard import lepard_match
    from occlusionfusion_tpu.ops.knn import knn_lax

    from occlusionfusion_tpu_torch.models import kpconv as PK
    from occlusionfusion_tpu_torch.scripts import train_lepard as PTL

    path = os.path.join(REPO, "checkpoints", "lepard_bridge_r5e.npz")
    jparams, jcfg = jload(path)
    pyr = dict(level_sizes=(128, 64, 32, 16), first_voxel=0.06)
    jcfg = jcfg._replace(kpfcn=jcfg.kpfcn._replace(
        pyramid=JK.PyramidConfig(**pyr)))
    pair = PTL.synthetic_pair(np.random.RandomState(0), n=96, cap=128,
                              max_angle=np.deg2rad(10.0),
                              warp_amplitude=0.01)
    jpair = jax_script("train_lepard").synthetic_pair(
        np.random.RandomState(0), n=96, cap=128, max_angle=np.deg2rad(10.0),
        warp_amplitude=0.01)
    for a, b in zip(pair, jpair):
        np.testing.assert_array_equal(a, b)

    def jloss(p, src, sm, tgt, tm, cs, ct, cm):
        m = lepard_match(p, jcfg, src, sm, tgt, tm)
        _, si = knn_lax(src[cs], m.src_points, k=1, valid=m.src_valid)
        _, ti = knn_lax(tgt[ct], m.tgt_points, k=1, valid=m.tgt_valid)
        gt = jnp.zeros((m.src_points.shape[0], m.tgt_points.shape[0]))
        gt = gt.at[si[:, 0], ti[:, 0]].max(cm.astype(jnp.float32))
        valid = m.src_valid[:, None] & m.tgt_valid[None, :]
        return focal_correspondence_loss(m.confidence, gt, valid)

    ref, g = jax_run_once(jax.value_and_grad(jloss),
                          jax.tree.map(jnp.asarray, jparams),
                          *map(jnp.asarray, pair))
    net, cfg = C.load_lepard_checkpoint(path, device="cpu")
    net, _ = C.load_lepard_checkpoint(
        path, device="cpu", config=cfg._replace(kpfcn=cfg.kpfcn._replace(
            pyramid=PK.PyramidConfig(**pyr))))
    t = [torch.from_numpy(a) for a in pair + PTL.neutral_aux(128)]
    loss = PTL.lepard_loss(net, *t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    grads = C.lepard_params_from_jax(jax.tree.map(np.asarray, g))
    norm = float(torch.sqrt(sum(torch.sum(p.grad**2)
                                for p in net.parameters())))
    ref_norm = float(torch.sqrt(sum(torch.sum(v**2)
                                    for v in grads.values())))
    assert abs(norm - ref_norm) <= 1e-4 * ref_norm
    assert _worst_leaf_gap(net, grads) <= 5e-3
