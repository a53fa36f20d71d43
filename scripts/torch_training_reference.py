#!/usr/bin/env python3
"""The JAX package's results on the training inputs of the PyTorch port's
chip_smoke.py (phase ``training``), JAX on the CPU.

Each recipe's batch comes from the JAX recipe's own generator, seed 0,
and goes to reference/training_batches.npz; the large image-like float
arrays are rounded to float16 there, and the JAX results below are
computed on exactly the rounded values (so the card runs on the same
numbers):

* ``flow``: scripts/train_flow.py's ``make_batch`` (64x64, batch 4,
  with MaskNet), from checkpoints/flow.npz, ``optax.adam(1e-4)``;
* ``tracking``: ``tracking_train.synthetic_tracking_sample`` x 4 (64x64,
  32 nodes, 512 matches), GNConfig(iters=3, w_arap=1) with the XLA
  "blocks" assembly (the JAX trainer's), DeformLossWeights(), from
  checkpoints/flow.npz, ``optax.adam(1e-4)`` (train_flow.py
  ``--through_solver``);
* ``motion``: scripts/train_motion.py's ``synthetic_sample`` x 8 (caps
  128,32,16,8, hist_len 16), from checkpoints/motion_complete.npz,
  ``optax.adam(1e-3)``;
* ``lepard``: scripts/train_lepard.py's ``synthetic_pair`` (192 points,
  cap 256, the curriculum's first pair), from
  checkpoints/lepard_bridge_r5e.npz and its side-car, the script's chain
  at its defaults (global-norm clip at 1, adamw at 3e-4 with
  warmup_cosine_decay_schedule from 0, 100 warm-up steps of the 2000,
  weight decay 1e-5): the first 5 steps of the warm-up.

For each: the step-0 loss (and the tracking terms), the global norm of
the step-0 gradient, the losses the 5 train steps return (each at the
parameters before its update) and the loss after the fifth update, all on
the one batch. Prints one JSON line per recipe; chip_smoke.py keeps them
as TRAINING_REFERENCE.

    JAX_PLATFORMS=cpu python scripts/torch_training_reference.py [RECIPE ...]

With recipe names, only those run, and their arrays replace theirs in an
existing npz.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

OUT = os.path.join(REPO, "reference", "training_batches.npz")
STEPS = 5


def script(name):
    """A module of scripts/ (the JAX recipes' own generators)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f16(a):
    """The values of a float array rounded to float16 (kept f32)."""
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def trajectory(loss_fn, params, optimizer, batch):
    """(step-0 loss, aux, global grad norm, the 5 steps' losses, the loss
    after the fifth update) of ``loss_fn(params, batch) -> (loss, aux)``."""
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss0, aux0), g0 = vg(params, batch)
    state = optimizer.init(params)

    @jax.jit
    def step(p, s, bt):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, bt)
        up, s = optimizer.update(g, s, p)
        return optax.apply_updates(p, up), s, loss

    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    (final, _), _ = vg(params, batch)
    return dict(loss0=float(loss0),
                terms0={k: float(v) for k, v in (aux0 or {}).items()},
                grad_norm0=float(optax.global_norm(g0)), losses=losses,
                final=float(final))


def flow_reference(out):
    from occlusionfusion_tpu.models.checkpoint import normalize_indexed
    from occlusionfusion_tpu.models.flow_train import FlowBatch, flow_loss_fn
    from occlusionfusion_tpu.utils.snapshot import load_params

    b = script("train_flow").make_batch(np.random.RandomState(0), 4, 64, 64,
                                        True)
    arrays = {}
    for f in FlowBatch._fields:
        a = np.asarray(getattr(b, f))
        arrays[f] = f16(a) if a.dtype == np.float32 else a
    for k, a in arrays.items():
        out[f"flow/{k}"] = a.astype(np.float16) if a.dtype == np.float32 else a
    batch = FlowBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tree = normalize_indexed(load_params(os.path.join(
        REPO, "checkpoints", "flow.npz")))
    params = {"pwc": tree["pwc"], "mask": tree["mask"]}

    def loss_fn(p, bt):
        return flow_loss_fn(p["pwc"], p["mask"], bt), {}

    return trajectory(loss_fn, params, optax.adam(1e-4), batch)


def tracking_reference(out):
    from occlusionfusion_tpu.models.checkpoint import normalize_indexed
    from occlusionfusion_tpu.models.deform_loss import DeformLossWeights
    from occlusionfusion_tpu.models.tracking_train import (
        TrackingSample,
        stack_samples,
        synthetic_tracking_sample,
        tracking_loss,
    )
    from occlusionfusion_tpu.solvers.gauss_newton import GNConfig
    from occlusionfusion_tpu.utils.snapshot import load_params

    rng = np.random.RandomState(0)
    batch = stack_samples([synthetic_tracking_sample(
        rng, H=64, W=64, n_nodes=32, n_matches=512) for _ in range(4)])
    rounded = ("src_rgbxyz", "tgt_rgbxyz", "flow_gt")
    arrays = {}
    for f in TrackingSample._fields:
        a = np.asarray(getattr(batch, f))
        arrays[f] = f16(a) if f in rounded else a
        out[f"tracking/{f}"] = (a.astype(np.float16) if f in rounded
                                else a)
    batch = TrackingSample(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tree = normalize_indexed(load_params(os.path.join(
        REPO, "checkpoints", "flow.npz")))
    params = {"pwc": tree["pwc"], "mask": tree["mask"]}
    gn = GNConfig(iters=3, w_arap=1.0)

    def loss_fn(p, bt):
        totals, terms = jax.vmap(lambda s: tracking_loss(
            p["pwc"], p["mask"], s, gn, DeformLossWeights()))(bt)
        return jnp.mean(totals), jax.tree.map(jnp.mean, terms)

    ref = trajectory(loss_fn, params, optax.adam(1e-4), batch)
    # the warp term alone on the first sample, its gradient on MaskNet
    # (only the solve carries it there)
    first = jax.tree.map(lambda x: x[0], batch)

    def warp(m):
        return tracking_loss(params["pwc"], m, first, gn)[1]["warp"]

    ref["warp_mask_grad_norm"] = float(optax.global_norm(
        jax.jit(jax.grad(warp))(params["mask"])))
    return ref


def motion_reference(out):
    from occlusionfusion_tpu.models.checkpoint import load_params
    from occlusionfusion_tpu.models.motion_train import batched_loss

    rng = np.random.RandomState(0)
    samples = [script("train_motion").synthetic_sample(
        rng, caps=(128, 32, 16, 8), hist_len=16) for _ in range(8)]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *samples)
    batch = batch._replace(history=jnp.asarray(f16(batch.history)))
    flat = jax.tree_util.tree_flatten_with_path(batch)[0]
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "name", getattr(p, "idx", p)))
                       for p in path)
        a = np.asarray(leaf)
        if key == "history":
            a = a.astype(np.float16)
        elif a.dtype == np.int32 and key.startswith("pyramid"):
            a = a.astype(np.int16)
        out[f"motion/{key}"] = a
    params = jax.tree.map(jnp.asarray, load_params(os.path.join(
        REPO, "checkpoints", "motion_complete.npz")))

    def loss_fn(p, bt):
        return batched_loss(p, bt), {}

    return trajectory(loss_fn, params, optax.adam(1e-3), batch)


def lepard_reference(out):
    from occlusionfusion_tpu.models.checkpoint import load_lepard_checkpoint
    from occlusionfusion_tpu.models.deform_loss import (
        focal_correspondence_loss,
    )
    from occlusionfusion_tpu.models.lepard import lepard_match
    from occlusionfusion_tpu.ops.knn import knn_lax

    params, cfg = load_lepard_checkpoint(os.path.join(
        REPO, "checkpoints", "lepard_bridge_r5e.npz"))
    params = jax.tree.map(jnp.asarray, params)
    pair = script("train_lepard").synthetic_pair(
        np.random.RandomState(0), n=192, cap=256, nonrigid=True,
        scale_range=(0.3, 1.3), max_angle=np.deg2rad(10.0),
        warp_amplitude=0.01)
    names = ("src", "sm", "tgt", "tm", "cs", "ct", "cm")
    for k, a in zip(names, pair):
        out[f"lepard/{k}"] = a

    def loss_fn(p, batch):
        src, sm, tgt, tm, cs, ct, cm = batch
        m = lepard_match(p, cfg, src, sm, tgt, tm)
        _, si = knn_lax(src[cs], m.src_points, k=1, valid=m.src_valid)
        _, ti = knn_lax(tgt[ct], m.tgt_points, k=1, valid=m.tgt_valid)
        S, T = m.src_points.shape[0], m.tgt_points.shape[0]
        gt = jnp.zeros((S, T)).at[si[:, 0], ti[:, 0]].max(
            cm.astype(jnp.float32))
        valid = m.src_valid[:, None] & m.tgt_valid[None, :]
        return focal_correspondence_loss(m.confidence, gt, valid), {}

    steps = 2000  # train_lepard.py's --steps default
    warmup = min(100, max(steps // 5, 1))
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=max(steps, warmup + 1), end_value=3e-4 * 0.02)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(schedule, weight_decay=1e-5))
    return trajectory(loss_fn, params, opt,
                      tuple(jnp.asarray(a) for a in pair))


def main(names):
    recipes = {"flow": flow_reference, "tracking": tracking_reference,
               "motion": motion_reference, "lepard": lepard_reference}
    names = names or list(recipes)
    out = {}
    if set(names) != set(recipes):
        with np.load(OUT) as data:
            out = {k: data[k] for k in data.files
                   if k.split("/")[0] not in names}
    refs = {}
    for name in names:
        fn = recipes[name]
        t = time.perf_counter()
        refs[name] = fn(out)
        print(json.dumps({name: refs[name],
                          "s": round(time.perf_counter() - t, 1)}),
              flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    print("TRAINING_REFERENCE = " + json.dumps(refs, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
