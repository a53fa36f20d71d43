"""Train / fine-tune the motion-completion net with the port: the recipe of
``scripts/train_motion.py``, its flags and defaults, plus ``--device``
(the card unless ``--device cpu``).

  python -m occlusionfusion_tpu_torch.scripts.train_motion --steps 2000 \
      --synthetic_clips 6 --resume checkpoints/motion_complete.npz \
      --out checkpoints/motion_trained.npz [--device cpu]

Two data regimes, mixed per batch: procedural bone-blend fields over
random graphs, and deformation clips (``--clips`` glob of ``.anime``
files, or ``--synthetic_clips N`` generated into a temporary directory)
through ``data/motion_clips.py``. Held-out clips score the occluded-node
EPE against the zero-motion baseline. The checkpoint is the JAX
package's flat npz.
"""

from __future__ import annotations

import argparse
import glob
import os
import tempfile
import time

import numpy as np
import torch


def synthetic_sample(rng, caps=(128, 32, 16, 8), ks=(8, 6, 4, 3),
                     hist_len=8):
    """A procedural sample: a random 4-level pyramid and a smooth motion
    blended from three random rigid "bones" (numpy, the JAX draws)."""
    from occlusionfusion_tpu_torch.fusion.motion_runner import pad_pyramid
    from occlusionfusion_tpu_torch.models.motion_train import MotionBatch

    n0 = rng.randint(40, caps[0] - 8)
    sizes = [n0, max(n0 // 4, 4), max(n0 // 12, 3), max(n0 // 24, 2)]
    nn = [
        rng.randint(0, sizes[l], size=(sizes[l], ks[l])).astype(np.int16)
        for l in range(4)
    ]
    down = [
        np.sort(rng.choice(sizes[l], size=sizes[l + 1], replace=False)).astype(
            np.int16
        )
        for l in range(3)
    ]
    up = [
        rng.randint(0, sizes[l + 1], size=sizes[l]).astype(np.int16)
        for l in range(3)
    ]
    pos = np.zeros((caps[0], 3), np.float32)
    pos[:n0] = rng.randn(n0, 3) * 0.2
    centers = rng.randn(3, 3) * 0.2
    weights = np.exp(
        -np.linalg.norm(pos[:, None] - centers[None], axis=-1) / 0.15
    )
    weights /= weights.sum(-1, keepdims=True) + 1e-6
    bone_motion = rng.randn(3, 3) * 0.02
    gt = (weights @ bone_motion).astype(np.float32)
    gt[n0:] = 0
    visible = rng.rand(caps[0]) > 0.4
    visible[n0:] = False
    curr = np.zeros((caps[0], 4), np.float32)
    curr[visible, :3] = gt[visible] * 100.0
    std = np.mean(np.std(curr[visible, :3], axis=0)) + 0.1
    curr[visible, :3] /= std
    curr[:, 3] = visible
    hist = rng.randn(hist_len, caps[0], 4).astype(np.float32) * 0.1
    mask = np.zeros(caps[0], np.float32)
    mask[:n0] = 1
    return MotionBatch(
        pos=pos,
        curr_motion=curr,
        history=hist,
        history_len=np.int32(hist_len),
        gt_motion=(gt * 100.0 / std).astype(np.float32),
        node_mask=mask,
        pyramid=pad_pyramid(nn, down, up, level_sizes=caps),
    )


def make_synthetic_clip(path, seed, n_frames=12):
    """A deforming blob: the marching-cubes surface of a random-radius
    sphere under a sinusoidal bend field (substantial non-rigid motion)."""
    from occlusionfusion_tpu_torch.data.deformingthings4d import save_anime
    from occlusionfusion_tpu_torch.graph import native

    rng = np.random.RandomState(seed)
    n = 22
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2.0
    sdf = np.linalg.norm(g - c, axis=0) - rng.uniform(6.0, 8.0)
    verts, faces = native.marching_cubes(sdf)
    verts = (verts * rng.uniform(0.015, 0.022)).astype(np.float32)
    ax = rng.randn(3)
    ax /= np.linalg.norm(ax)
    bend_dir = rng.randn(1, 3)
    freq = rng.uniform(7.0, 13.0)
    offs = []
    for f in range(1, n_frames):
        phase = f * rng.uniform(0.25, 0.45)
        bend = (
            0.006 * np.sin(verts @ ax * freq + phase)[:, None] * bend_dir
        )
        offs.append(bend.astype(np.float32))
    save_anime(path, verts, faces, np.stack(offs))
    return path


def load_clip_samples(paths, caps, node_coverage, seed0=0):
    from occlusionfusion_tpu_torch.data.motion_clips import (
        MotionClipConfig,
        clip_to_training_samples,
    )

    cfg = MotionClipConfig(node_coverage=node_coverage, caps=tuple(caps))
    return [clip_to_training_samples(p, cfg, seed=seed0 + i)[0]
            for i, p in enumerate(paths)]


def occluded_epe(net, samples, device):
    """Mean occluded-node EPE and the zero-motion baseline over samples
    (normalized units)."""
    from occlusionfusion_tpu_torch.models.motion_complete import (
        motion_complete_forward,
    )
    from occlusionfusion_tpu_torch.models.motion_train import sample_to_torch

    errs, base = [], []
    with torch.no_grad():
        for s in samples:
            st = sample_to_torch(s, device)
            mu = motion_complete_forward(
                net, st.pos, st.curr_motion, st.history, st.history_len,
                st.pyramid)[:, :3].cpu().numpy()
            occ = (np.asarray(s.curr_motion)[:, 3] < 0.5) & (
                np.asarray(s.node_mask) > 0.5)
            if not occ.any():
                continue
            gt = np.asarray(s.gt_motion)
            errs.append(np.linalg.norm(mu[occ] - gt[occ], axis=1).mean())
            base.append(np.linalg.norm(gt[occ], axis=1).mean())
    return float(np.mean(errs)), float(np.mean(base))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="checkpoints/motion_trained.npz")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--clips", default=None,
                    help="glob of .anime clips run through the clip "
                         "pipeline")
    ap.add_argument("--synthetic_clips", type=int, default=0,
                    help="generate this many varied deforming-blob clips")
    ap.add_argument("--holdout", type=int, default=1,
                    help="clips held out for the occluded-EPE eval")
    ap.add_argument("--caps", default="128,32,16,8",
                    help="pyramid level caps")
    ap.add_argument("--node_coverage", type=float, default=0.05)
    ap.add_argument("--synthetic_frac", type=float, default=0.25,
                    help="fraction of each batch from the procedural "
                         "generator (0 disables; only with clips)")
    ap.add_argument("--hist_len", type=int, default=16,
                    help="history ring depth of the procedural samples")
    ap.add_argument("--eval_every", type=int, default=100)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from occlusionfusion_tpu_torch.device import resolve_device
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
        params_to_jax,
    )
    from occlusionfusion_tpu_torch.models.motion_complete import (
        init_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.models.motion_train import (
        make_train_step,
        sample_to_torch,
    )
    from occlusionfusion_tpu_torch.models.optim import Adam
    from occlusionfusion_tpu_torch.utils.snapshot import save_pytree

    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu)")
    caps = tuple(int(x) for x in args.caps.split(","))
    if args.resume:
        net = load_motion_complete_net(args.resume, device=dev).train()
        print(f"resumed params from {args.resume}")
    else:
        net = init_motion_complete_net(
            torch.Generator().manual_seed(args.seed), dev)
    train_step = make_train_step(net, Adam(net.parameters(), args.lr))

    clip_paths = sorted(glob.glob(args.clips)) if args.clips else []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.synthetic_clips):
            clip_paths.append(make_synthetic_clip(
                os.path.join(tmp, f"motion_clip_{i}.anime"),
                seed=1000 + args.seed * 100 + i))
        train_pools, eval_samples = [], []
        if clip_paths:
            pools = load_clip_samples(clip_paths, caps, args.node_coverage,
                                      seed0=args.seed)
            n_hold = min(args.holdout, max(len(pools) - 1, 0))
            eval_samples = [s for p in pools[:n_hold] for s in p]
            train_pools = pools[n_hold:]
            n_train = sum(len(p) for p in train_pools)
            print(f"{len(clip_paths)} clips -> {n_train} train samples, "
                  f"{len(eval_samples)} held-out eval samples")
    flat_train = [s for p in train_pools for s in p]
    rng = np.random.RandomState(args.seed)

    def draw_sample():
        if flat_train and (
            not args.synthetic_frac or rng.rand() >= args.synthetic_frac
        ):
            return flat_train[rng.randint(len(flat_train))]
        return synthetic_sample(rng, caps=caps, hist_len=args.hist_len)

    if eval_samples:
        e0, b0 = occluded_epe(net, eval_samples, dev)
        print(f"step -: occluded EPE {e0:.4f} (zero-motion baseline {b0:.4f})")

    t0 = time.perf_counter()
    for step in range(args.steps):
        samples = [sample_to_torch(draw_sample(), dev)
                   for _ in range(args.batch)]
        loss = train_step(samples)
        if step % args.eval_every == 0 or step == args.steps - 1:
            msg = (f"step {step}: loss {float(loss):.4f} "
                   f"({time.perf_counter() - t0:.1f}s)")
            if eval_samples:
                e, b = occluded_epe(net, eval_samples, dev)
                msg += f" occluded EPE {e:.4f} (baseline {b:.4f})"
            print(msg, flush=True)
        if args.save_every and step and step % args.save_every == 0:
            save_pytree(args.out, params_to_jax(net))
    save_pytree(args.out, params_to_jax(net))
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
