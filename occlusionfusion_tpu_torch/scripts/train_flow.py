"""Train the PWC-Net optical-flow stack (+ optional MaskNet head) with the
port: the recipe of ``scripts/train_flow.py``, its flags and defaults,
plus ``--device`` (the card unless ``--device cpu``).

  python -m occlusionfusion_tpu_torch.scripts.train_flow --steps 2000 \
      --out checkpoints/flow.npz [--with_mask] [--device cpu]
  python -m occlusionfusion_tpu_torch.scripts.train_flow --through_solver

Data: synthetic textured pairs deformed by smooth random flow fields
(``--data noise``), pairs rendered from the procedural deforming shapes
(``--data rendered``), or a DeepDeform-layout root (``--data deepdeform
--deepdeform ROOT``). ``--through_solver`` trains PWC + MaskNet through
the Gauss-Newton solve (``models/tracking_train.py``). The checkpoint is
the JAX package's layout ({"pwc": ..., "mask": ...} through
``utils/snapshot.save_pytree``), so either package loads it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def smooth_field(rng, H, W, channels, scale, cells=4):
    """Random smooth field: low-res noise, bilinearly upsampled."""
    coarse = rng.randn(cells, cells, channels).astype(np.float32) * scale
    ys = np.linspace(0, cells - 1, H)
    xs = np.linspace(0, cells - 1, W)
    y0 = np.clip(ys.astype(int), 0, cells - 2)
    x0 = np.clip(xs.astype(int), 0, cells - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    return (
        c00 * (1 - fy) * (1 - fx)
        + c01 * (1 - fy) * fx
        + c10 * fy * (1 - fx)
        + c11 * fy * fx
    )


def bilinear_np(img, y, x):
    H, W = img.shape[:2]
    x0 = np.clip(np.floor(x).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, H - 2)
    fx = np.clip(x - x0, 0, 1)[..., None]
    fy = np.clip(y - y0, 0, 1)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


def synthetic_pair(rng, H=64, W=64, max_flow=4.0):
    """(im1, im2, flow_gt [H,W,2] px, valid): im2 is im1 inverse-warped by
    a smooth flow field (small-flow approximation)."""
    tex = smooth_field(rng, H, W, 3, 1.0, cells=8)
    tex += 0.2 * rng.randn(H, W, 3).astype(np.float32)
    im1 = (tex - tex.min()) / max(float(np.ptp(tex)), 1e-6)
    flow = smooth_field(rng, H, W, 2, max_flow, cells=3)
    v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    im2 = bilinear_np(im1, v - flow[..., 1], u - flow[..., 0]).astype(
        np.float32
    )
    inb = (
        (u + flow[..., 0] >= 0) & (u + flow[..., 0] <= W - 1)
        & (v + flow[..., 1] >= 0) & (v + flow[..., 1] <= H - 1)
    )
    return im1.astype(np.float32), im2, flow.astype(np.float32), inb


def synthetic_rgbd6(rng, im, H, W):
    """6-channel RGB-XYZ companion (smooth synthetic depth surface)."""
    depth = 1.0 + 0.3 * smooth_field(rng, H, W, 1, 1.0, cells=3)[..., 0]
    v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    fx = 0.5 * max(H, W)
    x = (u - W / 2) / fx * depth
    y = (v - H / 2) / fx * depth
    return np.concatenate(
        [im, np.stack([x, y, depth], -1)], axis=-1
    ).astype(np.float32)


def to_batch(im1s, im2s, flows, valids, s6, t6, mgt, with_mask, device):
    """A FlowBatch of stacked numpy lists on ``device``."""
    from occlusionfusion_tpu_torch.models.flow_train import FlowBatch

    def t(xs, dtype=torch.float32):
        return torch.from_numpy(np.stack(xs)).to(device=device, dtype=dtype)

    kw = {}
    if with_mask:
        kw = dict(src_rgbd6=t(s6), tgt_rgbd6=t(t6), mask_gt=t(mgt, torch.bool))
    return FlowBatch(im1=t(im1s), im2=t(im2s), flow_gt=t(flows),
                     flow_valid=t(valids, torch.bool), **kw)


def _padder(H, W):
    Hp = -(-H // 64) * 64
    Wp = -(-W // 64) * 64

    def pad(a, fill=0.0):
        widths = [(0, Hp - H), (0, Wp - W)] + [(0, 0)] * (a.ndim - 2)
        return np.pad(a, widths, constant_values=fill)

    return pad


def make_batch_rendered(rng, batch, H, W, with_mask, shapes, n_verts,
                        max_gap, device=None):
    """RGB-D pairs rendered by the point-splat renderer from the
    procedural shapes, exact GT flow and occlusion mask GT, zero-padded to
    PWC's 64-divisible size (pad band invalid)."""
    from occlusionfusion_tpu_torch.data.synthetic_shapes import (
        rendered_flow_pair,
    )

    pad = _padder(H, W)
    im1s, im2s, flows, valids, s6, t6, mgt = [], [], [], [], [], [], []
    for _ in range(batch):
        p = rendered_flow_pair(
            rng, H=H, W=W, shapes=shapes, n_verts=n_verts, max_gap=max_gap
        )
        im1s.append(pad(p["im1"]))
        im2s.append(pad(p["im2"]))
        flows.append(pad(p["flow"]))
        valids.append(pad(p["valid"], False))
        if with_mask:
            s6.append(pad(p["src6"]))
            t6.append(pad(p["tgt6"]))
            mgt.append(pad(p["mask_gt"], False))
    return to_batch(im1s, im2s, flows, valids, s6, t6, mgt, with_mask, device)


def make_batch_deepdeform(ds, rng, batch, H, W, with_mask, depth_tol=0.02,
                          index_pool=None, device=None):
    """Batches from a DeepDeform-layout dataset, by random index; flow GT
    holes are the format's -Inf; the mask GT is the depth consistency of
    the GT-flowed target."""
    pad = _padder(H, W)
    im1s, im2s, flows, valids, s6, t6, mgt = [], [], [], [], [], [], []
    for _ in range(batch):
        if index_pool is not None:
            s = ds[int(index_pool[rng.randint(len(index_pool))])]
        else:
            s = ds[int(rng.randint(len(ds)))]
        src, tgt = s["source"], s["target"]  # [6, H, W]
        flow = s["optical_flow"].transpose(1, 2, 0)
        valid = np.isfinite(flow).all(-1) & (src[5] > 0)
        flow = np.where(valid[..., None], flow, 0.0).astype(np.float32)
        vv, uu = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing="ij")
        uj = np.clip(np.round(uu + flow[..., 0]).astype(int), 0, W - 1)
        vj = np.clip(np.round(vv + flow[..., 1]).astype(int), 0, H - 1)
        inb = (
            (uu + flow[..., 0] >= 0) & (uu + flow[..., 0] <= W - 1)
            & (vv + flow[..., 1] >= 0) & (vv + flow[..., 1] <= H - 1)
        )
        zgt = src[5] + np.where(
            np.isfinite(s["scene_flow"][2]), s["scene_flow"][2], 0.0
        )
        ztgt = tgt[5][vj, uj]
        mask = valid & inb & (ztgt > 0) & (np.abs(zgt - ztgt) < depth_tol)
        im1s.append(pad(src[:3].transpose(1, 2, 0)))
        im2s.append(pad(tgt[:3].transpose(1, 2, 0)))
        flows.append(pad(flow))
        valids.append(pad(valid, False))
        if with_mask:
            s6.append(pad(src.transpose(1, 2, 0)))
            t6.append(pad(tgt.transpose(1, 2, 0)))
            mgt.append(pad(mask, False))
    return to_batch(im1s, im2s, flows, valids, s6, t6, mgt, with_mask, device)


def make_batch(rng, batch, H, W, with_mask, augment_rot=0.0, device=None):
    """Synthetic noise pairs; ``augment_rot`` rotates source and target
    independently and composes the GT flow through both rotations
    (``ops/image_warp``, on the CPU)."""
    im1s, im2s, flows, valids, s6, t6, mgt = [], [], [], [], [], [], []
    for _ in range(batch):
        im1, im2, flow, valid = synthetic_pair(rng, H, W)
        if augment_rot:
            from occlusionfusion_tpu_torch.ops.image_warp import (
                augmented_flow_from_rotation,
                rotate_image,
                rotation_flow,
            )

            a_s = np.float32(rng.uniform(-augment_rot, augment_rot))
            a_t = np.float32(rng.uniform(-augment_rot, augment_rot))
            im1 = rotate_image(torch.from_numpy(im1), a_s).numpy()
            im2 = rotate_image(torch.from_numpy(im2), a_t).numpy()
            aug, v = augmented_flow_from_rotation(
                rotation_flow(H, W, a_s), torch.from_numpy(flow),
                torch.from_numpy(valid), rotation_flow(H, W, -a_t),
            )
            flow, valid = aug.numpy(), v.numpy()
        im1s.append(im1)
        im2s.append(im2)
        flows.append(flow)
        valids.append(valid)
        if with_mask:
            s6.append(synthetic_rgbd6(rng, im1, H, W))
            t6.append(synthetic_rgbd6(rng, im2, H, W))
            mgt.append(valid)
    return to_batch(im1s, im2s, flows, valids, s6, t6, mgt, with_mask, device)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--with_mask", action="store_true")
    ap.add_argument("--augment_rot", type=float, default=0.0,
                    help="rotation-composition flow augmentation: max "
                         "|angle| (radians) applied independently to "
                         "source and target")
    ap.add_argument("--data", default="noise",
                    choices=("noise", "rendered", "deepdeform"))
    ap.add_argument("--shapes", default="blob,limbs,arms",
                    help="comma list of shapes for --data rendered")
    ap.add_argument("--deepdeform", default=None,
                    help="DeepDeform-layout root for --data deepdeform")
    ap.add_argument("--split", default="train",
                    help="split json name under --deepdeform")
    ap.add_argument("--verts", type=int, default=5000,
                    help="points per rendered shape (--data rendered)")
    ap.add_argument("--max_gap", type=int, default=2,
                    help="max extra frame gap in rendered pairs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="checkpoints/flow.npz")
    ap.add_argument("--log_every", type=int, default=25)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--resume", default=None,
                    help="checkpoint npz to continue from (params only)")
    ap.add_argument("--through_solver", action="store_true",
                    help="train PWC + MaskNet through the Gauss-Newton "
                         "solve (graph/warp losses backpropagated into "
                         "both nets)")
    ap.add_argument("--gn_iters", type=int, default=3,
                    help="GN iterations inside --through_solver training")
    ap.add_argument("--matches", type=int, default=512,
                    help="match pixels per sample (--through_solver)")
    ap.add_argument("--nodes", type=int, default=32,
                    help="graph nodes per sample (--through_solver)")
    ap.add_argument("--eval_pairs", type=int, default=8,
                    help="held-out pairs for the EPE-3D eval "
                         "(--through_solver)")
    ap.add_argument("--sparse_flow_frac", type=float, default=1.0,
                    help="fraction of pixels keeping flow GT during "
                         "--through_solver training")
    ap.add_argument("--corrupt_flow", action="store_true",
                    help="--through_solver: flow GT wrong but valid at "
                         "occlusion boundaries and depth holes")
    ap.add_argument("--no_solver_terms", action="store_true",
                    help="ablation: zero the graph/warp loss terms")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def flow_checkpoint(pwc, mask):
    """{"pwc": tree, "mask": tree} in the JAX package's layout."""
    from occlusionfusion_tpu_torch.models.checkpoint import (
        masknet_params_to_jax,
        pwc_params_to_jax,
    )

    out = {"pwc": pwc_params_to_jax(pwc)}
    if mask is not None:
        out["mask"] = masknet_params_to_jax(mask)
    return out


def load_flow_tree(path):
    """A flow checkpoint as its nested tree (split at "/")."""
    from occlusionfusion_tpu_torch.models.checkpoint import nest_flat_dict

    data = np.load(path)
    return nest_flat_dict({k: data[k] for k in data.files}, sep="/")


def main(argv=None):
    args = build_parser().parse_args(argv)
    from occlusionfusion_tpu_torch.device import resolve_device
    from occlusionfusion_tpu_torch.models.checkpoint import (
        masknet_params_from_jax,
        pwc_params_from_jax,
    )
    from occlusionfusion_tpu_torch.models.optim import Adam
    from occlusionfusion_tpu_torch.models.pwcnet import (
        init_masknet,
        init_pwcnet,
    )
    from occlusionfusion_tpu_torch.utils.snapshot import save_pytree

    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu)")
    rng = np.random.RandomState(args.seed)
    pwc = init_pwcnet(torch.Generator().manual_seed(args.seed), dev)
    mask = None
    if args.with_mask or args.through_solver:
        mask = init_masknet(torch.Generator().manual_seed(args.seed + 1), dev)
    if args.resume:
        tree = load_flow_tree(args.resume)
        pwc.load_state_dict(pwc_params_from_jax(tree["pwc"]))
        if mask is not None and "mask" in tree:
            mask.load_state_dict(masknet_params_from_jax(tree["mask"]))
        print(f"resumed params from {args.resume}")
    nets = [pwc] + ([mask] if mask is not None else [])
    params = [p for n in nets for p in n.parameters()]
    opt = Adam(params, args.lr)

    def save():
        save_pytree(args.out, flow_checkpoint(pwc, mask))

    if args.through_solver:
        from occlusionfusion_tpu_torch.models.deform_loss import (
            DeformLossWeights,
        )
        from occlusionfusion_tpu_torch.models.tracking_train import (
            epe3d,
            make_tracking_train_step,
            stack_samples,
            synthetic_tracking_sample,
        )
        from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

        gn = GNConfig(iters=args.gn_iters, w_arap=1.0)
        lw = DeformLossWeights()
        if args.no_solver_terms:
            lw = lw._replace(lambda_graph=0.0, lambda_warp=0.0)
        step = make_tracking_train_step(pwc, opt, gn, mask_net=mask,
                                        weights=lw)

        def make_samples(r, k, sparse=True):
            out = []
            for _ in range(k):
                s = synthetic_tracking_sample(
                    r, H=args.height, W=args.width, n_nodes=args.nodes,
                    n_matches=args.matches,
                    corrupt_flow=args.corrupt_flow and sparse, device=dev,
                )
                if sparse and args.sparse_flow_frac < 1.0:
                    keep = r.rand(args.height, args.width) < (
                        args.sparse_flow_frac)
                    s = s._replace(flow_valid=s.flow_valid & torch.from_numpy(
                        keep).to(dev))
                out.append(s)
            return out

        heldout = make_samples(np.random.RandomState(10_000 + args.seed),
                               args.eval_pairs, sparse=False)

        def eval_epe3d():
            with torch.no_grad():
                return float(torch.mean(torch.stack(
                    [epe3d(pwc, mask, s, gn) for s in heldout])))

        t0 = time.time()
        for i in range(args.steps):
            loss, terms = step(stack_samples(make_samples(rng, args.batch)))
            if i % args.log_every == 0 or i == args.steps - 1:
                tstr = " ".join(
                    f"{k} {float(v):.4f}" for k, v in sorted(terms.items()))
                print(f"step {i}: loss {float(loss):.4f} [{tstr}] "
                      f"heldout_epe3d {eval_epe3d():.4f} m "
                      f"({time.time() - t0:.0f}s)", flush=True)
            if args.save_every and i and i % args.save_every == 0:
                save()
        save()
        print(f"saved {args.out}; final held-out EPE-3D {eval_epe3d():.4f} m")
        return

    from occlusionfusion_tpu_torch.models.flow_train import (
        epe_px,
        make_flow_train_step,
    )

    step = make_flow_train_step(pwc, opt, mask_net=mask)
    shapes = tuple(s for s in args.shapes.split(",") if s)
    ds = None
    if args.data == "deepdeform":
        if not args.deepdeform:
            raise SystemExit("--data deepdeform requires --deepdeform ROOT")
        from occlusionfusion_tpu_torch.data.deepdeform import (
            DeepDeformConfig,
            DeepDeformDataset,
        )

        ds = DeepDeformDataset(args.deepdeform, args.split, DeepDeformConfig(
            image_height=args.height, image_width=args.width))
        print(f"deepdeform: {len(ds)} pairs from {args.deepdeform}")
    # deepdeform: a fixed index subset held out for the eval
    train_pool = heldout_pool = None
    if ds is not None:
        n_held = max(args.batch, min(len(ds) // 10, 256))
        heldout_pool = np.arange(len(ds) - n_held, len(ds))
        train_pool = np.arange(len(ds) - n_held)
        if len(train_pool) == 0:
            train_pool = heldout_pool  # degenerate tiny split
        print(f"deepdeform heldout: {len(heldout_pool)} reserved pairs")

    def next_batch(r, pool=None):
        if args.data == "deepdeform":
            return make_batch_deepdeform(
                ds, r, args.batch, args.height, args.width, mask is not None,
                index_pool=train_pool if pool is None else pool, device=dev)
        if args.data == "rendered":
            return make_batch_rendered(
                r, args.batch, args.height, args.width, mask is not None,
                shapes, args.verts, args.max_gap, device=dev)
        return make_batch(r, args.batch, args.height, args.width,
                          mask is not None, augment_rot=args.augment_rot,
                          device=dev)

    heldout = next_batch(np.random.RandomState(77_000 + args.seed),
                         pool=heldout_pool)

    def heldout_epe():
        with torch.no_grad():
            return float(epe_px(pwc, heldout.im1, heldout.im2,
                                heldout.flow_gt, heldout.flow_valid))

    t0 = time.time()
    for i in range(args.steps):
        loss = step(next_batch(rng))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f} heldout_epe "
                  f"{heldout_epe():.3f} px ({time.time() - t0:.0f}s)",
                  flush=True)
        if args.save_every and i and i % args.save_every == 0:
            save()
    save()
    print(f"saved {args.out}; final held-out EPE {heldout_epe():.3f} px")


if __name__ == "__main__":
    main()
