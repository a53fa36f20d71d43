"""Train the Lepard-style matcher with the focal correspondence loss, with
the port: the recipe of ``scripts/train_lepard.py``, its flags and
defaults, plus ``--device`` (the card unless ``--device cpu``).

  python -m occlusionfusion_tpu_torch.scripts.train_lepard --steps 2000 \
      --out checkpoints/lepard_trained.npz [--device cpu]

Data: a 4DMatch npz root (``--data``), or synthetic pairs (smooth-surface
clouds under a bounded rigid motion and a smooth non-rigid warp, with
noise and partial overlap) mixed with ``--rendered_frac`` pairs
backprojected from the procedural shapes' rendered depth. Linear warm-up
and cosine decay, AdamW after global-norm clipping at 1
(``models/optim.py``, optax's semantics: the first step's learning rate
is the schedule at 0). The checkpoint is the JAX package's npz with its
``.json`` side-car (``save_lepard_checkpoint``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def random_rotation(rng, max_angle: float = np.pi):
    """Random rotation with angle ~ U(0, max_angle) about a random axis.

    Full SO(3) is NOT the fusion loop's regime — the matcher registers
    the deformed model against the *next* frame's depth, so inter-frame
    rotations are bounded; training with bounded angles (ramped by the
    curriculum) matches deployment and actually converges."""
    axis = rng.randn(3).astype(np.float32)
    axis /= np.linalg.norm(axis) + 1e-9
    ang = rng.uniform(0, max_angle)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
         [-axis[1], axis[0], 0]], np.float32)
    return (np.eye(3, dtype=np.float32) + np.sin(ang) * K
            + (1 - np.cos(ang)) * (K @ K))


def surface_cloud(rng, n):
    """Points on a random smooth closed surface (radially-modulated
    sphere) — surface-like local neighborhoods, matching what KPConv
    sees in deployment (TSDF mesh vertices / depth backprojections),
    unlike volumetric gaussian noise."""
    v = rng.randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    r = np.full(n, 0.35, np.float32)
    for _ in range(3):
        k = rng.randn(3).astype(np.float32) * rng.uniform(1.0, 4.0)
        r += (0.1 * rng.rand() * np.sin(v @ k + rng.uniform(0, 2 * np.pi))
              ).astype(np.float32)
    return v * r[:, None]


def smooth_warp(rng, pts, amplitude=0.04, n_waves=3):
    """Low-frequency trigonometric displacement field (smooth non-rigid)."""
    disp = np.zeros_like(pts)
    for _ in range(n_waves):
        k = rng.randn(3).astype(np.float32) * rng.uniform(2.0, 6.0)
        phase = rng.uniform(0, 2 * np.pi)
        a = rng.randn(3).astype(np.float32)
        a *= amplitude / (np.linalg.norm(a) + 1e-9) * rng.rand()
        disp += np.sin(pts @ k + phase)[:, None] * a
    return pts + disp.astype(np.float32)


def synthetic_pair(rng, n=192, cap=256, nonrigid=True, overlap=0.8,
                   noise=0.005, max_angle=np.pi / 3,
                   warp_amplitude=0.04, scale_range=(0.3, 1.3)):
    """Pair with known correspondences: smooth-surface cloud -> smooth
    warp -> bounded rigid -> noise; a random half-space of the target is
    dropped (partial overlap) and replaced with distractor points.

    Global scale augmentation (``scale_range``): the KPConv pyramid's
    first_voxel is FIXED at deployment, so the matcher must work across
    object sizes — without this the shipped checkpoint matched 0.35-
    radius training clouds but produced ~0 valid matches on the 0.12-
    radius DT4D eval blob."""
    if n > cap:
        raise ValueError(
            f"synthetic_pair: points ({n}) must be <= cap ({cap}); "
            "raise --cap or lower --points"
        )
    s = rng.uniform(*scale_range)
    src = surface_cloud(rng, n) * np.float32(s)
    warped = (smooth_warp(rng, src, amplitude=warp_amplitude * s)
              if nonrigid else src)
    R = random_rotation(rng, max_angle)
    t = rng.randn(3).astype(np.float32) * (0.1 * s)
    tgt = (warped @ R.T + t + rng.randn(n, 3) * noise).astype(np.float32)

    # partial overlap: drop target points on one side of a random plane
    normal = rng.randn(3).astype(np.float32)
    normal /= np.linalg.norm(normal)
    scores = (tgt - tgt.mean(0)) @ normal
    keep = scores <= np.quantile(scores, overlap)
    kept_idx = np.nonzero(keep)[0]
    n_tgt = len(kept_idx)
    # distractors: points near the kept surface but without a source match
    n_extra = min(cap - n_tgt, max(n // 8, 1))
    extra = (tgt[rng.choice(kept_idx, n_extra)] +
             rng.randn(n_extra, 3).astype(np.float32) * 0.08)

    src_p = np.zeros((cap, 3), np.float32)
    src_p[:n] = src
    sm = np.zeros(cap, bool)
    sm[:n] = True
    tgt_p = np.zeros((cap, 3), np.float32)
    tgt_p[:n_tgt] = tgt[kept_idx]
    tgt_p[n_tgt : n_tgt + n_extra] = extra
    tm = np.zeros(cap, bool)
    tm[: n_tgt + n_extra] = True

    # correspondences: src index -> position in the kept target list
    inv = -np.ones(n, np.int64)
    inv[kept_idx] = np.arange(n_tgt)
    cs = np.zeros(cap, np.int32)
    ct = np.zeros(cap, np.int32)
    cm = np.zeros(cap, bool)
    m = 0
    for i in range(n):
        if inv[i] >= 0 and m < cap:
            cs[m], ct[m], cm[m] = i, inv[i], True
            m += 1
    return src_p, sm, tgt_p, tm, cs, ct, cm


def rendered_cloud_pair(rng, n=192, cap=256, shapes=("blob", "limbs", "arms"),
                        n_verts=4000, H=160, W=160, match_tol=0.015,
                        normalize_radius=0.3, max_gap=2,
                        rot_deg=0.0, return_aux=False):
    """Domain-matched matcher pair: source/target clouds backprojected
    from splat-rendered depth of the procedural deforming shapes, GT
    correspondences from the known vertex motion (a source point matches
    the target-cloud point nearest to its vertex's true target position,
    if within ``match_tol`` — occluded regions stay unmatched, which is
    the truth the matcher must learn to handle). Both clouds are
    normalized exactly as ``scene_flow`` does at inference (joint
    centroid, RMS radius -> ``normalize_radius``), so training sees the
    deployed scale distribution. Same return layout as
    ``synthetic_pair``.

    ``rot_deg``: relative-rotation augmentation — the target cloud (and
    the true target positions) are additionally rotated by a random
    rotation with angle up to ``rot_deg`` about the target centroid.
    The fusion loop's frame-to-frame matching sees bounded rotations,
    but wide-baseline relocalization (rotational ambiguity) needs the
    matcher to hold under large
    relative rotation; 180 covers full SO(3).

    ``return_aux``: also return (labels_src [cap], labels_tgt [cap],
    gt_pos [cap, 3], gt_pos_mask [cap]) — per-point surface-identity
    labels (``synthetic_shapes.surface_labels``) and the true
    (normalized-space) target-frame position of every source point.
    These power bridge-negative supervision: a target point
    geometrically near a source point's true position but on a
    DIFFERENT surface is exactly the confident-but-wrong bridge match
    the arms regime produces."""
    from occlusionfusion_tpu_torch.data.deformingthings4d import (
        frame_vertices,
    )
    from occlusionfusion_tpu_torch.data.synthetic_shapes import (
        _backproject,
        np_render,
        shape_clip,
    )
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    intr = Intrinsics(
        np.float32(300.0), np.float32(300.0),
        np.float32(W / 2), np.float32(H / 2),
    )
    shape = shapes[rng.randint(len(shapes))]
    n_frames = 10
    verts, _, offs = shape_clip(
        shape, n_frames, n_verts, seed=int(rng.randint(1 << 31)),
        rotate_deg=float(rng.uniform(0.0, 6.0)),
    )
    center = verts.mean(0)
    off = np.asarray([0.0, 0.0, 1.5], np.float32)
    s = float(rng.uniform(0.8, 1.25))
    i = int(rng.randint(0, n_frames - 1 - max_gap))
    j = i + 1 + int(rng.randint(max_gap))
    v_i = (frame_vertices(verts, offs, i) - center) * s + off
    v_j = (frame_vertices(verts, offs, j) - center) * s + off
    zeros = np.zeros((n_verts, 3), np.float32)
    d1, _, m1, win = np_render(v_i, zeros, intr, (H, W), splat_radius=2)
    d2, _, m2, win2 = np_render(v_j, zeros, intr, (H, W), splat_radius=2)

    src_xyz = _backproject(d1, intr)
    ys, xs = np.nonzero(m1 & (win < n_verts))
    pick_s = rng.choice(len(ys), min(n, len(ys)), replace=False)
    src_vid = win[ys[pick_s], xs[pick_s]]
    src = src_xyz[ys[pick_s], xs[pick_s]].astype(np.float32)
    gt_tgt_pos = v_j[src_vid]

    tgt_xyz = _backproject(d2, intr)
    ty, tx = np.nonzero(m2 & (win2 < n_verts))
    pick_t = rng.choice(len(ty), min(cap, len(ty)), replace=False)
    tgt_vid = win2[ty[pick_t], tx[pick_t]]
    tgt = tgt_xyz[ty[pick_t], tx[pick_t]].astype(np.float32)

    if rot_deg > 0.0:
        # relative-rotation augmentation about the target centroid; the
        # true target positions rotate with the target frame
        Raug = random_rotation(rng, np.deg2rad(rot_deg))
        tc = tgt.mean(0)
        tgt = ((tgt - tc) @ Raug.T + tc).astype(np.float32)
        gt_tgt_pos = ((gt_tgt_pos - tc) @ Raug.T + tc).astype(np.float32)

    # GT correspondence: nearest kept target point to the true target
    # position, gated by match_tol (metric space)
    d = np.linalg.norm(gt_tgt_pos[:, None] - tgt[None], axis=-1)
    nn = d.argmin(1)
    ok = d[np.arange(len(nn)), nn] < match_tol

    # inference-matching normalization (scene_flow normalize_radius)
    both = np.concatenate([src, tgt])
    c = both.mean(0)
    rms = np.sqrt(np.mean(np.sum((both - c) ** 2, -1)))
    sc = normalize_radius / max(rms, 1e-6)
    src = (src - c) * sc
    tgt = (tgt - c) * sc
    gt_tgt_pos = ((gt_tgt_pos - c) * sc).astype(np.float32)

    ns, nt = len(src), len(tgt)
    src_p = np.zeros((cap, 3), np.float32)
    src_p[:ns] = src
    sm = np.zeros(cap, bool)
    sm[:ns] = True
    tgt_p = np.zeros((cap, 3), np.float32)
    tgt_p[:nt] = tgt
    tm = np.zeros(cap, bool)
    tm[:nt] = True
    cs = np.zeros(cap, np.int32)
    ct = np.zeros(cap, np.int32)
    cm = np.zeros(cap, bool)
    k = 0
    for a in range(ns):
        if ok[a] and k < cap:
            cs[k], ct[k], cm[k] = a, nn[a], True
            k += 1
    if not return_aux:
        return src_p, sm, tgt_p, tm, cs, ct, cm
    from occlusionfusion_tpu_torch.data.synthetic_shapes import (
        surface_labels,
    )

    vlbl = surface_labels(shape, verts)
    lbl_s = np.zeros(cap, np.int32)
    lbl_s[:ns] = vlbl[src_vid]
    lbl_t = np.zeros(cap, np.int32)
    lbl_t[:nt] = vlbl[tgt_vid]
    gtp = np.zeros((cap, 3), np.float32)
    gtp[:ns] = gt_tgt_pos
    gtm = np.zeros(cap, bool)
    gtm[:ns] = True
    return src_p, sm, tgt_p, tm, cs, ct, cm, lbl_s, lbl_t, gtp, gtm


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--data", default=None, help="4DMatch root (optional)")
    ap.add_argument("--out", default="checkpoints/lepard_trained.npz")
    ap.add_argument("--eval_every", type=int, default=200)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--rigid_only", action="store_true")
    ap.add_argument("--max_angle_deg", type=float, default=60.0,
                    help="max rigid rotation of synthetic pairs")
    ap.add_argument("--levels", default="256,96,48,24",
                    help="KPConv pyramid level sizes (comma list)")
    ap.add_argument("--first_voxel", type=float, default=0.06,
                    help="level-0 subsample voxel (m)")
    ap.add_argument("--points", type=int, default=192,
                    help="synthetic cloud density (pre-subsample)")
    ap.add_argument("--cap", type=int, default=256,
                    help="padded input size of synthetic pairs")
    ap.add_argument("--max_neighbors", default=None,
                    help="per-level neighbor limits (comma list)")
    ap.add_argument("--full_depth", action="store_true",
                    help="reference-depth KPFCN (kpconv.full_depth_config)")
    ap.add_argument("--calibrate_neighbors", action="store_true",
                    help="calibrate per-level neighbor limits from sample "
                         "clouds before training; ignored with --resume")
    ap.add_argument("--scale_range", default="0.3,1.3",
                    help="global scale augmentation range of synthetic "
                         "pairs")
    ap.add_argument("--shapes", default="blob,limbs,arms",
                    help="comma list of procedural shapes for "
                         "--rendered_frac pairs")
    ap.add_argument("--bridge_boost", type=float, default=0.0,
                    help="extra negative-loss weight on cross-surface "
                         "bridge cells (needs --rendered_frac pairs); "
                         "0 = off")
    ap.add_argument("--bridge_radius", type=float, default=0.08,
                    help="canonical-space radius defining 'near' for "
                         "bridge negatives")
    ap.add_argument("--rendered_rot_deg", type=float, default=0.0,
                    help="relative-rotation augmentation of rendered pairs")
    ap.add_argument("--rendered_frac", type=float, default=0.0,
                    help="fraction of training pairs from rendered "
                         "depth-cloud pairs of the procedural shapes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default=None,
                    help="checkpoint npz to continue from (params and "
                         "side-car config)")
    ap.add_argument("--warm_start", default=None,
                    help="checkpoint npz whose params seed training while "
                         "the pyramid comes from --levels/--first_voxel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def check_flags(ap, args):
    """The JAX script's flag-consistency guards."""
    if args.points > args.cap:
        ap.error(f"--points ({args.points}) must be <= --cap ({args.cap})")
    if args.max_neighbors and args.calibrate_neighbors:
        ap.error("--max_neighbors and --calibrate_neighbors are mutually "
                 "exclusive (the override would discard the calibration)")
    if args.max_neighbors and (
        len(args.max_neighbors.split(",")) != len(args.levels.split(","))
    ):
        ap.error(f"--max_neighbors has {len(args.max_neighbors.split(','))} "
                 f"entries but --levels has {len(args.levels.split(','))}")
    if args.resume:
        for flag in ("levels", "first_voxel", "max_neighbors", "full_depth"):
            if getattr(args, flag) != ap.get_default(flag):
                ap.error(f"--{flag} is ignored with --resume (the config is "
                         "restored from the checkpoint side-car); use "
                         "--warm_start to seed params into a new pyramid")


def normalized_path_map(np_tree):
    """{path of str keys: leaf} of a nested dict/list tree, list indices
    and dict keys alike as strings (a checkpoint stores "0" where a fresh
    tree has 0; the JAX script matches leaves so)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[path] = node

    walk(np_tree, ())
    return out


def gt_matrix(m, src, tgt, corr_src, corr_tgt, corr_mask):
    """[S, T] binary ground truth at the coarse level: each correspondence
    at its points' nearest coarse points, duplicates max-combined."""
    from occlusionfusion_tpu_torch.ops.knn import knn_torch

    _, si = knn_torch(src[corr_src.long()], m.src_points, 1, m.src_valid)
    _, ti = knn_torch(tgt[corr_tgt.long()], m.tgt_points, 1, m.tgt_valid)
    S, T = m.src_points.shape[0], m.tgt_points.shape[0]
    flat = si[:, 0].long() * T + ti[:, 0].long()
    gt = torch.zeros(S * T, dtype=torch.float32, device=src.device)
    gt = gt.scatter_reduce(0, flat, corr_mask.to(torch.float32), "amax",
                           include_self=True)
    return gt.reshape(S, T)


def lepard_loss(net, src, sm, tgt, tm, cs, ct, cm, lbl_s, lbl_t, gtp, gtm,
                bridge_boost=0.0, bridge_radius=0.08):
    """The focal correspondence loss of one pair, with the bridge-negative
    weights where ``bridge_boost`` > 0."""
    from occlusionfusion_tpu_torch.models.deform_loss import (
        focal_correspondence_loss,
    )
    from occlusionfusion_tpu_torch.models.lepard import lepard_match
    from occlusionfusion_tpu_torch.ops.knn import knn_torch

    m = lepard_match(net, src, sm, tgt, tm)
    gt = gt_matrix(m, src, tgt, cs, ct, cm)
    valid = m.src_valid[:, None] & m.tgt_valid[None, :]
    neg_w = None
    if bridge_boost > 0.0:
        _, sidx = knn_torch(m.src_points, src, 1, sm)
        _, tidx = knn_torch(m.tgt_points, tgt, 1, tm)
        sidx, tidx = sidx[:, 0].long(), tidx[:, 0].long()
        gtp_c = gtp[sidx]
        gtm_c = gtm[sidx] & m.src_valid
        d2 = torch.sum((m.tgt_points[None, :, :] - gtp_c[:, None, :]) ** 2,
                       -1)
        bridge = ((d2 < bridge_radius**2)
                  & (lbl_s[sidx][:, None] != lbl_t[tidx][None, :])
                  & gtm_c[:, None] & m.tgt_valid[None, :] & (gt < 0.5))
        neg_w = 1.0 + bridge_boost * bridge.to(torch.float32)
    return focal_correspondence_loss(m.confidence, gt, valid,
                                     neg_weight=neg_w)


@torch.no_grad()
def eval_pair(net, src, sm, tgt, tm, cs, ct, cm, *aux):
    """(coarse match accuracy, inlier ratio of the thresholded mutual
    matches, match count) of one pair."""
    from occlusionfusion_tpu_torch.models.lepard import lepard_match

    m = lepard_match(net, src, sm, tgt, tm)
    gt = gt_matrix(m, src, tgt, cs, ct, cm)
    has_gt = (torch.sum(gt, dim=1) > 0) & m.src_valid
    rows = torch.arange(gt.shape[0], device=gt.device)
    hit = gt[rows, torch.argmax(m.confidence, dim=1)] > 0
    acc = torch.sum(hit & has_gt) / torch.clamp(torch.sum(has_gt), min=1)
    match_hit = gt[rows, m.match_tgt] > 0
    n_match = torch.clamp(torch.sum(m.match_valid), min=1)
    inlier = torch.sum(match_hit & m.match_valid) / n_match
    return float(acc), float(inlier), float(torch.sum(m.match_valid))


def neutral_aux(cap):
    """No surface identity and no true positions: the bridge term is off
    for the pair."""
    return (np.zeros(cap, np.int32), np.zeros(cap, np.int32),
            np.zeros((cap, 3), np.float32), np.zeros(cap, bool))


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    check_flags(ap, args)
    from occlusionfusion_tpu_torch.device import require_device
    from occlusionfusion_tpu_torch.models import kpconv as K
    from occlusionfusion_tpu_torch.models.checkpoint import (
        lepard_params_from_jax,
        lepard_params_to_jax,
        load_lepard_checkpoint,
        save_lepard_checkpoint,
    )
    from occlusionfusion_tpu_torch.models.lepard import (
        LepardConfig,
        init_lepard,
    )
    from occlusionfusion_tpu_torch.models.optim import (
        Adam,
        warmup_cosine_decay_schedule,
    )

    dev = require_device(args.device)
    levels = tuple(int(x) for x in args.levels.split(","))
    pyramid = K.PyramidConfig(level_sizes=levels, first_voxel=args.first_voxel)
    pair_kw = dict(
        n=args.points, cap=args.cap,
        scale_range=tuple(float(x) for x in args.scale_range.split(",")),
    )
    dataset = None
    if args.data:
        from occlusionfusion_tpu_torch.data.fourdmatch import (
            FourDMatchDataset,
        )

        dataset = FourDMatchDataset(args.data)
    if args.calibrate_neighbors and not args.resume:
        cal_rng = np.random.RandomState(20_000 + args.seed)

        def sample_clouds(n_samples=24):
            if dataset is not None:
                for i in range(min(n_samples, len(dataset))):
                    s = dataset[i]
                    yield s["source"], s["source_mask"]
                    yield s["target"], s["target_mask"]
                return
            for _ in range(n_samples):
                src_p, sm, tgt_p, tm, *_ = synthetic_pair(cal_rng, **pair_kw)
                yield src_p, sm
                yield tgt_p, tm

        pyramid = K.calibrate_neighbor_limits(sample_clouds(), pyramid)
        print(f"calibrated max_neighbors: {pyramid.max_neighbors}", flush=True)
    if args.max_neighbors:
        pyramid = pyramid._replace(max_neighbors=tuple(
            int(x) for x in args.max_neighbors.split(",")))
    cfg = LepardConfig(kpfcn=K.full_depth_config(pyramid=pyramid)
                       if args.full_depth else K.KPFCNConfig(pyramid=pyramid))
    gen = torch.Generator().manual_seed(args.seed)
    if args.resume:
        net, cfg = load_lepard_checkpoint(args.resume, device=dev)
        print(f"resumed params from {args.resume}")
    elif args.warm_start:
        warm, warm_cfg = load_lepard_checkpoint(args.warm_start, device="cpu")
        if args.full_depth and warm_cfg.kpfcn != K.full_depth_config(
            pyramid=warm_cfg.kpfcn.pyramid
        ):
            raise SystemExit("--full_depth conflicts with the --warm_start "
                             "checkpoint's architecture")
        # the checkpoint's architecture, the pyramid from the flags
        cfg = warm_cfg._replace(kpfcn=warm_cfg.kpfcn._replace(
            pyramid=pyramid))
        net = init_lepard(cfg, gen)
        warm_by_path = normalized_path_map(lepard_params_to_jax(warm))
        init_by_path = normalized_path_map(lepard_params_to_jax(net))
        if set(warm_by_path) != set(init_by_path) or any(
            warm_by_path[k].shape != init_by_path[k].shape
            for k in init_by_path
        ):
            raise SystemExit("--warm_start params do not match the "
                             "requested architecture (use matching "
                             "--full_depth etc.)")
        if warm_cfg.kpfcn.kp_layout != cfg.kpfcn.kp_layout:
            raise SystemExit("--warm_start kp_layout mismatch")
        net.load_state_dict(lepard_params_from_jax(lepard_params_to_jax(
            warm)))
        net = net.to(dev)
        print(f"warm-started params from {args.warm_start} "
              f"(pyramid {warm_cfg.kpfcn.pyramid.level_sizes} -> "
              f"{cfg.kpfcn.pyramid.level_sizes})")
    else:
        net = init_lepard(cfg, gen, dev)
    net.train()
    warmup = min(args.warmup, max(args.steps // 5, 1))
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=args.lr, warmup_steps=warmup,
        decay_steps=max(args.steps, warmup + 1), end_value=args.lr * 0.02,
    )
    opt = Adam(net.parameters(), schedule, weight_decay=1e-5, clip_norm=1.0)

    def to_dev(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in arrays)

    max_angle = np.deg2rad(args.max_angle_deg)

    def batch_from(rng, frac=1.0):
        if dataset is not None:
            s = dataset[rng.randint(len(dataset))]
            base = tuple(s[k] for k in (
                "source", "source_mask", "target", "target_mask",
                "corr_src", "corr_tgt", "corr_mask"))
            return to_dev(base + neutral_aux(len(s["source"])))
        if args.rendered_frac and rng.rand() < args.rendered_frac:
            return to_dev(rendered_cloud_pair(
                rng, n=args.points, cap=args.cap,
                shapes=tuple(args.shapes.split(",")),
                rot_deg=args.rendered_rot_deg, return_aux=True))
        # curriculum: rotation and warp amplitude ramp up over the first
        # half of training
        ramp = min(1.0, frac * 2.0)
        return to_dev(synthetic_pair(
            rng, nonrigid=not args.rigid_only, **pair_kw,
            max_angle=np.deg2rad(10.0) + ramp * max(
                max_angle - np.deg2rad(10.0), 0.0),
            warp_amplitude=0.01 + 0.03 * ramp,
        ) + neutral_aux(args.cap))

    rng = np.random.RandomState(args.seed)
    val_rng = np.random.RandomState(10_000 + args.seed)
    val_batches = [batch_from(val_rng) for _ in range(8)]

    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = batch_from(rng, step / max(args.steps, 1))
        opt.zero_grad()
        loss = lepard_loss(net, *batch, bridge_boost=args.bridge_boost,
                           bridge_radius=args.bridge_radius)
        loss.backward()
        opt.step()
        if step % args.eval_every == 0 or step == args.steps - 1:
            accs, inls, nms = zip(*(eval_pair(net, *vb) for vb in val_batches))
            print(f"step {step}: loss {float(loss):.4f} "
                  f"val acc {np.mean(accs):.3f} inlier {np.mean(inls):.3f} "
                  f"matches {np.mean(nms):.1f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if args.save_every and step and step % args.save_every == 0:
            save_lepard_checkpoint(args.out, net, cfg)
    save_lepard_checkpoint(args.out, net, cfg)
    print(f"saved {args.out} (+ .json config side-car)")


if __name__ == "__main__":
    main()
