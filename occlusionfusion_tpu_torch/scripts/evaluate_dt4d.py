"""Evaluate fusion on DeformingThings4D-style clips: the port of
``scripts/evaluate_dt4d.py``, with its flags and defaults; the JAX
script's ``--tpu`` is ``--device`` here (the card unless ``cpu``).

  python -m occlusionfusion_tpu_torch.scripts.evaluate_dt4d \
      --anime clip.anime [--frames 20] [--device cpu]
  python -m occlusionfusion_tpu_torch.scripts.evaluate_dt4d --synthetic \
      --shape limbs --rotate_deg 3 [--flow_weights checkpoints/flow.npz \
      --textured] [--lepard_weights checkpoints/lepard_trained.npz]
  python -m occlusionfusion_tpu_torch.scripts.evaluate_dt4d --synthetic \
      --trajectory results/trajectory.npz

Renders a depth (or, ``--textured``, RGB-D) sequence from an ``.anime``
clip (``--synthetic`` writes one with ``data/synthetic_shapes``), runs
``DynamicFusion`` on it (the fused step, or ``--stepwise``'s
``register_frame`` loop, which flow, Lepard and keyframes take), tracks
the clip's ground-truth vertices through the estimated warp field and
prints the JAX script's metrics JSON: ``ate_m``, ``pose_ate_m``,
``rot_err_deg``, ``final_epe_m``, ``mean_epe_m``, ``frames``, ``nodes``,
``seconds`` and ``valid_solve_ratio``. With ``--trajectory`` it scores
an exported keyframe trajectory against the clip's ground-truth rigid
poses instead. ``main`` returns the metrics and the per-frame details
(EPE, correspondences, estimated poses).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def synthetic_anime(path, n_frames=16, n_verts=6000, seed=0,
                    rotate_deg=0.0, shape="blob", rotate_osc_deg=0.0):
    """Write a synthetic deforming clip (``data/synthetic_shapes``):
    ``blob`` (a sphere with a moving bulge), ``limbs`` (four lobes whose
    local geometry a matcher can tell apart) or ``arms`` (two swinging
    limbs crossing the body), with ``rotate_deg`` of in-plane rotation a
    frame (tangential motion projective association cannot see) and an
    oscillation of ``rotate_osc_deg``."""
    from occlusionfusion_tpu_torch.data.deformingthings4d import save_anime
    from occlusionfusion_tpu_torch.data.synthetic_shapes import shape_clip

    verts, faces, offsets = shape_clip(
        shape, n_frames, n_verts, seed=seed, rotate_deg=rotate_deg,
        rotate_osc_deg=rotate_osc_deg)
    save_anime(path, verts, faces, offsets)
    return path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--anime", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--solver", default="gn_dense")
    ap.add_argument("--gn_iters", type=int, default=0,
                    help="gn_dense iterations (0 = the engine's 6)")
    ap.add_argument("--use_motion_model", action="store_true")
    ap.add_argument("--shape", default="blob",
                    choices=("blob", "limbs", "arms"))
    ap.add_argument("--rotate_deg", type=float, default=0.0,
                    help="synthetic clip: in-plane rotation a frame")
    ap.add_argument("--rotate_osc", type=float, default=0.0,
                    help="oscillating in-plane rotation amplitude (deg)")
    ap.add_argument("--camera_path", default="static",
                    choices=("static", "truck_return", "orbit_return"))
    ap.add_argument("--camera_amp", type=float, default=0.25)
    ap.add_argument("--camera_orbit_deg", type=float, default=25.0)
    ap.add_argument("--textured", action="store_true",
                    help="procedural per-vertex texture instead of grey")
    ap.add_argument("--flow_weights", default=None,
                    help="PWC(+MaskNet) checkpoint: flow correspondences "
                         "in the stepwise loop (implies --textured)")
    ap.add_argument("--flow_downscale", type=int, default=1)
    ap.add_argument("--flow_mode", default="fill",
                    choices=("fill", "override", "advect"))
    ap.add_argument("--flow_advect_min_px", type=float, default=0.0)
    ap.add_argument("--flow_advect_weight", type=float, default=1.0)
    ap.add_argument("--flow_advect_mask", type=float, default=None)
    ap.add_argument("--flow_advect_alpha", type=float, default=1.0)
    ap.add_argument("--lepard_subsample", default="topk",
                    choices=("topk", "strided"))
    ap.add_argument("--print_infos", action="store_true",
                    help="print each stepwise frame's info dict")
    ap.add_argument("--lepard_threshold", type=float, default=None,
                    help="the matcher's coarse match confidence threshold")
    ap.add_argument("--lepard_reloc_only", action="store_true",
                    help="the matcher only for feature-seeded recovery")
    ap.add_argument("--lepard_coherence", type=float, default=None,
                    help="the motion-coherence filter's tau")
    ap.add_argument("--lepard_coherence_mad", type=float, default=None,
                    help="the coherence threshold's MAD multiplier")
    ap.add_argument("--lepard_every", type=int, default=1)
    ap.add_argument("--lepard_weights", default=None,
                    help="matcher checkpoint: the stepwise loop with "
                         "learned scene flow")
    ap.add_argument("--stepwise", action="store_true",
                    help="the stepwise register_frame loop instead of "
                         "the fused step")
    ap.add_argument("--out", default=None, help="write metrics JSON here")
    ap.add_argument("--trajectory", default=None,
                    help="score an exported trajectory.npz against the "
                         "clip's ground-truth rigid poses")
    ap.add_argument("--gt", default=None,
                    help="gt_vertices.npy (convert_dt4d) for --trajectory")
    ap.add_argument("--recovery", action="store_true")
    ap.add_argument("--keyframe_interval", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


INTR = (300.0, 300.0, 80.0, 80.0)
IMAGE_HW = (160, 160)


def render_clip(args, path, intr, dev):
    """(depths, colors or None, gt vertices [F, nv, 3]) of the clip."""
    from occlusionfusion_tpu_torch.data import deformingthings4d as DT

    cam_poses = None
    if args.camera_path != "static":
        from occlusionfusion_tpu_torch.data.synthetic_shapes import (
            camera_path,
        )

        cam_poses = camera_path(args.camera_path, args.frames,
                                amp=args.camera_amp,
                                orbit_deg=args.camera_orbit_deg)
    kw = dict(image_hw=IMAGE_HW, max_frames=args.frames,
              camera_poses=cam_poses, device=dev)
    if args.textured or args.flow_weights is not None:
        return DT.anime_to_rgbd_sequence(path, intr, **kw)
    depths, gt = DT.anime_to_depth_sequence(path, intr, **kw)
    return depths, None, gt


def load_nets(args, dev):
    """(motion net, flow net, mask net, lepard net), each None unless
    asked for."""
    from occlusionfusion_tpu_torch.models import checkpoint as ck

    motion_net = flow_net = mask_net = lepard_net = None
    if args.use_motion_model:
        motion_net = ck.load_motion_complete_net(None, device=dev)
    if args.lepard_weights:
        with open(args.lepard_weights + ".json") as fh:
            cfg = ck.lepard_config_from_json(json.load(fh))
        for flag, field in (("lepard_threshold", "match_threshold"),
                            ("lepard_coherence", "coherence_tau"),
                            ("lepard_coherence_mad", "coherence_mad")):
            if getattr(args, flag) is not None:
                cfg = cfg._replace(**{field: getattr(args, flag)})
        lepard_net, _ = ck.load_lepard_checkpoint(args.lepard_weights,
                                                  device=dev, config=cfg)
    if args.flow_weights:
        flow_net, mask_net = ck.load_flow_nets(args.flow_weights, device=dev)
    return motion_net, flow_net, mask_net, lepard_net


def fusion_config(args, use_flow: bool, use_lepard: bool):
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
    from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig

    nicp = NICPConfig(iters=100, lr=0.02,
                      w_motion=100.0 if args.use_motion_model else 0.0)
    if args.gn_iters:
        gn = GNConfig(iters=args.gn_iters, w_point=1.0, w_arap=10.0,
                      w_motion=1.0 if args.use_motion_model else 0.0)
    else:  # the engine's own mapping of the N-ICP weights
        gn = GNConfig(iters=6, w_point=nicp.w_ldmk, w_arap=nicp.w_arap,
                      w_motion=nicp.w_motion / 100.0)
    return FusionConfig(
        vol_dim=(64, 64, 64), voxel_size=0.006, node_coverage=0.03,
        max_nodes=512, max_points=4096, max_depth_diff=0.04,
        graph=GraphConfig(node_coverage=0.03, min_neighbors=2),
        nicp=nicp, gn=gn, use_motion_model=args.use_motion_model,
        solver=args.solver,
        use_lepard=use_lepard and not args.lepard_reloc_only,
        relocalize_feat_min_points=50 if args.lepard_reloc_only else 0,
        lepard_every=args.lepard_every,
        lepard_subsample=args.lepard_subsample, use_flow=use_flow,
        keyframe_interval=args.keyframe_interval,
        relocalize_recovery=args.recovery,
        flow_downscale=args.flow_downscale, flow_mode=args.flow_mode,
        flow_advect_min_px=args.flow_advect_min_px,
        flow_advect_weight=args.flow_advect_weight,
        flow_advect_mask_threshold=args.flow_advect_mask,
        flow_advect_alpha=args.flow_advect_alpha,
    )


def track(args, seq, depths, gt, intr, dev):
    """Fusion over the clip with the ground-truth vertices of frame 0
    carried through the warp field -> (metrics, details)."""
    from occlusionfusion_tpu_torch.data.deformingthings4d import (
        pose_trajectory_ate,
        rigid_pose_np,
        trajectory_ate,
    )
    from occlusionfusion_tpu_torch.fusion import warpfield as W
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.fusion.tsdf import check_visibility
    from occlusionfusion_tpu_torch.geometry.skinning import skinning_weights
    from occlusionfusion_tpu_torch.utils.metrics import epe_3d

    motion_net, flow_net, mask_net, lepard_net = load_nets(args, dev)
    if lepard_net is not None or flow_net is not None or (
            args.keyframe_interval):
        args.stepwise = True  # these run in the stepwise loop
    cfg = fusion_config(args, flow_net is not None, lepard_net is not None)
    fusion = DynamicFusion(seq, cfg, device=dev, flow_net=flow_net,
                           mask_net=mask_net, lepard_net=lepard_net)
    t0 = time.perf_counter()
    with torch.no_grad():
        fusion.initialize(seq.load(0))
        if args.stepwise:
            nodes, nvalid = fusion.warp.node_positions, fusion.node_valid
        else:
            sc, state, tables = fusion.build_fused(motion_net)
            nodes, nvalid = tables.nodes, tables.node_valid
        gt0 = torch.as_tensor(gt[0], device=dev)
        table = W.SkinTable(*skinning_weights(gt0, nodes, nvalid,
                                              cfg.node_coverage, k=4))
    reach = table.valid.cpu().numpy()
    nodes_np, nvalid_np = nodes.cpu().numpy(), nvalid.cpu().numpy()
    per_frame_epe, corr, tracked = [], [], [np.asarray(gt[0])]
    est_ids, est_R = [0], [np.eye(3, dtype=np.float32)]
    est_t = [np.zeros(3, np.float32)]
    n_valid_solves = 0
    for i in range(1, args.frames):
        with torch.no_grad():
            if args.stepwise:
                finfo = fusion.register_frame(seq.load(i), motion_net)
                n_valid_solves += int(finfo.get("solve_valid", True))
                corr.append(finfo["n_correspondences"])
                if args.print_infos:
                    print(f"frame {i}: {finfo}", flush=True)
                warp = fusion.warp
            else:
                state, info = fusion.register_frame_fused(
                    sc, state, tables, seq.load(i), motion_net)
                info = info.cpu().numpy()
                n_valid_solves += int(float(info[4]) > 0.5)
                corr.append(int(info[1]))
                warp = W.WarpFieldState(nodes, nvalid, state.rotations,
                                        state.translations)
            pred = W.deform_points(warp, gt0, table)
            gti = torch.as_tensor(gt[i], device=dev)
            vis, _ = check_visibility(gti, torch.as_tensor(depths[i],
                                                           device=dev),
                                      intr, 0.01)
            visible = table.valid & vis
            per_frame_epe.append(float(epe_3d(pred, gti, visible)))
        tracked.append(pred.cpu().numpy())
        # the estimated global rigid pose: Kabsch canonical -> deformed
        # nodes (pivoted transforms: a deformed node is g + t)
        deformed = nodes_np + warp.translations.cpu().numpy()
        Re, te = rigid_pose_np(nodes_np[nvalid_np], deformed[nvalid_np])
        est_ids.append(i)
        est_R.append(Re)
        est_t.append(te)
    ate = trajectory_ate(np.stack(tracked)[:, reach],
                         gt[: args.frames][:, reach])
    pose = pose_trajectory_ate(np.asarray(est_ids), np.stack(est_R),
                               np.stack(est_t), gt)
    elapsed = time.perf_counter() - t0
    metrics = {
        "ate_m": round(ate, 5),
        "pose_ate_m": round(pose["pose_ate_m"], 5),
        "rot_err_deg": round(pose["rot_err_deg"], 3),
        "final_epe_m": round(per_frame_epe[-1], 5),
        "mean_epe_m": round(float(np.mean(per_frame_epe)), 5),
        "frames": args.frames,
        "nodes": int(fusion.node_count),
        "seconds": round(elapsed, 1),
        "valid_solve_ratio": round(
            n_valid_solves / max(args.frames - 1, 1), 4),
    }
    details = dict(ate_m=ate, pose_ate_m=pose["pose_ate_m"],
                   per_frame_epe=per_frame_epe, n_correspondences=corr,
                   frame_ids=np.asarray(est_ids), rotations=np.stack(est_R),
                   translations=np.stack(est_t),
                   n_valid_solves=n_valid_solves)
    return metrics, details


def evaluate(args, dev, clip_dir):
    from occlusionfusion_tpu_torch.data.deformingthings4d import (
        pose_trajectory_ate,
    )
    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    path = args.anime
    if args.synthetic or (path is None and args.gt is None):
        path = synthetic_anime(
            os.path.join(clip_dir, "synthetic_clip.anime"), args.frames + 1,
            rotate_deg=args.rotate_deg, shape=args.shape,
            rotate_osc_deg=args.rotate_osc)
    intr = Intrinsics(*(float(np.float32(x)) for x in INTR))
    if args.gt is not None:
        gt, depths, colors = np.load(args.gt), None, None
    else:
        depths, colors, gt = render_clip(args, path, intr, dev)
    if args.trajectory:
        data = np.load(args.trajectory)
        metrics = pose_trajectory_ate(data["frame_ids"], data["rotations"],
                                      data["translations"], gt)
        return metrics, dict(metrics)
    if colors is None:
        colors = [np.full(depths[0].shape + (3,), 128.0, np.float32)
                  for _ in depths]
    seq = ArraySequence(list(colors), list(depths), intr)
    return track(args, seq, depths, gt, intr, dev)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.gt is not None and not args.trajectory:
        ap.error("--gt is only meaningful with --trajectory")
    from occlusionfusion_tpu_torch.device import require_device

    dev = require_device(args.device)
    with tempfile.TemporaryDirectory(prefix="evaluate_dt4d_") as clip_dir:
        metrics, details = evaluate(args, dev, clip_dir)
    print(json.dumps(metrics))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(metrics, fh)
    return metrics, details


if __name__ == "__main__":
    main()
