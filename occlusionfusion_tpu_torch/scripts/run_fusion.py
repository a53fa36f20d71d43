"""Dynamic non-rigid fusion of an RGB-D sequence directory (``color/``,
``depth/``, [``mask/``], ``intrinsics.txt``) into a TSDF through the
estimated warp field, with occlusion-aware motion completion: the port of
``scripts/run_fusion.py``, with its flags, defaults and outputs, plus
``--device`` (the card unless ``cpu``).

  python -m occlusionfusion_tpu_torch.scripts.run_fusion \
      --datadir seq --results out [--solver gn_dense] [--device cpu]

``--engine fused`` (the default) drives ``DynamicFusion.run_fused``: CUDA
graphs of ``--chunk`` frames on the card (K1 in ``initialize`` and the
mesh, K2 every frame, K3'/K4' with ``--solver gn_dense``), and writes
``deformed_nodes_final.npy``; ``--engine object`` (and ``--resume_state``)
the stepwise ``register_frame`` loop, with ``deformed_nodes_NNNNNN.npy``
each frame and ``--export_mesh_every``. Both write ``convergence.json``,
``final_mesh.ply``, ``trajectory.npz`` with keyframes, and
``--save_state``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--results", default="results")
    ap.add_argument("--engine", default="fused", choices=("fused", "object"),
                    help="'fused': the chunked engine (CUDA graphs on the "
                         "card; growth and keyframes at chunk boundaries); "
                         "'object': the per-frame stepwise loop (per-frame "
                         "npy exports)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="frames per chunk (--engine fused)")
    ap.add_argument("--voxel_dim", type=int, default=128)
    ap.add_argument("--voxel_size", type=float, default=0.005)
    ap.add_argument("--node_coverage", type=float, default=0.05)
    ap.add_argument("--source_frame", type=int, default=0)
    ap.add_argument("--end_frame", type=int, default=0, help="0 = all")
    ap.add_argument("--skip_rate", type=int, default=1)
    ap.add_argument("--nicp_iters", type=int, default=100)
    ap.add_argument("--solver", default="nicp", choices=("nicp", "gn_dense"),
                    help="warp solver: Adam-on-SO(3) N-ICP or dense "
                         "Gauss-Newton")
    ap.add_argument("--gn_iters", type=int, default=4)
    ap.add_argument("--linear_solver", default="cholesky",
                    choices=("cholesky", "cg", "schur", "ns"),
                    help="linear solver inside gn_dense")
    ap.add_argument("--gn_data_term", default="point3d",
                    choices=("point3d", "2d_depth"),
                    help="gn_dense data residual: isotropic 3D point-to-"
                         "point, or the reference's x-pixel/y-pixel/depth "
                         "stack")
    ap.add_argument("--gn_w_flow", type=float, default=1e-3,
                    help="pixel-row weight of the 2d_depth term")
    ap.add_argument("--gn_w_depth", type=float, default=1.0,
                    help="depth-row weight of the 2d_depth term")
    ap.add_argument("--min_cluster_matches", type=float, default=0.0,
                    help="freeze graph components whose summed match "
                         "weight drops below this; 0 = off")
    ap.add_argument("--max_nodes", type=int, default=512)
    ap.add_argument("--max_points", type=int, default=8192)
    ap.add_argument("--growth_interval", type=int, default=0)
    ap.add_argument("--no_motion_model", action="store_true")
    ap.add_argument("--export_mesh_every", type=int, default=0)
    ap.add_argument("--lepard_weights", default=None,
                    help="matcher checkpoint (train_lepard output); "
                         "enables learned scene flow in the loop")
    ap.add_argument("--lepard_every", type=int, default=1,
                    help="run the matcher every K-th frame")
    ap.add_argument("--lepard_coherence", type=float, default=None,
                    help="enable the motion-coherence match filter with "
                         "this tau (canonical units)")
    ap.add_argument("--lepard_coherence_mad", type=float, default=None,
                    help="MAD multiplier for the coherence allowance "
                         "(tau + mad*MAD); 0 = absolute tau")
    ap.add_argument("--flow_lift", default="dense",
                    choices=("dense", "sparse"),
                    help="flow lift: dense [H,W] fields or sparse at the "
                         "model projections (fused engine)")
    ap.add_argument("--flow_mode", default="fill",
                    choices=("fill", "override", "advect"))
    ap.add_argument("--flow_advect_min_px", type=float, default=0.0)
    ap.add_argument("--flow_advect_alpha", type=float, default=1.0)
    ap.add_argument("--flow_advect_weight", type=float, default=1.0)
    ap.add_argument("--flow_advect_mask", type=float, default=None)
    ap.add_argument("--flow_downscale", type=int, default=1)
    ap.add_argument("--flow_weights", default=None,
                    help="PWC-Net(+MaskNet) checkpoint (train_flow "
                         "output); enables the optical-flow "
                         "correspondence source")
    ap.add_argument("--keyframe_interval", type=int, default=0,
                    help="pose-graph keyframe every N frames; 0 = off")
    ap.add_argument("--recovery", action="store_true",
                    help="enable wide-baseline track-loss recovery")
    ap.add_argument("--loop_radius", type=float, default=0.3,
                    help="loop-closure search radius between keyframe "
                         "poses (m)")
    ap.add_argument("--save_state", default=None,
                    help="write a resumable state snapshot here at the end")
    ap.add_argument("--resume_state", default=None,
                    help="resume from a --save_state snapshot instead of "
                         "initializing from the source frame")
    ap.add_argument("--brick_size", type=int, default=-1,
                    help="sparse bricked TSDF: brick edge in voxels; 0 = "
                         "dense grid; -1 (default) = auto (bricked at >= "
                         "128^3 voxels, dense below)")
    ap.add_argument("--max_bricks", type=int, default=2048)
    ap.add_argument("--max_depth", type=float, default=0.0,
                    help="zero depth beyond this cutoff (m); 0 = off")
    ap.add_argument("--depth_filter_size", type=int, default=0,
                    help="median depth filter window; 0 = off")
    ap.add_argument("--boundary_dist", type=float, default=0.0,
                    help="exclude correspondences at depth discontinuities "
                         "larger than this (m); 0 = off")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def load_nets(args, dev):
    """(motion net or None, flow net, mask net, Lepard net) for the flags."""
    from occlusionfusion_tpu_torch.models import checkpoint as ck

    motion_net = None
    if not args.no_motion_model:
        try:
            motion_net = ck.load_motion_complete_net(device=dev)
        except FileNotFoundError:
            print("no motion-completion weights; running without")
    lepard_net = None
    if args.lepard_weights:
        with open(args.lepard_weights + ".json") as fh:
            cfg = ck.lepard_config_from_json(json.load(fh))
        if args.lepard_coherence is not None:
            cfg = cfg._replace(coherence_tau=args.lepard_coherence)
        if args.lepard_coherence_mad is not None:
            cfg = cfg._replace(coherence_mad=args.lepard_coherence_mad)
        lepard_net, _ = ck.load_lepard_checkpoint(args.lepard_weights,
                                                  device=dev, config=cfg)
    flow_net = mask_net = None
    if args.flow_weights:
        flow_net, mask_net = ck.load_flow_nets(args.flow_weights, device=dev)
    return motion_net, flow_net, mask_net, lepard_net


def fusion_config(args, use_motion: bool, use_flow: bool, use_lepard: bool):
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
    from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig

    gn = {}
    if args.solver == "gn_dense":
        gn["gn"] = GNConfig(
            iters=args.gn_iters, w_point=1.0, w_arap=2.0,
            w_motion=1.0 if use_motion else 0.0,
            linear_solver=args.linear_solver, data_term=args.gn_data_term,
            w_flow=args.gn_w_flow, w_depth=args.gn_w_depth,
        )
    return FusionConfig(
        vol_dim=(args.voxel_dim,) * 3,
        voxel_size=args.voxel_size,
        node_coverage=args.node_coverage,
        max_nodes=args.max_nodes,
        max_points=args.max_points,
        graph=GraphConfig(node_coverage=args.node_coverage),
        nicp=NICPConfig(iters=args.nicp_iters),
        solver=args.solver,
        use_motion_model=use_motion,
        growth_interval=args.growth_interval,
        keyframe_interval=args.keyframe_interval,
        relocalize_recovery=args.recovery,
        loop_radius=args.loop_radius,
        use_lepard=use_lepard,
        lepard_every=args.lepard_every,
        use_flow=use_flow,
        flow_lift=args.flow_lift,
        flow_mode=args.flow_mode,
        flow_advect_min_px=args.flow_advect_min_px,
        flow_advect_alpha=args.flow_advect_alpha,
        flow_advect_weight=args.flow_advect_weight,
        flow_advect_mask_threshold=args.flow_advect_mask,
        flow_downscale=args.flow_downscale,
        brick_size=args.brick_size,
        max_bricks=args.max_bricks,
        min_cluster_matches=args.min_cluster_matches,
        **gn,
    )


def _deformed_nodes(fusion) -> np.ndarray:
    return fusion.warp.deformed_nodes.cpu().numpy()[: fusion.node_count]


def _finish(fusion, args, infos) -> None:
    """convergence.json, trajectory.npz, final_mesh.ply, --save_state."""
    from occlusionfusion_tpu_torch.utils.viz import save_ply

    with open(os.path.join(args.results, "convergence.json"), "w") as fh:
        json.dump(infos, fh, indent=1)
    if args.keyframe_interval:
        ids, R, t = fusion.trajectory()
        np.savez(os.path.join(args.results, "trajectory.npz"),
                 frame_ids=ids, rotations=R, translations=t)
    verts, faces = fusion.get_deformed_mesh()
    save_ply(os.path.join(args.results, "final_mesh.ply"), verts, faces)
    if args.save_state:
        fusion.save_state(args.save_state)
        print(f"state snapshot -> {args.save_state}")
    print(f"done; results in {args.results}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    from occlusionfusion_tpu_torch.device import require_device
    from occlusionfusion_tpu_torch.fusion.frame_loader import RGBDSequence
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.utils.viz import save_ply

    dev = require_device(args.device)
    motion_net, flow_net, mask_net, lepard_net = load_nets(args, dev)
    config = fusion_config(args, motion_net is not None,
                           flow_net is not None, lepard_net is not None)
    seq = RGBDSequence(args.datadir, max_depth=args.max_depth,
                       depth_filter_size=args.depth_filter_size,
                       boundary_dist=args.boundary_dist)
    fusion = DynamicFusion(seq, config, device=dev, flow_net=flow_net,
                           mask_net=mask_net, lepard_net=lepard_net)

    os.makedirs(args.results, exist_ok=True)
    end = args.end_frame or len(seq)
    t0 = time.perf_counter()
    if args.engine == "fused" and not args.resume_state:
        infos = fusion.run_fused(start=args.source_frame, end=end,
                                 skip=args.skip_rate, chunk=args.chunk,
                                 motion_net=motion_net)
        dt = time.perf_counter() - t0
        for info in infos:
            print(f"frame {info['frame']}: {info}")
        n_valid = sum(1 for i in infos if i.get("solve_valid", True))
        print(f"{len(infos)} frames in {dt:.1f}s "
              f"({len(infos) / max(dt, 1e-9):.2f} fps incl. capture); "
              f"valid solves {n_valid}/{len(infos)}")
        np.save(os.path.join(args.results, "deformed_nodes_final.npy"),
                _deformed_nodes(fusion))
        _finish(fusion, args, infos)
        return
    if args.engine == "fused":
        print("--resume_state drives the object engine (resumable "
              "per-frame loop)")
    if args.resume_state:
        fusion.load_state(args.resume_state)
        start = fusion.frame_id + args.skip_rate
        print(f"resumed at frame {fusion.frame_id}: {fusion.node_count} "
              f"nodes ({time.perf_counter() - t0:.1f}s)")
    else:
        fusion.initialize(seq.load(args.source_frame))
        start = args.source_frame + args.skip_rate
        print(f"initialized: {fusion.node_count} nodes "
              f"({time.perf_counter() - t0:.1f}s)")

    infos = []
    for i in range(start, end, args.skip_rate):
        t0 = time.perf_counter()
        info = fusion.register_frame(seq.load(i), motion_net)
        info["frame"] = i
        info["seconds"] = round(time.perf_counter() - t0, 3)
        infos.append(info)
        print(f"frame {i}: {info}")
        np.save(os.path.join(args.results, f"deformed_nodes_{i:06d}.npy"),
                _deformed_nodes(fusion))
        if args.export_mesh_every and i % args.export_mesh_every == 0:
            verts, faces = fusion.get_deformed_mesh()
            save_ply(os.path.join(args.results, f"mesh_{i:06d}.ply"), verts,
                     faces)
    _finish(fusion, args, infos)


if __name__ == "__main__":
    main()
