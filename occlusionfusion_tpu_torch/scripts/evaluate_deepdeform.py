"""DeepDeform-format evaluation: the port of
``scripts/evaluate_deepdeform.py``, with its flags and defaults; the JAX
script's ``--tpu`` is ``--device`` here (the card unless ``cpu``).

  python -m occlusionfusion_tpu_torch.scripts.export_deepdeform --out dd
  python -m occlusionfusion_tpu_torch.scripts.evaluate_deepdeform \
      --root dd --gt_flow [--device cpu]
  python -m occlusionfusion_tpu_torch.scripts.evaluate_deepdeform \
      --root dd --flow_weights checkpoints/flow.npz

For every sample of a DeepDeform-layout split: the flow net's flow (or
the ground-truth optical flow with ``--gt_flow``) lifted to 3-D targets,
``--matches`` match pixels drawn as the JAX script draws them, and a
dense Gauss-Newton solve over the sample's deformation graph (kernels
K3'/K4' on the card). Prints the JAX script's JSON: ``graph_mm`` (node
translation error against the ground-truth node deformations),
``epe3d_mm`` (warped-point error against the scene flow),
``valid_solve_ratio`` and, with a flow net, ``epe2d_px``. On synthetic
exports these numbers check the machinery; they do not compare with the
published real-data bounds.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--flow_weights", default=None,
                    help="PWC(+MaskNet) checkpoint to evaluate")
    ap.add_argument("--gt_flow", action="store_true",
                    help="the ground-truth optical flow as the "
                         "correspondence source (measures the solve only)")
    ap.add_argument("--matches", type=int, default=2048,
                    help="static cap of match pixels fed to the solver")
    ap.add_argument("--gn_iters", type=int, default=4)
    ap.add_argument("--max_samples", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def match_pixels(ok: np.ndarray, M: int):
    """The JAX script's draw: M of the flat indices where ``ok`` holds
    (RandomState(0) without replacement), or all of them padded with the
    last; returns (pick [M], valid [M])."""
    flat = np.flatnonzero(ok.reshape(-1))
    pick = (np.random.RandomState(0).choice(flat, M, replace=False)
            if flat.size > M else np.pad(flat, (0, M - flat.size),
                                         mode="edge"))
    match_valid = np.zeros(M, bool)
    match_valid[: min(flat.size, M)] = True
    return pick, match_valid


def evaluate(args, dev):
    """-> (the JSON's metrics, per-sample lists: graph_mm, epe3d_mm,
    epe2d_px, valid, n_ok (candidate match pixels))."""
    from occlusionfusion_tpu_torch.data.deepdeform import (
        DeepDeformConfig,
        DeepDeformDataset,
    )
    from occlusionfusion_tpu_torch.fusion.flow_correspondence import (
        flow_correspondences,
    )
    from occlusionfusion_tpu_torch.geometry.camera import bilinear_sample
    from occlusionfusion_tpu_torch.solvers.gauss_newton import (
        GNConfig,
        GNProblem,
    )
    from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
        solve_dense,
    )

    ds = DeepDeformDataset(
        args.root, args.split,
        DeepDeformConfig(image_height=args.height, image_width=args.width))
    pwc = mask_net = None
    if args.flow_weights:
        from occlusionfusion_tpu_torch.models.checkpoint import (
            load_flow_nets,
        )

        pwc, mask_net = load_flow_nets(args.flow_weights, device=dev)
    gn = GNConfig(iters=args.gn_iters, w_arap=1.0)
    H, W, M = args.height, args.width, args.matches

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    per = {k: [] for k in ("graph_mm", "epe3d_mm", "epe2d_px", "valid",
                           "n_ok")}
    n = len(ds) if not args.max_samples else min(len(ds), args.max_samples)
    for idx in range(n):
        s = ds[idx]
        src, tgt = t(s["source"]), t(s["target"])
        oflow_gt = s["optical_flow"].transpose(1, 2, 0)  # [H, W, 2]
        gt_valid = np.isfinite(oflow_gt).all(-1) & (s["source"][5] > 0)
        with torch.no_grad():
            if args.gt_flow:
                flow = np.where(gt_valid[..., None], oflow_gt, 0.0)
                v, u = np.mgrid[0:H, 0:W].astype(np.float32)
                uv = t(np.stack([u + flow[..., 0], v + flow[..., 1]], -1)
                       .astype(np.float32))
                lifted = bilinear_sample(tgt[3:].permute(1, 2, 0),
                                         uv.reshape(-1, 2)).reshape(H, W, 3)
                valid = t(gt_valid) & (lifted[..., 2] > 0)
                weights = valid.to(torch.float32)
            else:
                flow_t, lifted, valid, weights = flow_correspondences(
                    pwc, src, tgt, mask_net)
                e = np.linalg.norm(flow_t.cpu().numpy() - oflow_gt,
                                   axis=-1)[gt_valid]
                if e.size:
                    per["epe2d_px"].append(float(e.mean()))
        anchors = s["pixel_anchors"].transpose(1, 2, 0)  # [H, W, 4]
        aweights = s["pixel_weights"].transpose(1, 2, 0)
        ok = ((anchors[..., 0] >= 0) & (s["source"][5] > 0)
              & valid.cpu().numpy())
        pick, match_valid = match_pixels(ok, M)
        per["n_ok"].append(int(ok.sum()))
        src_xyz = s["source"][3:].transpose(1, 2, 0).reshape(-1, 3)
        nodes = t(s["graph_nodes"])
        node_valid = t(s["graph_mask"])
        pk = t(pick)
        problem = GNProblem(
            source_points=t(src_xyz[pick]),
            point_anchors=t(anchors.reshape(-1, 4)[pick].astype(np.int32)),
            point_weights=t(aweights.reshape(-1, 4)[pick]),
            target_points=lifted.reshape(-1, 3)[pk],
            point_valid=weights.reshape(-1)[pk] * t(match_valid),
            nodes=nodes,
            node_valid=node_valid,
            edges=t(s["graph_edges"]),
            edge_weights=t(s["graph_edges_weights"]),
            motion_targets=torch.zeros_like(nodes),
            motion_confidence=torch.zeros(nodes.shape[0], device=dev),
            solve_node_mask=node_valid,
            intrinsics=tuple(float(np.float32(s["intrinsics"][k]))
                             for k in ("fx", "fy", "cx", "cy")),
        )
        eye = torch.eye(3, device=dev).expand(nodes.shape[0], 3, 3)
        with torch.no_grad():
            result = solve_dense(problem, gn, eye.contiguous(),
                                 torch.zeros_like(nodes))
        per["valid"].append(bool(result.valid))
        nv = s["graph_mask"]
        ge = np.linalg.norm(result.translations.cpu().numpy()[nv]
                            - s["graph_node_deformations"][nv], axis=-1)
        per["graph_mm"].append(float(ge.mean() * 1000.0))
        sflow = s["scene_flow"].transpose(1, 2, 0).reshape(-1, 3)[pick]
        fin = np.isfinite(sflow).all(-1) & match_valid
        we = np.linalg.norm(result.warped_points.cpu().numpy()
                            - (src_xyz[pick] + sflow), axis=-1)[fin]
        if we.size:
            per["epe3d_mm"].append(float(we.mean() * 1000.0))
    if not per["graph_mm"] or not per["epe3d_mm"]:
        raise SystemExit(
            f"no finite samples to aggregate (graph_mm "
            f"n={len(per['graph_mm'])}, epe3d_mm n={len(per['epe3d_mm'])})"
            " -- empty split or max_samples=0?")
    metrics = {
        "samples": n,
        "graph_mm": round(float(np.mean(per["graph_mm"])), 3),
        "epe3d_mm": round(float(np.mean(per["epe3d_mm"])), 3),
        "valid_solve_ratio": round(float(np.mean(per["valid"])), 4),
    }
    if per["epe2d_px"]:
        metrics["epe2d_px"] = round(float(np.mean(per["epe2d_px"])), 3)
    return metrics, per


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if not (args.flow_weights or args.gt_flow):
        ap.error("pass --flow_weights or --gt_flow")
    from occlusionfusion_tpu_torch.device import require_device

    metrics, per = evaluate(args, require_device(args.device))
    print(json.dumps(metrics))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(metrics, fh)
    return metrics, per


if __name__ == "__main__":
    main()
