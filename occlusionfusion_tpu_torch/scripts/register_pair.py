"""Non-rigid registration of one source/target pair: the port of
``scripts/register_pair.py``, with its flags and defaults, plus
``--device`` (the card unless ``cpu``).

  python -m occlusionfusion_tpu_torch.scripts.register_pair \
      --source s.ply --target t.ply --out warped.ply \
      [--solver gn_dense] [--device cpu]

An embedded-deformation graph is sampled over the source (greedy
coverage), the source skinned to it (kernel K1 on the card), its edges
geodesic over the source's faces or, for a point cloud, the 8 nearest
nodes (``knn_torch``, the JAX script's ``knn_lax``); landmarks are the
Lepard matcher's matches with ``--lepard_weights``, else each source
point's nearest target within 4 node coverages. N-ICP (ARAP + landmark
[+ chamfer]) or, with ``--solver gn_dense``, 8 dense Gauss-Newton
iterations (K3'/K4' on the card) solve the warp; the warped source is
written as PLY. Inputs are PLY (``utils/viz.load_ply``) or npz with a
``points`` array.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def load_points(path: str):
    if path.endswith(".npz"):
        return np.load(path)["points"].astype(np.float32), None
    from occlusionfusion_tpu_torch.utils.viz import load_ply

    return load_ply(path)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--out", default="warped.ply")
    ap.add_argument("--node_coverage", type=float, default=0.05)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.06)
    ap.add_argument("--w_arap", type=float, default=10.0)
    ap.add_argument("--w_ldmk", type=float, default=1.0)
    ap.add_argument("--w_chamfer", type=float, default=0.0)
    ap.add_argument("--solver", choices=["nicp", "gn_dense"], default="nicp")
    ap.add_argument("--max_nodes", type=int, default=1024)
    ap.add_argument("--lepard_weights", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def lepard_landmarks(path: str, src: torch.Tensor, tgt: torch.Tensor,
                     cap: int = 8192):
    """(landmark_src, landmark_tgt, landmark_valid, target points) from the
    matcher at its default config with the weights at ``path``: each
    matched coarse source point's nearest source vertex, and its matched
    coarse target point."""
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_lepard_checkpoint,
    )
    from occlusionfusion_tpu_torch.models.lepard import (
        LepardConfig,
        lepard_match,
    )
    from occlusionfusion_tpu_torch.ops.knn import knn_torch

    dev = src.device
    net, _ = load_lepard_checkpoint(path, device=dev, config=LepardConfig())

    def padded(p):
        out = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
        out[: min(len(p), cap)] = p[:cap]
        return out, torch.arange(cap, device=dev) < len(p)

    (sp, sm), (tp, tm) = padded(src), padded(tgt)
    with torch.no_grad():
        m = lepard_match(net, sp, sm, tp, tm)
    _, src_vert = knn_torch(m.src_points, src, k=1)
    targets = m.tgt_points[m.match_tgt.long()]
    return (src_vert[:, 0], torch.arange(targets.shape[0], device=dev),
            m.match_valid, targets)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from occlusionfusion_tpu_torch.device import require_device
    from occlusionfusion_tpu_torch.geometry.skinning import skinning_weights
    from occlusionfusion_tpu_torch.graph import native
    from occlusionfusion_tpu_torch.ops.knn import knn_torch
    from occlusionfusion_tpu_torch.solvers.nicp import (
        NICPConfig,
        NICPProblem,
        solve,
    )
    from occlusionfusion_tpu_torch.utils.viz import save_ply

    dev = require_device(args.device)
    src_np, src_faces = load_points(args.source)
    tgt_np, _ = load_points(args.target)
    print(f"source {src_np.shape}, target {tgt_np.shape}")

    node_ids = native.sample_nodes(src_np, None, args.node_coverage,
                                   max_nodes=args.max_nodes)
    n = len(node_ids)
    print(f"{n} graph nodes")
    src = torch.from_numpy(np.ascontiguousarray(src_np)).to(dev)
    tgt = torch.from_numpy(np.ascontiguousarray(tgt_np)).to(dev)
    nodes = src[torch.from_numpy(node_ids).long().to(dev)]
    anchors, weights, valid = skinning_weights(src, nodes, None,
                                               args.node_coverage, k=4)
    if src_faces is not None and len(src_faces):
        edges, dists = native.geodesic_edges(src_np, src_faces, node_ids, k=8)
        w = np.exp(-np.square(dists) / (2 * args.node_coverage**2))
        w[edges < 0] = 0
        s = w.sum(1, keepdims=True)
        ew = np.where(s > 0, w / np.maximum(s, 1e-12), 0).astype(np.float32)
        edges_t = torch.from_numpy(edges).to(dev)
        ew_t = torch.from_numpy(ew).to(dev)
    else:
        d2, idx = knn_torch(nodes, nodes, k=9)
        edges_t = idx[:, 1:].contiguous()
        w = torch.exp(-d2[:, 1:] / (2 * args.node_coverage**2))
        ew_t = w / torch.sum(w, dim=1, keepdim=True)

    if args.lepard_weights:
        ldmk_src, ldmk_tgt, ldmk_valid, target_points = lepard_landmarks(
            args.lepard_weights, src, tgt)
    else:
        d2, idx = knn_torch(src, tgt, k=1)
        ldmk_src = torch.arange(src.shape[0], device=dev)
        ldmk_tgt = idx[:, 0]
        ldmk_valid = d2[:, 0] < (4 * args.node_coverage) ** 2
        target_points = tgt

    zeros = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    node_valid = torch.ones(n, dtype=torch.bool, device=dev)
    problem = NICPProblem(
        source_points=src, point_anchors=anchors, point_weights=weights,
        point_valid=valid, nodes=nodes, node_valid=node_valid,
        edges=edges_t, edge_weights=ew_t, target_points=target_points,
        landmark_src=ldmk_src, landmark_tgt=ldmk_tgt,
        landmark_valid=ldmk_valid, motion_targets=zeros,
        motion_confidence=torch.zeros(n, dtype=torch.float32, device=dev),
    )
    if args.solver == "gn_dense":
        from occlusionfusion_tpu_torch.solvers.gauss_newton import (
            GNConfig,
            GNProblem,
        )
        from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
            solve_dense,
        )

        gn_problem = GNProblem(
            source_points=src, point_anchors=anchors, point_weights=weights,
            target_points=target_points[ldmk_tgt.long()].contiguous(),
            point_valid=ldmk_valid.to(torch.float32), nodes=nodes,
            node_valid=node_valid, edges=edges_t, edge_weights=ew_t,
            motion_targets=zeros, motion_confidence=problem.motion_confidence,
            solve_node_mask=node_valid,
        )
        eye = torch.eye(3, dtype=torch.float32, device=dev).expand(n, 3, 3)
        with torch.no_grad():
            res = solve_dense(gn_problem, GNConfig(iters=8, w_arap=args.w_arap),
                              eye.contiguous(), zeros)
        final = float(res.residual_history[-1])
    else:
        cfg = NICPConfig(iters=args.iters, lr=args.lr, w_arap=args.w_arap,
                         w_ldmk=args.w_ldmk, w_chamfer=args.w_chamfer,
                         w_motion=0.0)
        res = solve(problem, cfg)
        final = float(res.final_loss)
    print(f"final loss {final:.6f}")
    save_ply(args.out, res.warped_points.detach().cpu().numpy(), src_faces)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
