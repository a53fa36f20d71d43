"""Export a synthetic clip to the DeepDeform/NeuralTracking data layout:
the port of ``scripts/export_deepdeform.py``, with its flags and
defaults, plus ``--device`` (the card unless ``cpu``).

  python -m occlusionfusion_tpu_torch.scripts.export_deepdeform \
      --out dd --shape arms [--frames 8 --height 160 --width 160] \
      [--device cpu]

Per frame a colour image, a 16-bit depth PNG in millimetres and the
intrinsics; per consecutive pair the optical flow (.oflow), the scene
flow (.sflow, -inf where invalid), the deformation graph over the source
frame (nodes, edges, weights, clusters and the ground-truth node
deformations) and the pixel anchors and weights, listed in
``<split>.json``: what ``data/deepdeform.DeepDeformDataset``, the flow
trainer and ``evaluate_deepdeform`` read. The ground truth comes from
the clip's known vertex correspondences through the point-splat camera.
The pixel anchors are skinned on ``--device`` (kernel K1 on the card);
everything else is host code.

One deviation from the JAX script: colour is written as
``color/NNNNNN.png`` by ``fusion.frame_loader.write_png``, where the JAX
script writes JPEG (quality 95) through Pillow. The card's machine has
no Pillow, and PNG keeps the rendered colour exactly.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--shape", default="arms",
                    choices=("blob", "limbs", "arms"))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--fx", type=float, default=300.0)
    ap.add_argument("--verts", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rotate_deg", type=float, default=0.0)
    ap.add_argument("--splat_radius", type=int, default=2)
    ap.add_argument("--node_coverage", type=float, default=0.05)
    ap.add_argument("--split", default="train")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def _node_pixels(nodes, intr, H, W):
    """Each node's pixel (row, column), rounded and clipped."""
    z = np.maximum(nodes[:, 2], 1e-6)
    ny = np.round(nodes[:, 1] / z * float(intr.fy) + float(intr.cy))
    nx = np.round(nodes[:, 0] / z * float(intr.fx) + float(intr.cx))
    return (np.clip(ny.astype(int), 0, H - 1),
            np.clip(nx.astype(int), 0, W - 1))


def clip_frames(args):
    """(intrinsics, per frame: camera-frame vertices ``v``, rendered
    ``depth``, colour, ``mask`` and winning vertex ``win``) of the clip
    the export renders."""
    from occlusionfusion_tpu_torch.data.deformingthings4d import (
        frame_vertices,
        procedural_vertex_colors,
    )
    from occlusionfusion_tpu_torch.data.synthetic_shapes import (
        np_render,
        shape_clip,
    )
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    H, W = args.height, args.width
    intr = Intrinsics(*(float(np.float32(x)) for x in (
        args.fx, args.fx, W / 2, H / 2)))
    verts, _, offs = shape_clip(args.shape, args.frames, args.verts,
                                seed=args.seed, rotate_deg=args.rotate_deg)
    colors = procedural_vertex_colors(verts, seed=args.seed)
    center = verts.mean(0)
    cam = np.asarray([0.0, 0.0, 1.5], np.float32)
    frames = []
    for f in range(args.frames):
        v = frame_vertices(verts, offs, f) - center + cam
        depth, color, mask, win = np_render(v, colors, intr, (H, W),
                                            splat_radius=args.splat_radius)
        frames.append(dict(v=v, depth=depth, color=color, mask=mask,
                           win=win))
    return intr, frames


def export(args, dev):
    from occlusionfusion_tpu_torch.data import formats
    from occlusionfusion_tpu_torch.data.synthetic_shapes import (
        _backproject,
        _project,
    )
    from occlusionfusion_tpu_torch.fusion.frame_loader import write_png
    from occlusionfusion_tpu_torch.graph.edgraph import (
        GraphConfig,
        build_graph_from_depth,
    )
    from occlusionfusion_tpu_torch.graph.pixel_anchors import (
        pixel_anchors_euclidean,
    )

    H, W = args.height, args.width
    intr, frames = clip_frames(args)
    seq = os.path.join("seqs", args.shape)
    for sub in ("color", "depth", "flow", "graph"):
        os.makedirs(os.path.join(args.out, seq, sub), exist_ok=True)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = args.fx
    K[0, 2], K[1, 2] = W / 2, H / 2
    intr_rel = os.path.join(seq, "intrinsics.txt")
    np.savetxt(os.path.join(args.out, intr_rel), K)
    for f, fr in enumerate(frames):
        fr["color_rel"] = os.path.join(seq, "color", f"{f:06d}.png")
        fr["depth_rel"] = os.path.join(seq, "depth", f"{f:06d}.png")
        write_png(os.path.join(args.out, fr["color_rel"]),
                  fr["color"].astype(np.uint8))
        write_png(os.path.join(args.out, fr["depth_rel"]),
                  np.round(fr["depth"] * 1000.0).astype(np.uint16))

    samples = []
    gcfg = GraphConfig(node_coverage=args.node_coverage,
                       max_triangle_edge=0.05)
    for i in range(args.frames - 1):
        j = i + 1
        src, tgt = frames[i], frames[j]
        P = len(src["v"])
        valid = src["mask"] & (src["win"] < P)
        tgt_pts = tgt["v"][np.minimum(src["win"], P - 1)]  # [H, W, 3]
        src_pts = _backproject(src["depth"], intr)
        uj, vj = _project(tgt_pts, intr)
        vv, uu = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing="ij")
        # -inf marks invalid flow, as the reference's dataset loads holes
        oflow = np.where(valid[None], np.stack([uj - uu, vj - vv], 0),
                         -np.inf).astype(np.float32)
        sflow = np.where(valid[None], (tgt_pts - src_pts).transpose(2, 0, 1),
                         -np.inf).astype(np.float32)
        frel = os.path.join(seq, "flow", f"{i:06d}_{j:06d}")
        formats.save_flow(os.path.join(args.out, frel + ".oflow"), oflow)
        formats.save_flow(os.path.join(args.out, frel + ".sflow"), sflow)

        g = build_graph_from_depth(src_pts.astype(np.float32), gcfg)
        grel = os.path.join(seq, "graph", f"{i:06d}_{j:06d}")

        def blob(name):
            return os.path.join(args.out, grel + name)

        formats.save_graph_nodes(blob("_nodes.bin"), g.nodes)
        formats.save_graph_edges(blob("_edges.bin"), g.edges)
        formats.save_graph_edges_weights(blob("_weights.bin"),
                                         g.edge_weights)
        formats.save_graph_clusters(blob("_clusters.bin"),
                                    g.clusters.reshape(-1, 1))
        # nodes sit on backprojected source pixels: each moves by the
        # scene flow of its pixel's winning vertex
        ny, nx = _node_pixels(g.nodes, intr, H, W)
        node_delta = (tgt_pts - src_pts)[ny, nx] * valid[ny, nx][:, None]
        formats.save_graph_nodes(blob("_deform.bin"),
                                 node_delta.astype(np.float32))
        anchors, weights = pixel_anchors_euclidean(
            src_pts.astype(np.float32), g.nodes, None, args.node_coverage,
            device=dev)
        formats.save_int_image(blob("_anchors.bin"),
                               anchors.transpose(2, 0, 1).astype(np.int32))
        formats.save_float_image(
            blob("_anchor_weights.bin"),
            weights.transpose(2, 0, 1).astype(np.float32))
        samples.append({
            "seq": args.shape,
            "source_id": i,
            "target_id": j,
            "intrinsics": intr_rel,
            "source_color": src["color_rel"],
            "source_depth": src["depth_rel"],
            "target_color": tgt["color_rel"],
            "target_depth": tgt["depth_rel"],
            "optical_flow": frel + ".oflow",
            "scene_flow": frel + ".sflow",
            "graph_nodes": grel + "_nodes.bin",
            "graph_edges": grel + "_edges.bin",
            "graph_edges_weights": grel + "_weights.bin",
            "graph_clusters": grel + "_clusters.bin",
            "graph_node_deformations": grel + "_deform.bin",
            "pixel_anchors": grel + "_anchors.bin",
            "pixel_weights": grel + "_anchor_weights.bin",
        })
    with open(os.path.join(args.out, f"{args.split}.json"), "w") as fh:
        json.dump(samples, fh, indent=1)
    print(f"exported {len(samples)} samples to {args.out}")
    return samples


def main(argv=None):
    args = build_parser().parse_args(argv)
    from occlusionfusion_tpu_torch.device import require_device

    return export(args, require_device(args.device))


if __name__ == "__main__":
    main()
