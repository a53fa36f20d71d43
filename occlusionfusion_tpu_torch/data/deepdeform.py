"""DeepDeform-format dataset for neural-tracking training/eval (port of
``occlusionfusion_tpu/data/deepdeform.py``; numpy on the host).

Equivalent of the reference ``DeformDataset`` (``model/dataset.py``):
samples are (source RGB-D, target RGB-D, optical/scene flow GT, embedded
graph blobs, pixel anchors/weights), read from the DeepDeform directory
layout and padded to static shapes for batching (the reference
zero-pads in its collate, ``dataset.py:305-356``). PNG images are decoded
by the port's own reader (``fusion/frame_loader.read_png``); other image
files (DeepDeform's jpg colour) through Pillow, imported where it is
needed.

Image pipeline mirror: load color (jpg) + depth (16-bit png, mm) ->
crop/resize to (height, width) -> backproject to an XYZ image with the
cropped intrinsics -> 6-channel RGB+XYZ tensor (``dataset.py:151-213``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from occlusionfusion_tpu_torch.data import formats


@dataclass
class DeepDeformConfig:
    image_height: int = 448
    image_width: int = 640
    max_boundary_dist: float = 0.10
    depth_scale: float = 1000.0
    max_nodes: int = 1024
    graph_k: int = 8


def _read_image(path: str, rgb: bool = False) -> np.ndarray:
    """An image file as an array: PNG by the port's decoder, anything
    else by Pillow; ``rgb`` gives [H, W, 3] (grey expanded, alpha
    dropped, as Pillow's ``convert("RGB")``)."""
    if path.lower().endswith(".png"):
        from occlusionfusion_tpu_torch.fusion.frame_loader import read_png

        img = read_png(path)
        if rgb:
            img = img[..., :3] if img.ndim == 3 else np.repeat(
                img[..., None], 3, -1)
        return img
    from PIL import Image

    im = Image.open(path)
    return np.asarray(im.convert("RGB") if rgb else im)


def load_image_pair(
    color_path: str, depth_path: str, intrinsics: dict,
    config: DeepDeformConfig,
):
    """-> (rgbxyz [6, H, W], cropped intrinsics dict)."""
    color = _read_image(color_path, rgb=True).astype(np.float32)
    depth = _read_image(depth_path).astype(np.float32) / config.depth_scale
    H, W = config.image_height, config.image_width
    h0, w0 = depth.shape
    # center crop to target aspect then resize is overkill for DeepDeform
    # (640x480 -> 640x448): the reference center-crops rows only
    top = max((h0 - H) // 2, 0)
    left = max((w0 - W) // 2, 0)
    color = color[top : top + H, left : left + W]
    depth = depth[top : top + H, left : left + W]
    fx, fy = intrinsics["fx"], intrinsics["fy"]
    cx, cy = intrinsics["cx"] - left, intrinsics["cy"] - top
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    rgbxyz = np.concatenate(
        [color.transpose(2, 0, 1) / 255.0, np.stack([x, y, depth])], 0
    ).astype(np.float32)
    return rgbxyz, {"fx": fx, "fy": fy, "cx": cx, "cy": cy}


class DeepDeformDataset:
    """Iterates (source, target, flow GT, graph) samples from a
    DeepDeform-style root with a split json listing sample dicts."""

    def __init__(self, root: str, split: str, config: DeepDeformConfig | None = None):
        self.root = root
        self.config = config or DeepDeformConfig()
        with open(os.path.join(root, f"{split}.json")) as fh:
            self.samples = json.load(fh)

    def __len__(self):
        return len(self.samples)

    def _abs(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def __getitem__(self, idx: int):
        s = self.samples[idx]
        cfg = self.config
        intr = np.loadtxt(self._abs(s["intrinsics"]))
        intrinsics = {
            "fx": intr[0, 0], "fy": intr[1, 1], "cx": intr[0, 2], "cy": intr[1, 2]
        }
        source, intr_c = load_image_pair(
            self._abs(s["source_color"]), self._abs(s["source_depth"]),
            intrinsics, cfg,
        )
        target, _ = load_image_pair(
            self._abs(s["target_color"]), self._abs(s["target_depth"]),
            intrinsics, cfg,
        )
        out = {
            "source": source,
            "target": target,
            "intrinsics": intr_c,
        }
        if "optical_flow" in s:
            out["optical_flow"] = formats.load_flow(self._abs(s["optical_flow"]))
        if "scene_flow" in s:
            out["scene_flow"] = formats.load_flow(self._abs(s["scene_flow"]))
        if "graph_nodes" in s:
            nodes = formats.load_graph_nodes(self._abs(s["graph_nodes"]))
            edges = formats.load_graph_edges(self._abs(s["graph_edges"]))
            weights = formats.load_graph_edges_weights(
                self._abs(s["graph_edges_weights"])
            )
            n, cap = nodes.shape[0], cfg.max_nodes
            nodes_p = np.zeros((cap, 3), np.float32)
            nodes_p[:n] = nodes
            edges_p = -np.ones((cap, cfg.graph_k), np.int32)
            edges_p[:n, : edges.shape[1]] = edges
            w_p = np.zeros((cap, cfg.graph_k), np.float32)
            w_p[:n, : weights.shape[1]] = weights
            mask = np.zeros(cap, bool)
            mask[:n] = True
            out.update(
                graph_nodes=nodes_p, graph_edges=edges_p,
                graph_edges_weights=w_p, graph_mask=mask,
            )
            if "graph_clusters" in s:
                cl = formats.load_graph_clusters(
                    self._abs(s["graph_clusters"])
                ).reshape(-1)
                cl_p = -np.ones(cap, np.int32)
                cl_p[:n] = cl
                out["graph_clusters"] = cl_p
            if "graph_node_deformations" in s:
                gd = formats.load_graph_nodes(
                    self._abs(s["graph_node_deformations"])
                )
                gd_p = np.zeros((cap, 3), np.float32)
                gd_p[:n] = gd
                out["graph_node_deformations"] = gd_p
        if "pixel_anchors" in s:
            out["pixel_anchors"] = formats.load_int_image(
                self._abs(s["pixel_anchors"])
            )
            out["pixel_weights"] = formats.load_float_image(
                self._abs(s["pixel_weights"])
            )
        return out
