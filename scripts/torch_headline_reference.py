#!/usr/bin/env python3
"""The JAX package's result on the headline input of the PyTorch port's
chip_smoke.py (phase ``headline``): bench.py's ENVELOPE_ENV configuration
through ``DynamicFusion.run_fused(chunk=16)`` on bench.py's sequence (a
flat grey sphere, r = 0.10 m at 1 m, receding 4 mm per frame, 448x640,
f = 1472 px), initialize plus FRAMES frames. Prints the median node
translation, the node count and, per frame, the correspondences and the
Lepard matcher's matches (read through a host callback,
tests/torch_port_impl.jax_lepard_match_counts) as one JSON line;
chip_smoke.py records them as HEADLINE_REFERENCE_Z,
HEADLINE_REFERENCE_CORRESPONDENCES and HEADLINE_REFERENCE_LEPARD.

Differences from bench.py, each to compute what the port computes: the
Gauss-Newton assembly is "blocks" (the XLA twin of the point-term
kernel, whose Pallas version mishandles fractional correspondence
weights; ROADMAP F1) and the voxel warp is the gather LBS
(dense_skin_max_bytes=0), the semantics of the port's LBS kernel.

    JAX_PLATFORMS=cpu python scripts/torch_headline_reference.py [FRAMES]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from occlusionfusion_tpu.fusion.frame_loader import ArraySequence  # noqa: E402
from occlusionfusion_tpu.fusion.pipeline import (  # noqa: E402
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu.geometry.camera import Intrinsics  # noqa: E402
from occlusionfusion_tpu.graph.edgraph import GraphConfig  # noqa: E402
from occlusionfusion_tpu.models.checkpoint import (  # noqa: E402
    load_lepard_checkpoint,
    load_motion_complete_params,
    normalize_indexed,
)
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig  # noqa: E402
from occlusionfusion_tpu.utils.snapshot import load_params  # noqa: E402
from torch_port_impl import jax_lepard_match_counts  # noqa: E402

H, W = 448, 640


def bench_sequence(n_frames, h=H, w=W, step=(0.0, 0.0, 0.004), r=0.1):
    """bench.py's make_sequence."""
    intr = Intrinsics(np.float32(2.3 * w), np.float32(2.3 * w),
                      np.float32(w / 2), np.float32(h / 2))
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy,
                  np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depths, colors = [], []
    for i in range(n_frames):
        c = np.asarray([0.0, 0.0, 1.0]) + np.asarray(step) * i
        b = d @ c
        disc = b * b - (c @ c - r * r)
        t = b - np.sqrt(np.maximum(disc, 0))
        depths.append(np.where((disc > 0) & (t > 0), t * d[..., 2],
                               0.0).astype(np.float32))
        colors.append(np.full((h, w, 3), 128.0, np.float32))
    return ArraySequence(colors, depths, intr)


def main(frames: int = 16):
    ck = normalize_indexed(load_params(os.path.join(REPO, "checkpoints",
                                                    "flow.npz")))
    lep_params, lep_config = load_lepard_checkpoint(
        os.path.join(REPO, "checkpoints", "lepard_trained.npz"))
    cfg = FusionConfig(
        vol_dim=(128, 128, 128), voxel_size=0.005, node_coverage=0.05,
        max_nodes=256, max_points=8192, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=0.05, min_neighbors=2),
        use_motion_model=True, solver="gn_dense",
        gn=GNConfig(iters=2, w_point=1.0, w_arap=2.0, w_motion=1.0,
                    linear_solver="cholesky", assembly="blocks"),
        brick_size=8, max_bricks=1024, dense_skin_max_bytes=0,
        use_flow=True, flow_lift="sparse", flow_bf16=True, mask_downscale=2,
        use_lepard=True, lepard_max_target_points=2048, lepard_every=1,
        lepard_subsample="strided",
    )
    seq = bench_sequence(frames + 1)
    t0 = time.perf_counter()
    fusion = DynamicFusion(seq, cfg, lepard_params=lep_params,
                           lepard_config=lep_config,
                           flow_params=ck["pwc"], mask_params=ck["mask"])
    with jax_lepard_match_counts() as matches:
        infos = fusion.run_fused(chunk=16,
                                 motion_params=load_motion_complete_params())
    n = fusion.node_count
    trans = np.asarray(fusion.warp.translations)[:n]
    print(json.dumps({
        "frames": frames, "nodes": n,
        "median_node_translation": np.median(trans, axis=0).tolist(),
        "n_correspondences": [i["n_correspondences"] for i in infos],
        "n_lepard_matches": matches,
        "seconds": time.perf_counter() - t0,
    }), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
