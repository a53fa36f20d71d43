#!/usr/bin/env python3
"""The JAX package's results on the N-ICP inputs of the PyTorch port's
chip_smoke.py (phases ``nicp_path`` and ``stepwise``): the JAX
FusionConfig defaults (solver "nicp" with NICPConfig(iters=100), the
motion GNN, bricks of 8 at 128^3 with max_bricks 2048) on chip_smoke's
main-path sphere (flat grey, r = 0.14 m at 3 m, receding 4 mm a frame,
448x640, f = 1472 px, 5 mm voxels, node coverage 0.015 m, 512-node cap,
8192 model points), initialize plus FRAMES frames, through
``DynamicFusion.run_fused(chunk=16)`` and through the stepwise
``DynamicFusion.run``. Prints, per loop, the median node translation,
the node count and each frame's correspondences as one JSON line;
chip_smoke.py records them as NICP_REFERENCE and STEPWISE_REFERENCE.

One difference from the JAX defaults, to compute what the port
computes: the fused voxel warp is the gather LBS
(dense_skin_max_bytes=0), the semantics of the port's LBS kernel.

    JAX_PLATFORMS=cpu python scripts/torch_nicp_reference.py [FRAMES]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke as CS  # noqa: E402
from occlusionfusion_tpu.fusion.frame_loader import ArraySequence  # noqa: E402
from occlusionfusion_tpu.fusion.pipeline import (  # noqa: E402
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu.geometry.camera import Intrinsics  # noqa: E402
from occlusionfusion_tpu.graph.edgraph import GraphConfig  # noqa: E402
from occlusionfusion_tpu.models.checkpoint import (  # noqa: E402
    load_motion_complete_params,
)


def main(frames: int = 16):
    seq_t, _ = CS.sphere_sequence(frames + 1, CS.IMG_H, CS.IMG_W, CS.RADIUS,
                                  CS.STEP_Z, CS.DISTANCE)
    i = seq_t.intrinsics
    seq = ArraySequence(seq_t.colors, seq_t.depths,
                        Intrinsics(*(np.float32(x) for x in i)))
    cfg = FusionConfig(
        vol_dim=(CS.VOL,) * 3, voxel_size=CS.VOXEL,
        node_coverage=CS.COVERAGE, max_nodes=CS.MAX_NODES,
        max_points=CS.MAX_POINTS, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=CS.COVERAGE, min_neighbors=2),
        dense_skin_max_bytes=0,
    )
    assert cfg.solver == "nicp" and cfg.nicp.iters == 100
    params = load_motion_complete_params()
    for loop in ("run_fused", "run"):
        t0 = time.perf_counter()
        if loop == "run_fused":
            fusion = DynamicFusion(seq, cfg)
            infos = fusion.run_fused(chunk=16, motion_params=params)
        else:
            fusion = DynamicFusion(seq, cfg, motion_params=params)
            infos = fusion.run()
        n = fusion.node_count
        trans = np.asarray(fusion.warp.translations)[:n]
        print(json.dumps({
            "loop": loop, "frames": frames, "nodes": n,
            "median_node_translation": np.median(trans, axis=0).tolist(),
            "n_correspondences": [i["n_correspondences"] for i in infos],
            "seconds": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
