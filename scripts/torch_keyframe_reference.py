#!/usr/bin/env python3
"""The JAX package's results on the keyframe inputs of the PyTorch port's
chip_smoke.py (phases ``keyframe_path`` and ``keyframe_stepwise``): the
JAX FusionConfig defaults (N-ICP with 100 iterations, the motion GNN,
bricks of 8 at 128^3 at 5 mm with max_bricks 2048, node coverage 0.05 m,
512-node cap, 8192 points) on chip_smoke's ``keyframe_sequence``
(448x640, f = 1472 px: the main sphere, r 0.14 m at 3 m, receding 4 mm a
frame for 24 frames and coming back, and a second sphere, r 0.06 m,
sliding in from the right and then moving in depth with it).

- ``keyframe_path``: ``run_fused(chunk=16)`` over 48 frames with growth
  and keyframes every 16th frame;
- ``keyframe_stepwise``: the stepwise ``run`` over 32 frames with
  keyframes every 2nd and growth every 8th frame, a rigid (5, 0, 30) mm
  offset left-composed into the warp before the keyframe work of frame
  10 (as tests/test_pose_graph_in_loop.py:181-221 injects drift).

Both built as scripts/run_fusion.py builds them (the motion checkpoint
given to the constructor, so that growth rebuilds the motion pyramid),
with the fused voxel warp the gather LBS (dense_skin_max_bytes=0), the
semantics of the port's LBS kernel. Prints one JSON line per loop: the
new nodes and bricks of each growth, the node count, the active bricks,
the main nodes' median translation, the keyframe trajectory, the loop
closures and corrections of each keyframe, each frame's correspondences
and, for the stepwise run, the drift's correction and the model's error
before and after it. chip_smoke.py records them as KEYFRAME_REFERENCE
and KEYFRAME_STEPWISE_REFERENCE.

- ``growth_case``: the state entering keyframe_path's growth at frame
  32 and JAX's growth and next fused step on it, written to
  reference/keyframe_growth.npz (see ``growth_case``), which chip_smoke.py's
  phase ``keyframe_growth_case`` holds the card to.

    JAX_PLATFORMS=cpu python scripts/torch_keyframe_reference.py [LOOP ...]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import chip_smoke as CS  # noqa: E402
from occlusionfusion_tpu.fusion import warpfield as W  # noqa: E402
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


def config(stepwise: bool) -> FusionConfig:
    cfg = FusionConfig(dense_skin_max_bytes=0)
    assert cfg.solver == "nicp" and cfg.nicp.iters == CS.NICP_ITERS
    assert cfg.graph == GraphConfig()
    if stepwise:
        return dataclasses.replace(cfg, **CS.KEYFRAME_STEPWISE)
    return dataclasses.replace(cfg, growth_interval=CS.KEYFRAME_GROWTH,
                               keyframe_interval=CS.KEYFRAME_INTERVAL)


def sequence(n_frames):
    seq_t, centers = CS.keyframe_sequence(n_frames)
    i = seq_t.intrinsics
    return ArraySequence(seq_t.colors, seq_t.depths,
                         Intrinsics(*(np.float32(x) for x in i))), centers


def deformed_centroid(fusion):
    pts = np.asarray(W.deform_points(fusion.warp, fusion.model_points,
                                     fusion.point_table))
    valid = np.asarray(fusion.model_valid & fusion.point_table.valid)
    return pts[valid].mean(0)


def run(loop: str):
    stepwise = loop == "keyframe_stepwise"
    frames = (CS.KEYFRAME_STEPWISE_FRAMES if stepwise
              else CS.KEYFRAME_FRAMES)
    seq, centers = sequence(frames + 1)
    params = load_motion_complete_params()
    fusion = DynamicFusion(seq, config(stepwise), motion_params=params)
    growth, refresh = [], fusion._refresh_bricks
    fusion._refresh_bricks = lambda f: growth.append(
        {"frame": f.index, "n_new_bricks": refresh(f)}) or growth[-1][
        "n_new_bricks"]
    drift = {}
    if stepwise:
        record = fusion._record_keyframe

        def drifted(frame):
            if frame.index == CS.KEYFRAME_DRIFT_FRAME:
                drift["true"] = deformed_centroid(fusion)
                fusion.warp = W.left_compose_rigid(
                    fusion.warp, jnp.eye(3),
                    jnp.asarray(CS.KEYFRAME_DRIFT, jnp.float32))
                drift["before"] = float(np.linalg.norm(
                    deformed_centroid(fusion) - drift["true"]))
            return record(frame)

        fusion._record_keyframe = drifted
        register = fusion.register_frame

        def after(frame):
            info = register(frame)
            if frame.index == CS.KEYFRAME_DRIFT_FRAME:
                drift["after"] = float(np.linalg.norm(
                    deformed_centroid(fusion) - drift["true"]))
                drift["pose_correction"] = info["pose_correction"]
            return info

        fusion.register_frame = after
    t0 = time.perf_counter()
    infos = (fusion.run() if stepwise
             else fusion.run_fused(chunk=CS.CHUNK, motion_params=params))
    seconds = time.perf_counter() - t0
    for frame, info in enumerate(infos, start=1):
        info.setdefault("frame", frame)  # the stepwise loop's infos
    n = fusion.node_count
    nodes = np.asarray(fusion.nodes)
    trans = np.asarray(fusion.warp.translations)
    med, n_main = CS.main_node_median(nodes, trans, n, centers[0])
    for g, i in zip(growth, [i for i in infos if "n_new_nodes" in i
                             and (not stepwise or i["frame"]
                                  % CS.KEYFRAME_STEPWISE["growth_interval"]
                                  == 0)]):
        assert g["frame"] == i["frame"], (g, i)
        g["n_new_nodes"] = i["n_new_nodes"]
    drift.pop("true", None)
    ids, R, t = fusion.trajectory()
    keyframes = [{k: i[k] for k in ("frame", "pose_correction",
                                    "loop_closures", "reloc_feat_matches")}
                 for i in infos if "loop_closures" in i]
    print(json.dumps({
        "loop": loop, "frames": frames, "nodes": n, "main_nodes": n_main,
        "active_bricks": int((np.asarray(fusion.brick_ids) >= 0).sum()),
        "growth": growth,
        "main_median_translation": med.tolist(),
        "trajectory": {"frames": ids.tolist(), "R": R.tolist(),
                       "t": t.tolist()},
        "keyframes": keyframes,
        "drift": drift or None,
        "n_correspondences": [i["n_correspondences"] for i in infos],
        "track_lost": bool(getattr(fusion, "track_lost", False)),
        "seconds": seconds,
    }), flush=True)


def growth_case():
    """The later growth keyframe of ``keyframe_path`` as a fixed input:
    run_fused up to frame CS.KEYFRAME_CASE_FRAME, the state that enters
    that frame's growth (the canonical TSDF quantized, the warp, the graph,
    the brick table, the model points and the fused engine's motion
    history) written to CS.KEYFRAME_CASE_NPZ under ``in/``; then, on that
    input dequantized (CS.keyframe_case_snapshot) and loaded into a fresh
    object, the growth (refresh + grow) and one fused step of the next
    frame on the rebuilt tables, under ``out/``."""
    import tempfile

    from occlusionfusion_tpu.fusion import fused_step as FS
    from occlusionfusion_tpu.utils.snapshot import load_flat

    frame = CS.KEYFRAME_CASE_FRAME
    seq, _ = sequence(frame + 2)
    params = load_motion_complete_params()
    fusion = DynamicFusion(seq, config(False), motion_params=params)
    chunk_fn, last = FS.fused_register_chunk, {}

    def recorded(*args, **kwargs):
        last["state"], out = chunk_fn(*args, **kwargs)
        return last["state"], out

    FS.fused_register_chunk = recorded
    grow, case = fusion._grow, {}
    tmp = tempfile.TemporaryDirectory()

    def captured(f):
        if f.index == frame:
            path = os.path.join(tmp.name, "before.npz")
            fusion.save_state(path)
            flat = load_flat(path)
            for k, v in last["state"].motion._asdict().items():
                flat[f"motion_state/{k}"] = np.asarray(v)
            case.update(CS.keyframe_case_quantize(flat))
        return grow(f)

    fusion._grow = captured
    fusion.run_fused(end=frame + 1, chunk=CS.CHUNK, motion_params=params)
    FS.fused_register_chunk = chunk_fn
    assert case, "no growth at the case frame"

    # JAX on the dequantized input
    path = os.path.join(tmp.name, "case.npz")
    CS.keyframe_case_snapshot(case, path)
    fj = DynamicFusion(seq, config(False), motion_params=params)
    fj.load_state(path)
    n_bricks = []
    refresh = fj._refresh_bricks
    fj._refresh_bricks = lambda f: n_bricks.append(refresh(f)) or n_bricks[-1]
    n_new = fj._grow(seq.load(frame))
    out = {"n_new_nodes": n_new, "n_new_bricks": n_bricks[0],
           "node_count": fj.node_count, "brick_ids": fj.brick_ids,
           "nodes": fj.nodes, "edges": fj.edges,
           "edge_weights": fj.edge_weights,
           "grown_rotations": fj.warp.rotations,
           "grown_translations": fj.warp.translations}
    sc, state, tables = fj.build_fused(params)
    state = state._replace(motion=fj.motion_runner.state)
    nxt = seq.load(frame + 1)
    state, info = FS.fused_register_chunk(
        sc, state, tables, fj._device_params(params),
        jnp.asarray(nxt.depth)[None], jnp.asarray(nxt.color)[None],
        fj._device_params(fj.intr), None)
    out.update(step_rotations=state.rotations,
               step_translations=state.translations, step_info=info[0])
    case.update({f"out/{k}": np.asarray(v) for k, v in out.items()})
    os.makedirs(os.path.dirname(CS.KEYFRAME_CASE_NPZ), exist_ok=True)
    np.savez_compressed(CS.KEYFRAME_CASE_NPZ, **case)
    print(json.dumps({"case": CS.KEYFRAME_CASE_NPZ, "n_new_nodes": n_new,
                      "n_new_bricks": n_bricks[0],
                      "node_count": fj.node_count,
                      "n_correspondences": int(np.asarray(info)[0, 1]),
                      "bytes": os.path.getsize(CS.KEYFRAME_CASE_NPZ)}),
          flush=True)
    tmp.cleanup()


def main(loops):
    for loop in loops or ("keyframe_path", "keyframe_stepwise",
                          "growth_case"):
        if loop == "growth_case":
            growth_case()
        else:
            run(loop)


if __name__ == "__main__":
    main(sys.argv[1:])
