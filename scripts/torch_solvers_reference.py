#!/usr/bin/env python3
"""The JAX package's results on the solver inputs of the PyTorch port's
chip_smoke.py (phases ``gn_solvers``, ``gn_2d_depth`` and
``nicp_costs``), JAX on the CPU.

* ``gn``: the main path's settings (dense 128^3 at 5 mm, 448x640,
  512-node cap, 8192 model points, the motion GNN, GN 4 iterations with
  w_point 1, w_arap 2, w_motion 1) on its sphere (grey, r = 0.14 m at
  3 m, receding 4 mm a frame), initialize plus FRAMES frames through
  ``run_fused(chunk=16)``, once per linear solver (cg, schur, ns) and
  once with the 2d_depth data term (w_flow 1e-3, w_depth 1, the defaults
  of scripts/run_fusion.py) and Cholesky; XLA "blocks" assembly, the
  route the port's kernels follow (ROADMAP F1).
* ``chamfer``: the JAX FusionConfig defaults (N-ICP, 100 Adam
  iterations, bricks of 8 in 2048 slots; chip_smoke's nicp_config) on
  the same sphere with w_chamfer = 0 and each weight in CHAMFER_WEIGHTS;
  writes the chamfer subsamples JAX draws from PRNGKey(0) in every solve
  to reference/solvers_chamfer.npz (int16 [iters + 1, 2, 1000]).
* ``rendered``: the stepwise N-ICP loop of the same defaults up to frame
  RENDERED_FRAME, whose N-ICP problem (with its warm start, the frame's
  depth map and the intrinsics) goes to reference/solvers_rendered.npz,
  with the JAX package's loss and gradient at the warm start under
  RENDERED_CONFIG (silhouette and projective-depth costs on), the whole
  solve's loss history, and the loss and gradient at the warm start of
  the chamfer objective (the defaults with NICP_CHAMFER_WEIGHT).

Prints one JSON line per run; chip_smoke.py records them as
GN_SOLVERS_REFERENCE, GN_2D_DEPTH_REFERENCE and NICP_CHAMFER_REFERENCE.
One difference from the JAX defaults, to compute what the port
computes: the fused voxel warp is the gather LBS (dense_skin_max_bytes=0),
the semantics of the port's LBS kernel.

    JAX_PLATFORMS=cpu python scripts/torch_solvers_reference.py \
        [FRAMES [PART ...]]      (PART: gn, chamfer, rendered)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke as CS  # noqa: E402
from occlusionfusion_tpu.fusion import pipeline as PJ  # noqa: E402
from occlusionfusion_tpu.fusion.frame_loader import ArraySequence  # noqa: E402
from occlusionfusion_tpu.geometry.camera import Intrinsics  # noqa: E402
from occlusionfusion_tpu.geometry.so3 import so3_log  # noqa: E402
from occlusionfusion_tpu.graph.edgraph import GraphConfig  # noqa: E402
from occlusionfusion_tpu.models.checkpoint import (  # noqa: E402
    load_motion_complete_params,
)
from occlusionfusion_tpu.solvers import nicp as NJ  # noqa: E402
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig  # noqa: E402
from torch_port_impl import jax_chamfer_table  # noqa: E402

CHAMFER_WEIGHTS = (1.0, 10.0, 100.0)


def sequence(frames):
    seq_t, _ = CS.sphere_sequence(frames + 1, CS.IMG_H, CS.IMG_W, CS.RADIUS,
                                  CS.STEP_Z, CS.DISTANCE)
    i = seq_t.intrinsics
    return ArraySequence(seq_t.colors, seq_t.depths,
                         Intrinsics(*(np.float32(x) for x in i)))


def base_config(**kw):
    return PJ.FusionConfig(
        vol_dim=(CS.VOL,) * 3, voxel_size=CS.VOXEL,
        node_coverage=CS.COVERAGE, max_nodes=CS.MAX_NODES,
        max_points=CS.MAX_POINTS, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=CS.COVERAGE, min_neighbors=2),
        dense_skin_max_bytes=0, **kw)


def emit(obj):
    print(json.dumps(obj), flush=True)


def run_fused(label, seq, cfg, params, frames):
    t0 = time.perf_counter()
    fusion = PJ.DynamicFusion(seq, cfg)
    infos = fusion.run_fused(chunk=16, motion_params=params)
    n = fusion.node_count
    trans = np.asarray(fusion.warp.translations)[:n]
    out = {"run": label, "frames": frames, "nodes": n,
           "median_node_translation": np.median(trans, axis=0).tolist(),
           "n_correspondences": [i["n_correspondences"] for i in infos],
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def part_gn(frames, params):
    seq = sequence(frames)
    gn = dict(iters=CS.GN_ITERS, w_point=1.0, w_arap=2.0, w_motion=1.0,
              assembly="blocks")
    for label, extra in (("cg", dict(linear_solver="cg")),
                         ("schur", dict(linear_solver="schur")),
                         ("ns", dict(linear_solver="ns")),
                         ("2d_depth", dict(data_term="2d_depth", w_flow=1e-3,
                                           w_depth=1.0))):
        cfg = base_config(solver="gn_dense", brick_size=0,
                          gn=GNConfig(**gn, **extra))
        run_fused(label, seq, cfg, params, frames)


def nicp_defaults(**kw):
    cfg = base_config(nicp=NJ.NICPConfig(iters=CS.NICP_ITERS, **kw),
                      max_bricks=CS.NICP_MAX_BRICKS)
    assert cfg.solver == "nicp" and cfg.brick_size == -1
    return cfg


def part_chamfer(frames, params):
    seq = sequence(frames)
    cfg0 = nicp_defaults()
    P = cfg0.max_points
    table = jax_chamfer_table(cfg0.nicp.iters, cfg0.nicp.chamfer_samples,
                              P, P)
    assert table.max() < 2**15
    np.savez_compressed(os.path.join(REPO, "reference",
                                     "solvers_chamfer.npz"),
                        table=table.astype(np.int16))
    base = run_fused("nicp_chamfer_0", seq, cfg0, params, frames)
    for w in CHAMFER_WEIGHTS:
        out = run_fused(f"nicp_chamfer_{w:g}", seq, nicp_defaults(
            w_chamfer=w), params, frames)
        emit({"run": f"nicp_chamfer_{w:g}_shift_m", "shift": (
            np.subtract(out["median_node_translation"],
                        base["median_node_translation"])).tolist()})


def part_rendered(params):
    frame = CS.RENDERED_FRAME
    seq = sequence(frame)
    cfg = nicp_defaults()
    calls = []
    orig = PJ.solve

    def tap(problem, config, init_rotations=None, init_translations=None,
            **kw):
        calls.append((problem, init_rotations, init_translations))
        return orig(problem, config, init_rotations, init_translations, **kw)

    PJ.solve = tap
    try:
        fusion = PJ.DynamicFusion(seq, cfg, motion_params=params)
        fusion.run(end=frame + 1)
    finally:
        PJ.solve = orig
    problem, R0, t0 = calls[frame - 1]
    intr = seq.intrinsics
    problem = problem._replace(
        render_intrinsics=np.asarray([intr.fx, intr.fy, intr.cx, intr.cy],
                                     np.float32),
        target_depth=np.asarray(seq.depths[frame], np.float32))
    rcfg = NJ.NICPConfig(**CS.RENDERED_CONFIG)
    arrays = {k: np.asarray(v) for k, v in problem._asdict().items()}
    jp = NJ.NICPProblem(**{k: jax.numpy.asarray(v) for k, v in
                           arrays.items()})
    params0 = {"omega": so3_log(jax.numpy.asarray(R0)),
               "t": jax.numpy.asarray(t0)}
    (loss, _), grad = jax.value_and_grad(NJ._objective, has_aux=True)(
        params0, jp, rcfg, jax.random.PRNGKey(0))
    # the chamfer objective (the JAX defaults with NICP_CHAMFER_WEIGHT) at
    # the same start, on the final loss's subsamples (PRNGKey(0) itself,
    # the last row of reference/solvers_chamfer.npz)
    ccfg = NJ.NICPConfig(iters=CS.NICP_ITERS,
                         w_chamfer=CS.NICP_CHAMFER_WEIGHT)
    (closs, _), cgrad = jax.value_and_grad(NJ._objective, has_aux=True)(
        params0, jp, ccfg, jax.random.PRNGKey(0))
    res = NJ.solve(jp, rcfg, jax.numpy.asarray(R0), jax.numpy.asarray(t0))
    np.savez_compressed(
        os.path.join(REPO, "reference", "solvers_rendered.npz"),
        init_rotations=np.asarray(R0), init_translations=np.asarray(t0),
        loss=np.float32(loss),
        grad=np.concatenate([np.asarray(grad["omega"]),
                             np.asarray(grad["t"])], -1),
        loss_history=np.asarray(res.loss_history),
        chamfer_loss=np.float32(closs),
        chamfer_grad=np.concatenate([np.asarray(cgrad["omega"]),
                                     np.asarray(cgrad["t"])], -1),
        **arrays)
    emit({"run": "rendered", "frame": frame, "loss": float(loss),
          "final_loss": float(res.final_loss),
          "grad_abs_max": float(np.abs(np.asarray(grad["t"])).max())})


def main(frames=16, parts=("gn", "chamfer", "rendered")):
    params = load_motion_complete_params()
    if "gn" in parts:
        part_gn(frames, params)
    if "chamfer" in parts:
        part_chamfer(frames, params)
    if "rendered" in parts:
        part_rendered(params)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16,
         tuple(sys.argv[2:]) or ("gn", "chamfer", "rendered"))
