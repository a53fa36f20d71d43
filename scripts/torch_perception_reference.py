#!/usr/bin/env python3
"""The JAX package's results on the perception inputs of the PyTorch
port's chip_smoke.py (phases ``perception`` and ``perception_stepwise``):
the headline's settings (bench.py's ENVELOPE_ENV: bricked 128^3 at 5 mm,
1024 slots, 256-node cap, node coverage 0.05, 8192 points, dense
Gauss-Newton with 2 iterations, the motion GNN, PWC + MaskNet in bf16 on
the sparse lift with MaskNet at 1/2, Lepard on a strided 2048-point
target subsample) on chip_smoke's textured sphere (r = 0.10 m at 1 m,
4 mm a frame in z and 3 mm a frame in x, 448x640, f = 1472 px),
initialize plus FRAMES frames:

  perception           flow_mode "advect", Lepard from
                       checkpoints/lepard_bridge_r5e.npz with
                       coherence_tau 0.06, lepard_every 2, through
                       DynamicFusion.run_fused(chunk=16);
  perception_stepwise  flow_mode "override", flow_downscale 2,
                       flow_mask_patch 4, the same matcher with
                       batched_encode, lepard_every 2, through the
                       stepwise DynamicFusion.run;
  perception_f32       perception with PWC and MaskNet in f32.

Prints one JSON line per phase: the median node translation (a vector)
after the first frame and after all FRAMES, the node count, and per
frame the correspondences and the Lepard matcher's matches (the sum of
its blend mask, read through a host callback; 0 on the frames the
cadence gate skips). chip_smoke.py records them as PERCEPTION_REFERENCE,
PERCEPTION_STEPWISE_REFERENCE and PERCEPTION_F32_REFERENCE. The settings come from chip_smoke.py
itself (perception_config, perception_lepard, PERCEPTION).

The same callback keeps the matcher's inputs at each frame where it ran
(the valid deformed model points and target points). They are rounded
to chip_smoke.MATCHER_QUANTUM m about the case's origin, JAX's
scene_flow runs again on exactly those points, and the points with its
results (anchors before and after the coherence filter, blend mask,
blended flow at a stride) of the first two phases are written to
chip_smoke.MATCHER_CASES, the cases of phase `perception_matcher`,
when both run at FRAMES = chip_smoke.PERCEPTION_FRAMES.

The JAX result on this input is unstable (ROADMAP F9): the sphere gives
the geometric matcher no features, so its mutual matches are near ties,
and a relative change of 1e-6 in the depth moves JAX's own median by up
to centimetres, from the first frame the matcher runs. So each phase is
also run on the depth scaled by 1 + EPS for each EPS in ENSEMBLE, and the
line gives those runs' medians and the frames whose counts every run
reproduces within 0.5% (``stable_frames``): chip_smoke.py holds the card
to JAX there, and to the first frame's median (the matcher not yet run),
where the runs agree to 0.05 mm. The line also gives each run's
per-frame counts (``ensemble_n_correspondences``,
``ensemble_n_lepard_matches``).

Differences from bench.py, each to compute what the port computes: the
Gauss-Newton assembly is "blocks" (the XLA twin of the point-term kernel,
whose Pallas version mishandles fractional correspondence weights;
ROADMAP F1; advect weights its targets flow_advect_weight x MaskNet's)
and the voxel warp is the gather LBS (dense_skin_max_bytes=0). skip is
1, where the two JAX engines gate Lepard on the same frames (ROADMAP
F7).

    JAX_PLATFORMS=cpu python scripts/torch_perception_reference.py \
        [FRAMES [PHASE ...]]
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import chip_smoke as CS  # noqa: E402
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
from occlusionfusion_tpu.models import lepard as JL  # noqa: E402


def jax_config(port_cfg) -> FusionConfig:
    """The JAX FusionConfig of the port's (chip_smoke.perception_config),
    field by field, with the "blocks" assembly and the gather LBS."""
    g = port_cfg.gn
    fields = {f.name: getattr(port_cfg, f.name)
              for f in dataclasses.fields(port_cfg)
              if f.name not in ("graph", "gn", "nicp")}
    return FusionConfig(
        **fields,
        graph=GraphConfig(node_coverage=port_cfg.graph.node_coverage,
                          min_neighbors=port_cfg.graph.min_neighbors),
        gn=GNConfig(iters=g.iters, w_point=g.w_point, w_arap=g.w_arap,
                    w_motion=g.w_motion, linear_solver=g.linear_solver,
                    assembly="blocks"),
        dense_skin_max_bytes=0,
    )


ENSEMBLE = CS.PERCEPTION_ENSEMBLE


@contextlib.contextmanager
def lepard_calls():
    """Within the block, each call of the JAX matcher
    (``models.lepard.scene_flow``, imported when a step is traced)
    reports its source and target points with their masks and its blend
    mask, through an ordered host callback, into the list this yields,
    in call order. JAX's caches are cleared on entry, so that a step
    traced before is traced again with the callback."""
    orig, calls = JL.scene_flow, []

    def tapped(params, config, sp, sv, tp, tv, **kwargs):
        flow, mask, m = orig(params, config, sp, sv, tp, tv, **kwargs)
        jax.debug.callback(
            lambda *a: calls.append([np.asarray(x) for x in a]),
            sp, sv, tp, tv, mask, ordered=True)
        return flow, mask, m

    jax.clear_caches()
    JL.scene_flow = tapped
    try:
        yield calls
    finally:
        JL.scene_flow = orig


def lepard_of(stepwise):
    """The JAX matcher of chip_smoke.perception_lepard(stepwise)."""
    lep, lcfg = load_lepard_checkpoint(os.path.join(
        REPO, "checkpoints", CS.PERCEPTION["lepard"]))
    return lep, lcfg._replace(coherence_tau=CS.PERCEPTION["coherence_tau"],
                              batched_encode=stepwise)


def run(phase, seq, end, ck, motion):
    """(median node translation, infos, Lepard matches per frame, node
    count, the matcher's calls) of one phase's JAX run over frames
    1 .. end - 1."""
    stepwise = phase == "perception_stepwise"
    cfg = jax_config(CS.perception_config(stepwise,
                                          bf16=phase != "perception_f32"))
    lep, lcfg = lepard_of(stepwise)
    fusion = DynamicFusion(
        seq, cfg, motion_params=motion if stepwise else None,
        lepard_params=lep, lepard_config=lcfg, flow_params=ck["pwc"],
        mask_params=ck["mask"])
    with lepard_calls() as calls:
        if stepwise:
            infos = fusion.run(end=end)
        else:
            infos = fusion.run_fused(end=end, chunk=16, motion_params=motion)
    every = CS.PERCEPTION["lepard_every"]
    fired = [i % every == 0 for i in range(1, end)]
    assert len(calls) == sum(fired), (len(calls), fired)
    it = iter(int(c[-1].sum()) for c in calls)
    trans = np.asarray(fusion.warp.translations)[:fusion.node_count]
    return (np.median(trans, axis=0).tolist(), infos,
            [next(it) if f else 0 for f in fired], fusion.node_count, calls)


def matcher_cases(phase, calls, out):
    """Round each call's valid points to CS.MATCHER_QUANTUM about its
    origin, run JAX's scene_flow on exactly those points (and again with
    the coherence filter off, for the anchors before it), and put both
    into ``out`` under "phase/frame/name". Returns per case (frame,
    blend count on the rounded points, blend count in the run, anchors
    before and after the filter)."""
    lep, lcfg = lepard_of(phase == "perception_stepwise")
    every = CS.PERCEPTION["lepard_every"]
    summary = []
    for k, (sp, sv, tp, tv, mask) in enumerate(calls):
        frame = every * (k + 1)
        src, tgt = sp[sv], tp[tv]
        origin = np.round(np.concatenate([src, tgt]).mean(0), 3).astype(
            np.float32)
        q = [np.round((x - origin) / CS.MATCHER_QUANTUM) for x in (src, tgt)]
        assert all(np.abs(x).max() < 32767 for x in q), phase
        q = [x.astype(np.int16) for x in q]
        src, tgt = (CS.matcher_points(origin, x) for x in q)
        ones = (jnp.ones(len(src), bool), jnp.ones(len(tgt), bool))
        flow, blend, m = JL.scene_flow(lep, lcfg, jnp.asarray(src), ones[0],
                                       jnp.asarray(tgt), ones[1])
        pre = JL.scene_flow(lep, lcfg._replace(coherence_tau=0.0),
                            jnp.asarray(src), ones[0], jnp.asarray(tgt),
                            ones[1])[2].match_valid
        key = f"{phase}/{frame}/"
        out.update({key + "origin": origin, key + "src_q": q[0],
                    key + "tgt_q": q[1],
                    key + "anchors_pre": np.asarray(pre),
                    key + "anchors": np.asarray(m.match_valid),
                    key + "blend": np.asarray(blend),
                    key + "flow": np.asarray(
                        flow)[::CS.MATCHER_FLOW_STRIDE]})
        summary.append((frame, int(np.asarray(blend).sum()),
                        int(mask.sum()), int(np.asarray(pre).sum()),
                        int(np.asarray(m.match_valid).sum())))
    return summary


PHASES = ("perception", "perception_stepwise", "perception_f32")


def main(frames: int = CS.PERCEPTION_FRAMES, phases=PHASES):
    CS.PERCEPTION_FRAMES = frames
    seq_t, centers = CS.perception_sequence()
    intr = Intrinsics(*(np.float32(x) for x in seq_t.intrinsics))
    ck = normalize_indexed(load_params(os.path.join(REPO, "checkpoints",
                                                    "flow.npz")))
    motion = load_motion_complete_params()
    cases = {}
    for phase in phases:
        t0 = time.perf_counter()
        seq = ArraySequence(seq_t.colors, seq_t.depths, intr)
        first = run(phase, seq, 2, ck, motion)[0]
        med, infos, matches, n, calls = run(phase, seq, frames + 1, ck,
                                            motion)
        summary = (matcher_cases(phase, calls, cases)
                   if phase != "perception_f32" else [])
        corr = [i["n_correspondences"] for i in infos]
        members, stable = [], [True] * frames
        member_corr, member_matches = [], []
        for eps in ENSEMBLE:
            seq = ArraySequence([c for c in seq_t.colors],
                                [d * np.float32(1 + eps) for d in seq_t.depths],
                                intr)
            m, inf, mat, _, _ = run(phase, seq, frames + 1, ck, motion)
            members.append(m)
            member_corr.append([i["n_correspondences"] for i in inf])
            member_matches.append(mat)
            for j, (c, l) in enumerate(zip(member_corr[-1], mat)):
                stable[j] &= (abs(c - corr[j]) <= 0.005 * corr[j]
                              and abs(l - matches[j]) <= 0.005 * matches[j])
        print(json.dumps({
            "phase": phase, "frames": frames, "nodes": n,
            "first_frame_median_node_translation": first,
            "median_node_translation": med,
            "ensemble_eps": ENSEMBLE,
            "ensemble_median_node_translation": members,
            "sphere_motion": (centers[-1] - centers[0]).tolist(),
            "n_correspondences": corr,
            "n_lepard_matches": matches,
            "stable_frames": [j + 1 for j, ok in enumerate(stable) if ok],
            "ensemble_n_correspondences": member_corr,
            "ensemble_n_lepard_matches": member_matches,
            "matcher_cases": [dict(zip(("frame", "blend_rounded",
                                        "blend_in_run", "anchors_pre",
                                        "anchors"), c)) for c in summary],
            "seconds": time.perf_counter() - t0,
        }), flush=True)
    if frames == CS.PERCEPTION_FRAMES and set(PHASES[:2]) <= set(phases):
        os.makedirs(os.path.dirname(CS.MATCHER_CASES), exist_ok=True)
        np.savez_compressed(CS.MATCHER_CASES, **cases)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else CS.PERCEPTION_FRAMES,
         tuple(sys.argv[2:]) or PHASES)
