#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (occlusionfusion_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--ptxas] [--profile]
    python3 chip_smoke.py [--ptxas] --gn-compare TREE [TREE ...]
    python3 chip_smoke.py --keyframe-spread RUNS

``--ptxas`` prints each kernel's registers and spills; ``--profile``
traces frames 2-16 of the paths `main_path` and `envelope_flow`, one
16-frame graph replay of the headline and one N-ICP frame's replay with
torch.profiler and prints the device time by kernel name, the device's
busy share over each traced window and the device ops per frame. The frames/s of a ``--profile`` run
include the profiler's start-up; read them from a run without it.

Phases, each printing one JSON line with its wall seconds:
  1. device: the card, and `nvidia-smi --query-gpu=name,power.limit`;
  2. build: nvcc builds the port's kernels (csrc/*.cu) into one library;
  3. kernels: each hand-written kernel against its plain PyTorch twin on
     the card, at the shapes the main path gives it, on random inputs,
     with its time, the twin's time and the least time the card could
     take (bound) for those inputs; K3' and K4' add into the dense system
     (M, b, sq) and are held to their accumulating twins;
  4. main path: DynamicFusion.initialize + build_fused, then 16 frames of
     the fused loop (dense Gauss-Newton + motion GNN) on an analytic
     deforming sphere at 128^3 voxels (dense) / 448x640 / 512 nodes /
     8192 points, the sphere at 3 m; the sphere must be tracked and K1,
     K2, K3', K4' must have been launched by this phase, K3' and K4' four
     times per frame; the GN input of frame 8 is kept, and so are the
     inputs of K1's two calls in initialize (the voxel centres and the
     model points) and of K2's warp at frame 8;
  5. k12_path: K1 and K2 against their twins again on those inputs (the
     lattice voxel centres and the model points against the path's node
     table; the path's skin table and warp field, ~5% of the voxels
     reachable), timed with their bounds for them;
  6. gn_path: K3' and K4' against their twins again on the GN input,
     where the anchors share pairs as the real surface makes them, with
     their bounds for it, and `_assemble_blocks` timed on it
     (assembly_ms);
  7. envelope_flow: the same sphere, textured, through the reference
     envelope of bench.py: a bricked 128^3 volume (bricks of 8, 1024
     slots), PWC flow + MaskNet (checkpoints/flow.npz) filling points
     without a projective target, and the motion GNN; it must track,
     flow must fill points, and all four kernels must have been
     launched, K3' and K4' four times per frame;
  8. near: the main path's settings with the sphere at 1 m, at half the
     image, where the reference algorithm overshoots the motion; the card
     must reproduce the JAX package's result (NEAR_REFERENCE_Z);
  9. graph: the main path and the envelope again, 16 frames as eager
     steps and through the graph engine (fused_register_chunk): at each
     frame the captured step and the eager step, each run twice from the
     same eager state (step_checks: counts equal; the median node's
     rotation and translation within 1e-5; the 90th percentile over
     nodes of the per-node differences within STEP_PERCENTILE_LIMITS or
     3x the same between two eager or two graph steps, a statistic the
     few rim nodes that the atomics of K3', K4' and index_add_ flip
     cannot move; on the main path, which shows no flips, the largest
     node difference too), the 16-frame replay
     against the 16 eager steps (median node translation within 1 mm,
     launches per frame equal), the launches of a 2-frame replay counted
     from two profiler traces short enough to keep every record
     (traced_replay_launches, which fails when the two disagree); then
     frames/s of the eager and the graph engine in turns (eager, graph,
     graph, eager);
 10. headline: bench.py's ENVELOPE_ENV configuration (bricked 128^3 at
     5 mm, 1024 slots, 256 nodes, 8192 points, GN 2 iterations, the motion
     GNN, PWC + MaskNet with the sparse lift in bf16 and MaskNet at half
     resolution, Lepard from checkpoints/lepard_trained.npz on a strided
     2048-point target subsample every frame) on bench.py's sequence (a
     flat grey sphere at 1 m), through DynamicFusion.run_fused(chunk=16)
     and get_deformed_mesh; the median node z must be within 2 mm of the
     JAX package's result (HEADLINE_REFERENCE_Z), the correspondences
     and Lepard matches of each frame within 0.5% of JAX's, and K1
     (initialize and the mesh), K2, K3' and K4' (every captured frame)
     launched; every kernel is then held to its twin on the headline's
     own inputs (K1's three calls; K2 and K3'/K4' on the warm-up step
     before capture); then eager and graph frames/s in turns;
 11. parity: the main path, the envelope and the headline at a small size
     on the card (kernels, graph replays) and on the CPU (twins, eager
     steps) must agree;
 12. perception: the headline's settings with flow_mode "advect", Lepard
     from checkpoints/lepard_bridge_r5e.npz with its coherence filter on
     and lepard_every 2, on the textured sphere at 1 m moving 4 mm a frame
     in z and 3 mm in x, through DynamicFusion.run_fused(chunk=16) and
     get_deformed_mesh, held to the JAX package (PERCEPTION_REFERENCE;
     check_perception). On the featureless sphere the matcher's anchors
     are near ties, and a 1e-6 change of the depth moves JAX's own median
     by millimetres to centimetres (ROADMAP F9): so the median after 16
     frames, and that of each of the port's runs on the depth scaled by
     1 +- 1e-6 and 1 +- 2e-6, must lie within the range of JAX's runs on
     the same depths widened by the larger of the two runs' ranges and
     the shift JAX's bf16 nets make against its f32 run; the median
     after the first frame (a run of its own) within 2 mm of JAX's on
     each axis; the correspondences and Lepard matches within 0.5% of
     JAX's on the frames every JAX run reproduces, and on every frame
     within the two runs' ranges so widened; no matches on the frames the
     cadence gate skips and some on the others, flow targets on every
     frame after the first, one chunk graph per gate pattern, K1-K4'
     launched (K3'/K4' twice a frame); the tracking error printed; then
     phase graph's checks on this path (graph_case: step checks at frame
     1, gate off, and frame 2, gate on; the traced launches of each
     pattern's one-step graph; frames/s in turns);
 13. perception_stepwise: the same input through DynamicFusion.run with
     flow_mode "override", PWC at 1/2, patchwise NMS in 4x4 patches and
     the same matcher with batched_encode, lepard_every 2, held to the
     JAX package's stepwise result (PERCEPTION_STEPWISE_REFERENCE) as
     phase 12; then that matcher against the same weights without
     batched_encode on the card (batched_encode_check);
 14. perception_f32: phase 12's run with PWC and MaskNet in f32, held
     to the JAX package's f32 run (PERCEPTION_F32_REFERENCE) as phase 12;
     perception_matcher: the perception phases' matcher on the card on
     the JAX matcher's own inputs at every frame where it ran in JAX's
     two perception runs (MATCHER_CASES): the anchors before and after
     the coherence filter and the blend mask equal to JAX's, the flows
     within MATCHER_FLOW_TOL; the filter drops anchors in some of them;
     then parity of the two perception settings, of the perception
     setting with its nets in bf16 (with the bf16-vs-f32 gap on each side
     printed beside it) and of flow without MaskNet, as in phase 11;
 15. nicp_path: the JAX FusionConfig defaults (solver "nicp" with
     NICPConfig(iters=100), the motion GNN, bricks of 8 in 2048 slots) on
     the main path's sphere through DynamicFusion.run_fused(chunk=16)
     (one captured N-ICP step, replayed once per frame) and
     get_deformed_mesh: the median node z within 1 mm of the JAX
     package's result (NICP_REFERENCE_Z), each frame's correspondences
     within 0.5% of JAX's, K1 (initialize, the mesh) and K2 (each frame
     and the warm-up step) launched; K1 and K2 held to their twins on
     this run's inputs; then phase graph's checks on this path at the
     frames NICP_CHECK_FRAMES (the step checks without the max-over-nodes
     limits; the traced replay is the step's with 2 Adam iterations) and
     frames/s in
     turns over NICP_RATE_FRAMES frames;
 16. stepwise: the same input through DynamicFusion.run (one eager
     register_frame a frame), held to the JAX package's stepwise result
     (STEPWISE_REFERENCE_Z, within 1 mm; correspondences within 0.5%),
     with its frames/s and launches;
 17. nicp_solve: one N-ICP solve on the stepwise path's input at frame
     TAP_FRAME, eager and from a CUDA graph, with the device ops and
     device ms of one Adam iteration from traces of 10- and 20-iteration
     solves and the top ops;
 18. parity of N-ICP (20 Adam iterations) as in phase 11;
 19. keyframe_path: the JAX FusionConfig defaults with growth and
     keyframes every 16th frame (keyframe_config) on keyframe_sequence (an
     ellipsoid receding 4 mm a frame for 24 frames and coming back, a
     sphere sliding in beside it) through DynamicFusion.run_fused(chunk=16)
     over 48 frames and get_deformed_mesh, held to the JAX package's run
     (KEYFRAME_REFERENCE, scripts/torch_keyframe_reference.py): exactly up
     to the first growth (its new nodes and refreshed bricks, each
     frame's correspondences), after it within KEYFRAME_SPREAD_LIMITS
     (later growths, node and brick counts, the ellipsoid's median node
     translation, correspondences); the launches of K1 (initialize, each
     refresh and growth, the mesh) and K2 (each replay and each graph's
     warm-up); frames/s, each growth keyframe's host and recapture
     seconds, initialize seconds, peak memory; then K1 against its twin
     on each refresh's and growth's inputs and K2 on the grown table;
 20. keyframe_growth_case: the growth at frame 32 of keyframe_path on
     the JAX package's own state entering it (KEYFRAME_CASE_NPZ): the
     growth's counts, brick table and edges equal to JAX's, its nodes
     and warp within 1e-5 m, and the next frame's step, captured on the
     rebuilt tables, held to JAX's as the main path's steps are;
 21. keyframe_stepwise: the same input through DynamicFusion.run over 32
     frames with keyframes every 2nd and growth every 8th frame, a rigid
     3 cm drift injected before the keyframe work of frame 10, held to
     the JAX package's run (KEYFRAME_STEPWISE_REFERENCE): loop closures
     per keyframe, the drift's correction and the error it leaves; then
     a save_state at frame 16 resumed twice in fresh objects: frame 17's
     fused step gets the uninterrupted run's arguments bit for bit and,
     run with torch's deterministic algorithms, gives its result bit
     for bit;
 22. parity of the keyframe machinery as in phase 11: `keyframe`
     (run_fused with growth, brick refresh and keyframes), `recovery` (a
     lost track recovered with the matcher's feature seed) and `cluster`
     (a starved component frozen; K3' and K4' with frozen nodes).
 23. training: the four recipes of the port's trainers (flow: PWC +
     MaskNet, 64x64, batch 4; tracking: train_flow.py --through_solver,
     4 samples of 32 nodes and 512 matches, GN 3 iterations; motion:
     caps 128,32,16,8, batch 8, history 16; lepard: lepard_bridge_r5e and
     its config, the recipe's synthetic pair) from their starting
     checkpoints on the JAX recipes' own batches
     (reference/training_batches.npz): the step-0 loss, terms and global
     gradient norm and the losses of 5 optimiser steps held to JAX's
     (TRAINING_REFERENCE, scripts/torch_training_reference.py) within
     TRAINING_TOLS, the loss falling, ms per step and peak memory; the
     tracking recipe launches K3' and K4' 3 times per sample per step in
     its forward and never in its backward (the autograd Functions of
     ops/gn_assembly.py: kernel forward, the twin's vector-Jacobian
     product backward), their gradients through a 3-iteration solve
     held to the twins' autograd on its own GN input and on the main
     path's frame-8 input (TRAINING_FUNCTION_TOL), one finite difference
     along a random MaskNet direction (FD_TOL), a sample built on the
     card by the port's generator (K1 in its skinning) against JAX's,
     and K3'/K4' rows at the trainer's size; a trained flow checkpoint
     reloaded through load_flow_nets bit for bit; each trainer's CLI 2
     steps on the card.
Each phase prints its wall seconds. Then one JSON line with the kernel
table: every kernel on the main path's own inputs (K1 on each of its two
calls), with its launches in the main path's run, on the headline's,
with its launches in the headline's run (K1 in initialize and the mesh;
K2, K3' and K4' per replayed frame plus the one warm-up step before
capture), the same on the perception path's own inputs with that run's
launches (K3' on advect's fractional weights), and K1 and K2 on the
N-ICP path's, with its launches, and K1 on each refresh's and growth's
inputs of the keyframe path and K2 on its grown table, with that run's
launches, and K3' and K4' on the tracking trainer's GN input with the
tracking recipe's launches; then the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and exits
nonzero. Without a CUDA device, or without the port's package beside
this file, it exits nonzero and prints no result. It imports nothing of
JAX or of the JAX package.

``--keyframe-spread RUNS`` runs the phases keyframe_path and
keyframe_stepwise RUNS times each on their one input with the JAX checks
off (their readings printed, no kernel rows): the gaps between the
card's own runs are what KEYFRAME_SPREAD_LIMITS are set from.

``--gn-compare`` runs, for each TREE in the order given and each in its
own process, the main path to frame 8 with that tree's package, then
times and traces one Gauss-Newton solve on its input and three more
fused steps (gn_profile_tree), and checks and times K1 and K2 on the
path's inputs and on the random ones of phase 3 (knn_row, lbs_row,
through the wrappers' public signatures): the order parent, change,
change, parent compares two commits on one card.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and f32
# rate outside the tensor cores; every kernel here is f32 CUDA-core work
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# main-path configuration
VOL = 128
VOXEL = 0.005
IMG_H, IMG_W = 448, 640
MAX_NODES = 512
MAX_POINTS = 8192
RADIUS = 0.14
COVERAGE = 0.015
STEP_Z = 0.004  # sphere motion per frame (m)
# Sphere distance. At 3 m the rays that graze the sphere's rim are within
# ~3 degrees of the optical axis and the fused loop tracks the sphere.
DISTANCE = 3.0
# At 1 m (bench.py's geometry) the reference algorithm itself (projective
# point-to-point association, one association per frame) overshoots the
# motion of the oblique rim. The phase `near` runs the sphere there at
# half the image and a coarser grid over the same extent, and holds the
# card to the JAX package's result on that input, NEAR_REFERENCE_Z
# (median node z translation after 16 frames, in m).
# tests/test_torch_sphere_near.py runs the JAX package and the port on
# the CPU on this input and holds both to that value.
NEAR = dict(distance=1.0, h=224, w=320, vol=96, voxel=VOL * VOXEL / 96,
            max_points=4096)
NEAR_REFERENCE_Z = 0.07614488
N_FRAMES = 16
SEED = 0
# the kernels both full-size paths must launch
PATH_KERNELS = ("knn", "lbs_warp", "point_term_blocks", "arap_term_blocks")
ENVELOPE_MAX_BRICKS = 1024  # bench.py's BENCH_MAX_BRICKS for the envelope
GN_ITERS = 4
TAP_FRAME = 8  # the main-path frame whose GN input the kernel checks reuse
# the headline (bench.py's ENVELOPE_ENV): bench.py's sequence and its
# configuration; the JAX package's result on the CPU
# (scripts/torch_headline_reference.py; 15 nodes): the median node z
# translation after HEADLINE_FRAMES frames, and per frame the
# correspondences and the Lepard matches, which the card must reproduce
# within the fractions *_TOL
HEADLINE = dict(distance=1.0, radius=0.10, step=0.004, vol=128, voxel=0.005,
                coverage=0.05, max_nodes=256, max_points=8192, max_bricks=1024,
                gn_iters=2, lepard_targets=2048)
HEADLINE_FRAMES = 16
HEADLINE_REFERENCE_Z = 0.057025279849767685
HEADLINE_REFERENCE_CORRESPONDENCES = [
    4576, 4576, 4576, 4576, 4576, 4534, 4576, 4576, 4576, 4567, 4576, 4576,
    4576, 4576, 4571, 4576]
HEADLINE_REFERENCE_LEPARD = [
    4576, 4576, 4576, 4576, 4576, 4528, 4576, 4576, 4576, 4567, 4576, 4576,
    4576, 4576, 4571, 4576]
HEADLINE_CORRESPONDENCE_TOL = 0.005
HEADLINE_LEPARD_TOL = 0.005
# phase parity's limits on card against CPU: node translations (m) and
# rotation entries, largest per-frame differences of the mean confidence
# and the counts; the headline's (bf16 perception) are about 10x the
# readings on an NVIDIA H100 80GB HBM3 (1.1e-5 m, median 2.4e-6 m,
# 6.0e-4, 2.0e-5; counts 0, flow fills 1, Lepard matches 0)
PARITY_LIMITS = dict(max_dt_m=1e-4, max_dR=1e-3, max_dconf=0.015,
                     max_dcorr=2)
HEADLINE_PARITY_LIMITS = dict(max_dt_m=1e-4, median_dt_m=2.5e-5,
                              max_dR=6e-3, max_dconf=2e-4, max_dcorr=2,
                              max_dflow=3, max_dlepard=20)
# parity's row perception_bf16 (the perception setting with its nets in
# bf16, as the full-size phase runs them): cuDNN and the CPU round bf16
# otherwise, which flips the matcher's near-tie anchors on this input
# (ROADMAP F9). 3x the readings of two card runs of this row (the same
# in both: 0.0190 m, 0.0067 m, 0.465, 0.110, 8, 6, 91); the row also
# prints its witness, how far the same run moves between bf16 and f32
# nets on the card and on the CPU
PERCEPTION_BF16_PARITY_LIMITS = dict(max_dt_m=0.057, median_dt_m=0.020,
                                     max_dR=1.4, max_dconf=0.33,
                                     max_dcorr=24, max_dflow=18,
                                     max_dlepard=273)
# chunk length of the graph engine (bench.py's BENCH_CHUNK)
CHUNK = 16
# phase graph's step checks (F5, step_checks): the median node's
# rotation and translation, and the STEP_PERCENTILE-th percentile over
# nodes of the per-node differences, captured step against eager step;
# the percentile's limits are at least 3x the largest reading of the card
# runs recorded in PERF.md (F5)
# phase graph checks every GRAPH_CHECK_STRIDE-th frame's captured step
# against its eager step (every other one since the solver phases joined
# the script, for its time limit)
GRAPH_CHECK_STRIDE = 2
STEP_MEDIAN_LIMIT = 1e-5
STEP_PERCENTILE = 90
STEP_PERCENTILE_LIMITS = dict(dt_m=1e-4, dR=1e-2)
# the N-ICP paths (phases nicp_path, stepwise, nicp_solve): the JAX
# FusionConfig defaults (solver "nicp", NICPConfig(iters=100), the
# motion GNN, bricks of 8 at 128^3 in max_bricks 2048 slots) on the main
# path's sphere; the JAX package's results on the CPU
# (scripts/torch_nicp_reference.py; 297 nodes): the median node z
# translation after N_FRAMES frames and each frame's correspondences, of
# run_fused(chunk=16) and of the stepwise run, which the card must
# reproduce within 1 mm and NICP_CORRESPONDENCE_TOL
NICP_ITERS = 100
NICP_MAX_BRICKS = 2048
NICP_REFERENCE_Z = 0.06906302273273468
STEPWISE_REFERENCE_Z = 0.06902046501636505
NICP_REFERENCE_CORRESPONDENCES = [
    8167, 8172, 8170, 8166, 8160, 8165, 8169, 8173, 8173, 8173, 8173, 8173,
    8173, 8173, 8173, 8173]
STEPWISE_REFERENCE_CORRESPONDENCES = NICP_REFERENCE_CORRESPONDENCES
NICP_CORRESPONDENCE_TOL = 0.005
# the N-ICP path's frames (indices) checked step by step, and its frames
# timed in turns: an eager N-ICP step takes ~0.7 s
NICP_CHECK_FRAMES = (0, 7, 15)
NICP_RATE_FRAMES = 2
# the keyframe phases (keyframe_path, keyframe_stepwise): the JAX
# FusionConfig defaults (keyframe_config) on keyframe_sequence: an
# ellipsoid at the main path's distance receding STEP_Z a frame for
# KEYFRAME_TURN frames, then coming back, and a sphere (KEYFRAME_SECOND)
# sliding in from the right, out of view at frame 0, stopping beside the
# ellipsoid at frame 10 and then moving in depth with it. Phase keyframe_path:
# run_fused(chunk=16) over KEYFRAME_FRAMES frames with growth and
# keyframes every 16th frame. Phase keyframe_stepwise: DynamicFusion.run
# over KEYFRAME_STEPWISE_FRAMES frames, keyframes every 2nd and growth
# every 8th frame, a rigid KEYFRAME_DRIFT offset left-composed into the
# warp before the keyframe work of frame KEYFRAME_DRIFT_FRAME, and a
# save_state at frame KEYFRAME_SAVE_FRAME resumed in a fresh object.
# The main object is an ellipsoid (KEYFRAME_AXES, the main path's
# sphere's radius its largest): a sphere turns freely about its centre
# under depth-only association, and that unobservable turn took the JAX
# run's keyframe poses 50 degrees off by frame 48 (the main path's sphere
# here), so neither its trajectory nor its nodes' median could be held to
# anything. "Main nodes" are the nodes within KEYFRAME_MAIN_RADIUS (in
# units of the axes) of the ellipsoid's centre in canonical space.
# phases gn_solvers, gn_2d_depth and nicp_costs: the main path's sphere
# through run_fused(chunk=16) with each dense linear solver, with the
# 2d_depth data term (scripts/run_fusion.py's weights), and the N-ICP path
# with the chamfer cost on the JAX package's subsamples
# (reference/solvers_chamfer.npz); one full-width N-ICP solve with the
# rendered costs on the JAX package's frame-RENDERED_FRAME problem
# (reference/solvers_rendered.npz). The JAX results come from
# scripts/torch_solvers_reference.py.
GN_LINEAR_SOLVERS = ("cg", "schur", "ns")
GN_2D_DEPTH = dict(data_term="2d_depth", w_flow=1e-3, w_depth=1.0)
CHAMFER_NPZ = os.path.join(HERE, "reference", "solvers_chamfer.npz")
RENDERED_NPZ = os.path.join(HERE, "reference", "solvers_rendered.npz")
RENDERED_FRAME = 8
RENDERED_CONFIG = dict(iters=NICP_ITERS, w_silh=1.0, w_depth=100.0,
                       render_hw=(IMG_H, IMG_W))
RENDERED_TOL = 1e-4
CHAMFER_GRAD_TOL = 1e-5
# each solver's node translations against the dense Cholesky solve on the
# same GN input (m): the JAX suite's own tolerances between them
# (tests/test_gauss_newton_dense.py, tests/test_preconditioner.py)
GN_SOLVER_GAP_LIMITS = dict(cg=2e-4, schur=2e-4, ns=5e-4, pcg=3e-4)
GN_SOLVERS_REFERENCE = {
    "cg": dict(
        median_node_translation=[-1.0240559277008288e-05,
                                 0.00023174882517196238, 0.06656746566295624],
        n_correspondences=[8167, 8143, 8151, 8163, 8167, 8166, 8170, 8166,
                           8169, 8173, 8173, 8168, 8172, 8170, 8173, 8173]),
    "schur": dict(
        median_node_translation=[2.8531626412586775e-06, 0.0002059806720353663,
                                 0.06660155951976776],
        n_correspondences=[8167, 8143, 8151, 8163, 8168, 8166, 8170, 8166,
                           8169, 8173, 8173, 8168, 8172, 8170, 8173, 8171]),
    "ns": dict(
        median_node_translation=[9.23300176509656e-05, 0.00022511386487167329,
                                 0.06659025698900223],
        n_correspondences=[8167, 8144, 8151, 8162, 8168, 8166, 8170, 8166,
                           8170, 8173, 8173, 8168, 8171, 8173, 8173, 8172]),
}
GN_2D_DEPTH_REFERENCE = dict(
    median_node_translation=[8.508611063007265e-05, 8.475883078062907e-05,
                             0.06460542231798172],
    n_correspondences=[8167, 8154, 8154, 8137, 8123, 8125, 8124, 8077, 8030,
                       8000, 7967, 7954, 7859, 7862, 7824, 7746])
NICP_CHAMFER_WEIGHT = 1.0
# the JAX package's N-ICP path with the chamfer at NICP_CHAMFER_WEIGHT;
# against w_chamfer = 0 (NICP_REFERENCE_Z) it moves the median node by
# (-0.78, -0.02, -0.83) mm after 16 frames, where the card repeats the
# JAX result at w_chamfer = 0 within 0.05 mm. At w_chamfer 10 the chamfer
# drives the sphere sideways, (-8.94, 0.36, -1.31) mm in JAX, and the
# card's run leaves JAX's counts by 3.6% (PERF.md)
NICP_CHAMFER_REFERENCE = dict(
    median_node_translation=[-0.0006589040858671069, 0.0008478128002025187,
                             0.06823614984750748],
    n_correspondences=[8167, 8163, 8167, 8158, 8164, 8167, 8168, 8162, 8159,
                       8163, 8165, 8166, 8168, 8168, 8169, 8169])

# phase training: the recipes of the port's trainers on the JAX
# recipes' own batches (reference/training_batches.npz, the large float
# inputs rounded to float16) and JAX's results on them
# (TRAINING_REFERENCE, scripts/torch_training_reference.py, JAX on the
# CPU): the step-0 loss, terms and global gradient norm, the losses of
# TRAINING_STEPS optimiser steps on the one batch and the loss after them
TRAINING_NPZ = os.path.join(HERE, "reference", "training_batches.npz")
TRAINING_STEPS = 5
TRAINING_REFERENCE = {
 "flow": {
  "loss0": 1.3176207542419434,
  "terms0": {},
  "grad_norm0": 18.095304489135742,
  "losses": [
   1.3176207542419434,
   1.0938481092453003,
   0.9655405879020691,
   0.8965645432472229,
   0.8580402731895447
  ],
  "final": 0.8333513140678406
 },
 "tracking": {
  "loss0": 8.171183586120605,
  "terms0": {
   "flow": 1.5027827024459839,
   "graph": 0.007478741463273764,
   "mask": 0.5382667779922485,
   "warp": 0.052022889256477356
  },
  "grad_norm0": 230.31228637695312,
  "losses": [
   8.171183586120605,
   6.883746147155762,
   6.63418436050415,
   6.234538555145264,
   6.095746040344238
  ],
  "final": 6.12106466293335,
  "warp_mask_grad_norm": 0.08755742758512497
 },
 "motion": {
  "loss0": 10.434221267700195,
  "terms0": {},
  "grad_norm0": 89.36670684814453,
  "losses": [
   10.434221267700195,
   4.951197624206543,
   3.22519588470459,
   2.5069212913513184,
   1.9856269359588623
  ],
  "final": 1.7673120498657227
 },
 "lepard": {
  "loss0": 0.8880226612091064,
  "terms0": {},
  "grad_norm0": 2.273433208465576,
  "losses": [
   0.8880226612091064,
   0.8880226612091064,
   0.8822985291481018,
   0.8715787529945374,
   0.8572118282318115
  ],
  "final": 0.8411182761192322
 },
}
# the relative gap to JAX a recipe's readings (step-0 loss, terms and
# gradient norm, each step's loss and the final one) may take on the
# card: ten times the largest such gap of the port's run on the CPU
# against the same references (that gap in parentheses)
TRAINING_TOLS = {
    "flow": 1.73e-5,  # (1.73e-6, the trajectory)
    "tracking": 3.35e-5,  # (3.35e-6, the trajectory)
    "motion": 5.58e-4,  # (5.58e-5, the trajectory)
    "lepard": 5.35e-5,  # (5.35e-6, the gradient norm)
}
# the Functions' gradients through a 3-iteration solve against the plain
# twins' autograd, relative to each gradient's norm
TRAINING_FUNCTION_TOL = 1e-4
# the central difference of the solve's losses along a unit random
# MaskNet direction, against the analytic directional derivative
FD_STEP = 1e-2
FD_TOL = 3e-2
# train_flow.py --through_solver's solve: GN 3 iterations, w_arap 1
TRACKING_GN_ITERS = 3


KEYFRAME_FRAMES = 48
KEYFRAME_TURN = 24
KEYFRAME_AXES = (0.14, 0.10, 0.08)
KEYFRAME_SECOND = dict(radius=0.06, x0=0.72, dx=-0.05, x_stop=0.22)
KEYFRAME_MAIN_RADIUS = 1.3
KEYFRAME_GROWTH = 16
KEYFRAME_INTERVAL = 16
KEYFRAME_STEPWISE_FRAMES = 32
KEYFRAME_STEPWISE = dict(keyframe_interval=2, growth_interval=8)
KEYFRAME_DRIFT = (0.005, 0.0, 0.03)
KEYFRAME_DRIFT_FRAME = 10
KEYFRAME_SAVE_FRAME = 16
# the resumed runs register one frame, whose fused step is held to the
# uninterrupted run's: the same arguments bit for bit, and the same
# result bit for bit when both run again with torch's deterministic
# algorithms. Run as the loop runs it, N-ICP's scatter-adds take their
# atomics' order, and two eager runs from one state part by 1e-8-4e-5 m
# after a growth (ROADMAP F12): printed, not held
KEYFRAME_RESUME_CHECK_FRAME = 17
# the stepwise run is held to JAX exactly up to this frame: the first
# growth's counts and the loop closures of its keyframes
KEYFRAME_STEPWISE_EXACT = 14
# the JAX package's runs on the CPU (scripts/torch_keyframe_reference.py),
# the fields the checks read: the keyframe poses up to the first growth
KEYFRAME_REFERENCE = {
    'growth': [{'frame': 16, 'n_new_nodes': 11, 'n_new_bricks': 223},
               {'frame': 32, 'n_new_nodes': 39, 'n_new_bricks': 198},
               {'frame': 48, 'n_new_nodes': 37, 'n_new_bricks': 15}],
    'nodes': 109,
    'active_bricks': 792,
    'main_median_translation': [-0.002597264014184475, -0.005206703674048185,
                                -0.014102970249950886],
    'trajectory': {'frames': [0, 16, 32, 48],
                   'R': [[[1.000000238418579, -1.0175351672359056e-09,
                           2.0950672308117646e-09],
                          [-1.2064008680923166e-09, 1.0,
                           1.320751010780441e-07],
                          [-1.8586510108775656e-09, -1.363274293453287e-07,
                           1.000000238418579]],
                         [[0.999923825263977, -0.00032762085902504623,
                           -0.012358812615275383],
                          [1.009058814815944e-05, 0.9996703267097473,
                           -0.025683943182229996],
                          [0.01236313208937645, 0.025681927800178528,
                           0.9995944499969482]]],
                   't': [[-5.9371814131736755e-09, -3.8940925151109695e-07,
                          -7.152557373046875e-07],
                         [0.03680881857872009, 0.07584566622972488,
                          0.0641326904296875]]},
    'keyframes': [{'frame': 16, 'loop_closures': 0},
                  {'frame': 32, 'loop_closures': 0},
                  {'frame': 48, 'loop_closures': 0}],
    'n_correspondences': [5032, 4968, 4945, 4913, 4866, 4829, 4808, 4798, 4772,
                          4773, 4784, 4784, 4763, 4744, 4723, 4732, 4608, 4688,
                          4726, 4756, 4764, 4772, 4770, 4784, 4814, 4880, 4957,
                          5005, 5016, 5024, 5029, 5040, 5045, 5041, 5039, 5042,
                          5046, 5054, 5057, 5057, 5059, 5058, 5054, 5054, 5057,
                          5054, 5059, 5063],
}

KEYFRAME_STEPWISE_REFERENCE = {
    'growth': [{'frame': 8, 'n_new_nodes': 8, 'n_new_bricks': 99},
               {'frame': 16, 'n_new_nodes': 26, 'n_new_bricks': 221},
               {'frame': 24, 'n_new_nodes': 52, 'n_new_bricks': 166},
               {'frame': 32, 'n_new_nodes': 8, 'n_new_bricks': 6}],
    'nodes': 116,
    'active_bricks': 848,
    'main_median_translation': [0.002559454645961523, 0.003112711478024721,
                                0.05535745620727539],
    'trajectory': {'frames': [0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24,
                              26, 28, 30, 32],
                   'R': [],
                   't': []},
    'keyframes': [{'frame': 2, 'loop_closures': 0},
                  {'frame': 4, 'loop_closures': 0},
                  {'frame': 6, 'loop_closures': 0},
                  {'frame': 8, 'loop_closures': 0},
                  {'frame': 10, 'loop_closures': 1},
                  {'frame': 12, 'loop_closures': 2},
                  {'frame': 14, 'loop_closures': 3},
                  {'frame': 16, 'loop_closures': 0},
                  {'frame': 18, 'loop_closures': 0},
                  {'frame': 20, 'loop_closures': 0},
                  {'frame': 22, 'loop_closures': 0},
                  {'frame': 24, 'loop_closures': 0},
                  {'frame': 26, 'loop_closures': 1},
                  {'frame': 28, 'loop_closures': 0},
                  {'frame': 30, 'loop_closures': 0},
                  {'frame': 32, 'loop_closures': 0}],
    'n_correspondences': [5032, 4968, 4945, 4913, 4866, 4829, 4808, 4798, 4703,
                          4719, 4626, 4662, 4699, 4734, 4755, 4762, 4744, 4739,
                          4734, 4730, 4686, 4666, 4649, 4665, 4717, 4707, 4698,
                          4704, 4725, 4733, 4778, 4802],
    'drift': {'before': 0.030407674610614777,
              'after': 0.005094711668789387,
              'pose_correction': 0.15082713589072227},
}

# Phase keyframe_growth_case: keyframe_path's growth keyframe at
# KEYFRAME_CASE_FRAME as a fixed input (KEYFRAME_CASE_NPZ, written by
# scripts/torch_keyframe_reference.py growth_case: the state entering
# that growth in the JAX package's run_fused, its canonical TSDF as int16
# on a 1/KEYFRAME_CASE_TSDF_Q grid, and JAX's results on exactly that
# input): the growth's counts, brick table and edges equal to JAX's, its
# nodes and the grown warp within KEYFRAME_CASE_NODE_TOL; then the next
# frame's step captured on the rebuilt tables and replayed: the
# correspondences within NICP_CORRESPONDENCE_TOL of JAX's, the median
# node within STEP_MEDIAN_LIMIT (or 3x the same step's graph-vs-graph or
# graph-vs-eager median gap on the card, where that is larger) and the
# STEP_PERCENTILE-th percentile within STEP_PERCENTILE_LIMITS (or 3x the
# same gaps), as the main path's step checks hold a step (F5)
KEYFRAME_CASE_FRAME = 32
KEYFRAME_CASE_NPZ = os.path.join(HERE, "reference", "keyframe_growth.npz")
KEYFRAME_CASE_TSDF_Q = 32767.0
KEYFRAME_CASE_NODE_TOL = 1e-5

# After the first growth the keyframe runs are chaotic on the card
# itself: the grown nodes anchor no model point, so only ARAP and the
# motion prior hold them, and the atomics' rounding in N-ICP's backward
# grows into different node sets at the next growth (ROADMAP F12). Those
# readings are held within these limits of JAX's: three times the
# largest gap between the card's own runs of the same input (NVIDIA H100
# 80GB HBM3, 700.00 W; keyframe_path 2 runs, keyframe_stepwise 4 runs):
# new nodes and bricks of a later growth, final node and brick counts,
# the main nodes' median translation (m, any axis), and the largest
# relative gap of a later frame's correspondences
KEYFRAME_SPREAD_LIMITS = {
    "keyframe_path": dict(growth_nodes=96, growth_bricks=417, nodes=96,
                          active_bricks=423, main_median_m=0.0191,
                          correspondences=0.0227),
    "keyframe_stepwise": dict(growth_nodes=135, growth_bricks=435,
                              nodes=153, active_bricks=435,
                              main_median_m=0.0121, correspondences=0.128),
}

# the perception phases: the headline's settings (headline_config) on
# the textured sphere at 1 m moving PERCEPTION["step"] a frame in z and
# PERCEPTION["lateral"] in x (~4.4 px of flow a frame), with Lepard from
# checkpoints/lepard_bridge_r5e.npz (the 512-anchor pyramid) with its
# coherence filter on at tau 0.06, lepard_every 2. Phase `perception`
# (run_fused, chunk 16): flow_mode "advect". Phase `perception_stepwise`
# (DynamicFusion.run): flow_mode "override" with PWC at 1/2 and
# patchwise NMS in 4x4 patches (the dense lift), the matcher with
# batched_encode. Phase `perception_f32`: phase `perception` with PWC and
# MaskNet in f32. The JAX package's results on the CPU
# (scripts/torch_perception_reference.py; PERCEPTION_REFERENCE,
# PERCEPTION_STEPWISE_REFERENCE, PERCEPTION_F32_REFERENCE): the median
# node translation after the first frame (each axis within 2 mm on the
# card) and after PERCEPTION_FRAMES frames, and each frame's
# correspondences and Lepard matches (0 on the frames the gate skips;
# within the *_TOL fractions of JAX's on its stable_frames, the frames
# every JAX run reproduces), of JAX's run and of its runs on the depth
# scaled by 1 + eps for each eps in PERCEPTION_ENSEMBLE, whose range
# check_perception widens and holds the port's runs to
PERCEPTION = dict(step=0.004, lateral=0.003, lepard_every=2,
                  lepard="lepard_bridge_r5e.npz", coherence_tau=0.06)
PERCEPTION_FRAMES = 16
PERCEPTION_ENSEMBLE = (1e-6, -1e-6, 2e-6, -2e-6)
# the JAX matcher on its own inputs (phase `perception_matcher`): at each
# frame where the matcher ran in the two perception runs of
# scripts/torch_perception_reference.py, the valid source (deformed
# model) and target (depth subsample) points on a grid of
# MATCHER_QUANTUM m about the case's origin (int16), and JAX's
# scene_flow on exactly those points: the matched anchors before and
# after the coherence filter, the blend mask, and the blended flow at
# every MATCHER_FLOW_STRIDE-th source point
MATCHER_CASES = os.path.join(HERE, "reference", "perception_matcher.npz")
MATCHER_QUANTUM = 1e-5
MATCHER_FLOW_STRIDE = 16
# the card's matcher against those results: the anchors and the blend
# mask equal, the flows within MATCHER_FLOW_TOL m
MATCHER_FLOW_TOL = 1e-4
PERCEPTION_REFERENCE = dict(
    first_frame_median_node_translation=[
        0.00024267646949738264,
        0.00029663051827810705,
        0.0011497221421450377],
    median_node_translation=[
        0.011043712496757507,
        -0.0022857896983623505,
        0.06202401965856552],
    ensemble_median_node_translation=[
        [0.01861779, -0.004526392, 0.060144655],
        [0.011044224, -0.00228587, 0.062025491],
        [0.025071323, 0.006989501, 0.066650458],
        [0.025634438, 0.003056654, 0.064987913],
    ],
    n_correspondences=[
        4440, 4576, 4574, 4576, 4535, 4576, 4430, 4576, 4304, 4576, 4566,
        4576, 4547, 4576, 4541, 4557
    ],
    n_lepard_matches=[
        0, 4576, 0, 4407, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0,
        999
    ],
    stable_frames=[
        1, 2, 12
    ],
    ensemble_n_correspondences=[
        [
            4440, 4576, 4571, 4576, 4497, 4556, 3911, 4531, 4503, 4531,
            4474, 4576, 4316, 4463, 4367, 4576
        ],
        [
            4440, 4576, 4574, 4576, 4535, 4576, 4430, 4576, 4304, 4576,
            4566, 4576, 4547, 4576, 4541, 4557
        ],
        [
            4440, 4575, 4439, 4576, 4357, 4576, 4416, 4534, 4443, 4576,
            4533, 4576, 4501, 4576, 4238, 4553
        ],
        [
            4440, 4576, 4574, 4576, 4535, 4576, 4430, 4576, 4304, 4574,
            4557, 4576, 4422, 4576, 4450, 4539
        ],
    ],
    ensemble_n_lepard_matches=[
        [
            0, 4576, 0, 4576, 0, 4531, 0, 3721, 0, 4505, 0, 4576, 0, 4393,
            0, 4576
        ],
        [
            0, 4576, 0, 4407, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576,
            0, 999
        ],
        [
            0, 4575, 0, 4536, 0, 4575, 0, 4409, 0, 4576, 0, 4576, 0, 4576,
            0, 4003
        ],
        [
            0, 4576, 0, 4407, 0, 4576, 0, 4576, 0, 4563, 0, 4576, 0, 4575,
            0, 4465
        ],
    ],
)
PERCEPTION_STEPWISE_REFERENCE = dict(
    first_frame_median_node_translation=[
        -0.0003951027465518564,
        -0.0011894421186298132,
        0.0033573568798601627],
    median_node_translation=[
        0.028813572600483894,
        -0.0033723032101988792,
        0.05770719796419144],
    ensemble_median_node_translation=[
        [0.028173026, 0.002931225, 0.057723753],
        [0.027462535, 0.006190519, 0.066578589],
        [0.026392374, 0.006904104, 0.056939926],
        [0.02583921, 0.005012683, 0.053871099],
    ],
    n_correspondences=[
        4442, 4558, 4430, 4572, 4484, 4576, 4109, 4285, 4074, 4576, 4262,
        4559, 3977, 4393, 4310, 4576
    ],
    n_lepard_matches=[
        0, 4162, 0, 4534, 0, 4576, 0, 3742, 0, 4576, 0, 4558, 0, 4383, 0,
        4576
    ],
    stable_frames=[
        1, 2, 3, 10, 12
    ],
    ensemble_n_correspondences=[
        [
            4442, 4558, 4433, 4576, 4543, 4567, 4571, 4570, 4535, 4576,
            4509, 4576, 4551, 4559, 4474, 4554
        ],
        [
            4442, 4558, 4430, 4572, 4484, 4576, 4108, 4567, 4205, 4576,
            4177, 4576, 3943, 4576, 3973, 4565
        ],
        [
            4442, 4558, 4427, 4575, 4496, 4576, 4573, 4576, 4425, 4576,
            4433, 4576, 4331, 4576, 3904, 4067
        ],
        [
            4442, 4558, 4430, 4572, 4484, 4576, 4108, 4567, 4209, 4576,
            4352, 4576, 4455, 4576, 4570, 4576
        ],
    ],
    ensemble_n_lepard_matches=[
        [
            0, 4162, 0, 4576, 0, 3637, 0, 4525, 0, 4576, 0, 4576, 0, 4558,
            0, 4554
        ],
        [
            0, 4162, 0, 4534, 0, 4576, 0, 4567, 0, 4557, 0, 4576, 0, 4576,
            0, 4565
        ],
        [
            0, 4163, 0, 4575, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4566,
            0, 3656
        ],
        [
            0, 4162, 0, 4534, 0, 4576, 0, 4567, 0, 4576, 0, 4576, 0, 4576,
            0, 4576
        ],
    ],
)
PERCEPTION_F32_REFERENCE = dict(
    first_frame_median_node_translation=[
        0.00021773751359432936,
        0.0002971009525936097,
        0.0011844292748719454],
    median_node_translation=[
        0.02406029775738716,
        0.007542803417891264,
        0.05435868725180626],
    ensemble_median_node_translation=[
        [0.02332324, 0.001186368, 0.064925909],
        [0.024060167, 0.007543015, 0.054358512],
        [0.013507223, -0.003972258, 0.061512709],
        [0.024060141, 0.007543142, 0.054358572],
    ],
    n_correspondences=[
        4440, 4576, 4572, 4576, 4568, 4576, 4486, 4576, 4459, 4576, 4397,
        4576, 4343, 4576, 4313, 4576
    ],
    n_lepard_matches=[
        0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4573, 0,
        4454
    ],
    stable_frames=[
        1, 2, 4, 6, 10, 14
    ],
    ensemble_n_correspondences=[
        [
            4440, 4576, 4572, 4576, 4574, 4576, 4478, 4576, 4288, 4576,
            4321, 4576, 4388, 4576, 4527, 4512
        ],
        [
            4440, 4576, 4572, 4576, 4568, 4576, 4486, 4576, 4459, 4576,
            4397, 4576, 4343, 4576, 4313, 4576
        ],
        [
            4440, 4576, 4454, 4576, 4275, 4576, 4409, 4345, 4281, 4576,
            4552, 4563, 4478, 4576, 4372, 4576
        ],
        [
            4440, 4576, 4572, 4576, 4568, 4576, 4486, 4576, 4459, 4576,
            4397, 4576, 4343, 4576, 4313, 4576
        ],
    ],
    ensemble_n_lepard_matches=[
        [
            0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576,
            0, 4485
        ],
        [
            0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4573,
            0, 4454
        ],
        [
            0, 4576, 0, 4576, 0, 4576, 0, 3342, 0, 4576, 0, 4527, 0, 4576,
            0, 4576
        ],
        [
            0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4576, 0, 4573,
            0, 4454
        ],
    ],
)
# each kernel's __global__ function, as the profiler names it
KERNEL_SYMBOLS = {"knn": "knn_kernel", "lbs_warp": "lbs_kernel",
                  "point_term_blocks": "point_term_accumulate_kernel",
                  "arap_term_blocks": "arap_term_accumulate_kernel"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sphere_sequence(n_frames, h, w, r, step, distance=1.0, textured=False,
                    lateral=0.0):
    """Analytic deforming-sphere RGB-D sequence (a sphere receding along
    the optical axis by ``step`` a frame and moving ``lateral`` a frame in
    x, ray-cast in closed form), flat grey or with a smooth RGB texture
    fixed to its surface (a function of the surface normal) for optical
    flow to follow."""
    import numpy as np

    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    intr = Intrinsics(2.3 * w, 2.3 * w, w / 2, h / 2)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy,
                  np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depths, colors, centers = [], [], []
    for i in range(n_frames):
        c = np.array([0.0, 0.0, distance]) + np.array([lateral, 0.0, step]) * i
        b = d @ c
        disc = b * b - (c @ c - r * r)
        t = b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (t > 0)
        depth = np.where(hit, t * d[..., 2], 0.0)
        depths.append(depth.astype(np.float32))
        color = np.full((h, w, 3), 128.0)
        if textured:
            n = (t[..., None] * d - c) / r
            tex = np.stack([np.sin(12 * n[..., 0] + 3 * n[..., 1]),
                            np.sin(10 * n[..., 1] - 5 * n[..., 2]),
                            np.sin(9 * n[..., 2] + 7 * n[..., 0])], -1)
            color = np.where(hit[..., None], 128 + 100 * tex, 128.0)
        colors.append(color.astype(np.float32))
        centers.append(c)
    return ArraySequence(colors, depths, intr), centers


def cuda_ms(fn, reps: int, trials: int = 5):
    """Device milliseconds per call: ``trials`` timings of ``reps`` calls
    each (CUDA events, after one warm-up call). Returns the median trial
    and the fastest and slowest ones."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def graph_ms(fn, reps: int, trials: int = 5):
    """Device milliseconds per call with no host time between calls:
    ``reps`` calls captured once into a CUDA graph (after one warm-up
    call), the graph replayed ``trials`` times (CUDA events, after one
    warm-up replay). Returns the median trial and the fastest and
    slowest ones, per call. For functions whose host work (the
    wrappers' checks and launch) outlasts their device work, which
    ``cuda_ms`` then measures instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    med, lo, hi = cuda_ms(graph.replay, 1, trials)
    del graph
    return med / reps, lo / reps, hi / reps


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k12_random_inputs(dev):
    """K1's and K2's inputs of the kernel phase, made from SEED: P = VOL^3
    voxel centres drawn uniformly in the volume, N = MAX_NODES random
    nodes of which the first 300 are valid, 80% of the voxels valid, a
    random rotation and translation per node. Returns the generator (the
    GN inputs draw on from it) and the tensors."""
    import torch

    from occlusionfusion_tpu_torch.geometry.so3 import so3_exp

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    extent = VOL * VOXEL
    P, N = VOL ** 3, MAX_NODES
    q = (rand(P, 3) - 0.5) * extent + torch.tensor([0, 0, 1.0], device=dev)
    nodes = (rand(N, 3) - 0.5) * 0.3 + torch.tensor([0, 0, 1.0], device=dev)
    node_valid = torch.arange(N, device=dev) < 300
    vox_valid = rand(P) > 0.2
    R = so3_exp((rand(N, 3) - 0.5) * 0.4)
    t = (rand(N, 3) - 0.5) * 0.05
    return gen, q, nodes, node_valid, vox_valid, R, t


def knn_row(label, q, nodes, node_valid):
    """K1 against its twin on one input: d2 within 1e-5, anchor sets equal
    apart from refs at equal distance, no invalid anchor, and the count of
    rows whose d2 or indices are not bit-identical to the twin's; timed
    (ms: device time from a CUDA graph; call_ms: back to back through the
    wrapper) with the bound of this input: P x N_valid x 7 flop (the refs
    a valid mask leaves), or its bytes. Returns the row and the twin's
    (d2, idx). Uses only the public knn_cuda / knn_torch signatures."""
    import torch

    from occlusionfusion_tpu_torch.ops import knn

    P, N, K = q.shape[0], nodes.shape[0], 4
    d2_k, idx_k = knn.knn_cuda(q, nodes, K, node_valid)
    d2_t, idx_t = knn.knn_torch(q, nodes, K, node_valid)
    torch.cuda.synchronize()
    err_d2 = float((d2_k - d2_t).abs().max())
    not_bitwise = int(((d2_k != d2_t).any(1) | (idx_k != idx_t).any(1)).sum())
    set_diff = torch.any(
        torch.sort(idx_k, 1)[0] != torch.sort(idx_t, 1)[0], dim=1
    )
    n_set_diff = int(set_diff.sum())
    if n_set_diff:
        # sets may differ only among refs at equal distance
        rowsel = torch.nonzero(set_diff)[:, 0]
        qq = q[rowsel].double()
        true_k = ((nodes.double()[idx_k[rowsel].long()] - qq[:, None]) ** 2).sum(-1)
        true_t = ((nodes.double()[idx_t[rowsel].long()] - qq[:, None]) ** 2).sum(-1)
        tie_err = float((torch.sort(true_k, 1)[0] - torch.sort(true_t, 1)[0]).abs().max())
        assert tie_err <= 1e-5, (
            f"K1 ({label}) anchor sets differ beyond ties: {tie_err}")
    assert err_d2 <= 1e-5, f"K1 ({label}) d2 error {err_d2}"
    assert bool(node_valid[idx_k.long()].all()), (
        f"K1 ({label}) picked an invalid ref")
    del d2_k, idx_k
    ms, ms_lo, ms_hi = graph_ms(lambda: knn.knn_cuda(q, nodes, K, node_valid),
                                10)
    call = cuda_ms(lambda: knn.knn_cuda(q, nodes, K, node_valid), 10)[0]
    plain = cuda_ms(lambda: knn.knn_torch(q, nodes, K, node_valid), 1, 3)[0]
    n_valid = int(node_valid.sum())
    b, by = bound_ms(P * 12 + N * 13 + P * K * 8, P * n_valid * 7)
    row = dict(
        name="knn", route="cuda",
        source="occlusionfusion_tpu_torch/csrc/knn.cu",
        replaces="occlusionfusion_tpu/ops/knn.py:100",
        max_abs_err=err_d2, ms=ms, ms_min=ms_lo, ms_max=ms_hi, call_ms=call,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        input=label, P=P, N=N, N_valid=n_valid,
        # the bound counted over all N refs at 9 flop a pair (PR 4-6)
        bound_ms_all_refs=bound_ms(0, P * N * 9)[0],
        rows_not_bit_identical=not_bitwise,
        anchor_set_rows_differing=n_set_diff,
    )
    return row, (d2_t, idx_t)


def lbs_row(label, points, anchors, weights, valid, warp):
    """K2 against its twin on one input: valid points within 2e-4 m,
    invalid ones passed through bit for bit; timed as knn_row does, with
    the bound of this input: 25 bytes per point, 32 more per valid one,
    and the node table. Uses only the public lbs_warp_cuda /
    lbs_warp_torch signatures."""
    import torch

    from occlusionfusion_tpu_torch.ops import lbs

    P, N, K = points.shape[0], warp.node_positions.shape[0], 4
    args = (points, anchors, weights, valid, warp)
    y_k = lbs.lbs_warp_cuda(*args)
    y_t = lbs.lbs_warp_torch(*args)
    torch.cuda.synchronize()
    err = float((y_k - y_t).abs().max())
    assert err <= 2e-4, f"K2 ({label}) error {err} m"
    assert torch.equal(y_k[~valid], points[~valid]), (
        f"K2 ({label}) changed an invalid point")
    del y_k, y_t
    ms, ms_lo, ms_hi = graph_ms(lambda: lbs.lbs_warp_cuda(*args), 50)
    call = cuda_ms(lambda: lbs.lbs_warp_cuda(*args), 50)[0]
    plain = cuda_ms(lambda: lbs.lbs_warp_torch(*args), 5)[0]
    n_valid = int(valid.sum())
    b, by = bound_ms(P * 25 + n_valid * K * 8 + N * 60,
                     n_valid * (K * 24 + 18))
    return dict(
        name="lbs_warp", route="cuda",
        source="occlusionfusion_tpu_torch/csrc/lbs.cu",
        replaces="occlusionfusion_tpu/ops/lbs.py:89",
        max_abs_err=err, ms=ms, ms_min=ms_lo, ms_max=ms_hi, call_ms=call,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        input=label, P=P, N=N, valid_points=n_valid,
        valid_share=n_valid / P,
        # every point's anchors and weights counted (PR 4-6)
        bound_ms_all_points=bound_ms(
            P * (12 + K * 4 + K * 4 + 1 + 12) + N * 48, 0)[0],
    )


def k12_random_rows(dev):
    """K1 and K2 on the kernel phase's random input (K2 through the
    twin's anchors, so that every tree gets the same input). Returns the
    rows, the generator and the tensors the GN inputs are built from."""
    import torch

    from occlusionfusion_tpu_torch.fusion.warpfield import WarpFieldState

    gen, q, nodes, node_valid, vox_valid, R, t = k12_random_inputs(dev)
    knn_r, (d2, idx) = knn_row("random", q, nodes, node_valid)
    sigma2 = 0.05 ** 2
    w = torch.exp(-d2 / (2 * sigma2))
    w = w / (w.sum(-1, keepdim=True) + 1e-6)
    warp = WarpFieldState(nodes, node_valid, R, t)
    lbs_r = lbs_row("random", q, idx, w, vox_valid, warp)
    return [knn_r, lbs_r], gen, (q, nodes, idx, w, R, t)


def phase_kernels(dev):
    """Each kernel against its twin at the main path's shapes."""
    import torch

    rows, gen, (q, nodes, idx_k, w, R, t) = k12_random_rows(dev)
    for r in rows:
        emit({"phase": "kernel", **r})

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    N, K = MAX_NODES, 4

    # K3' and K4' on random inputs: fractional point weights; 8 edge
    # slots per node, a fifth of them invalid (index -1 clamped to 0,
    # weight 0); a motion prior on a random two thirds of the nodes
    P, E = MAX_POINTS, 8
    pts = q[:P].contiguous()
    point_args = (pts, pts + (rand(P, 3) - 0.5) * 0.01, 0.3 + 0.7 * rand(P),
                  idx_k[:P].contiguous(), w[:P].contiguous(), nodes, R, t,
                  1.0)
    edges = torch.randint(0, N, (N, E), generator=gen, device=dev,
                          dtype=torch.int32)
    invalid = rand(N, E) < 0.2
    ew = rand(N, E)
    wa = torch.sqrt(2.0 * torch.where(invalid, torch.zeros_like(ew), ew))
    edges = torch.where(invalid, torch.zeros_like(edges), edges)
    wm = rand(N) * (rand(N) < 0.67)
    arap_args = (nodes, R, t, edges, wa, wm, nodes + (rand(N, 3) - 0.5) * 0.01)
    gn_rows = gn_kernel_rows("random", point_args, arap_args)
    emit({"phase": "kernel", "input": "random", "invalid_edge_slots":
          int(invalid.sum()), "rows": gn_rows})
    rows.extend(gn_rows)
    # K3' where few points share an anchor pair: 4 distinct anchors per
    # point drawn uniformly from all N nodes (the random input above takes
    # them from the voxels' k-NN, where ~30 points share each pair); K3'
    # holds M's entries with atomics, and this shows what their contention
    # costs
    spread = torch.argsort(rand(P, N), dim=1)[:, :K].to(torch.int32)
    emit({"phase": "kernel", "input": "spread", "rows": gn_kernel_rows(
        "spread", point_args[:3] + (spread.contiguous(),) + point_args[4:])})
    # K3' with the 2d_depth rows: the random input 2.5 m in front of the
    # camera, the main path's intrinsics, scripts/run_fusion.py's weights
    off = torch.tensor([0.0, 0.0, 2.5], device=dev)
    two_d = (point_args[0] + off, point_args[1] + off) + point_args[2:5] + (
        nodes + off,) + point_args[6:]
    rows_2d = gn_kernel_rows("random_2d_depth", two_d,
                             proj=main_path_projection())
    emit({"phase": "kernel", "input": "random_2d_depth", "rows": rows_2d})
    del q, idx_k, w
    torch.cuda.empty_cache()
    return rows


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def gn_kernel_rows(label, point_args, arap_args=None, proj=None):
    """K3' (point term; the 2d_depth rows with ``proj`` = (fx, fy, sf,
    sd)) and, given its arguments, K4' (ARAP term + motion
    prior) against their accumulating twins on (M, b, sq) from zero,
    within 5e-5 relative, then timed accumulating into the same system
    (ms: device time from a CUDA graph of 100 launches; call_ms: one call
    after another through the wrapper, host checks included); each with
    the bound of these inputs: every input byte read once, the touched
    blocks of M (unique anchor pairs x 144 B; the valid edges' 24
    non-zero entries and the N diagonal blocks) plus b and sq written
    once."""
    import torch

    from occlusionfusion_tpu_torch.ops import gn_assembly as GA

    nodes = point_args[5]
    N = nodes.shape[0]
    dev = nodes.device

    def system():
        return (torch.zeros((6 * N, 6 * N), device=dev),
                torch.zeros(6 * N, device=dev), torch.zeros((), device=dev))

    rows = []
    kernels = [("point_term_blocks", GA.point_term_accumulate_cuda,
                GA.point_term_accumulate_torch, point_args, "gn_assembly.cu",
                "occlusionfusion_tpu/ops/gn_assembly.py:151")]
    if arap_args is not None:
        kernels.append(("arap_term_blocks", GA.arap_term_accumulate_cuda,
                        GA.arap_term_accumulate_torch, arap_args,
                        "arap_term.cu",
                        "occlusionfusion_tpu/ops/gn_assembly.py:317"))
    for name, kernel, twin, args, src, replaces in kernels:
        got, ref = system(), system()
        if name == "point_term_blocks":
            kernel = functools.partial(kernel, proj=proj)
            twin = functools.partial(twin, proj=proj)
        kernel(*args, *got)
        twin(*args, *ref)
        torch.cuda.synchronize()
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        err64 = None
        if proj is not None and name == "point_term_blocks":
            # b of the 2d_depth rows: at a converged state the rows are
            # sub-pixel differences of projections hundreds of pixels
            # large, so one f32 ulp of a warped point (2.4e-7 m at 3 m,
            # ~1.2e-4 px) is a visible share of b, in the kernel and in
            # the twin alike; both are held to the same system in f64
            ref64 = tuple(x.double() for x in system())
            twin(*(a.double() if torch.is_tensor(a) and a.is_floating_point()
                   else a for a in args), *ref64)
            err64 = {"kernel": rel_err(got[1].double(), ref64[1]),
                     "twin": rel_err(ref[1].double(), ref64[1])}
            assert max(errs[0], errs[2]) <= 5e-5, (label, name, errs)
            assert err64["kernel"] <= max(5e-5, 2 * err64["twin"]), (
                label, name, errs, err64)
        else:
            assert max(errs) <= 5e-5, (label, name, errs)
        max_abs = float((got[0] - ref[0]).abs().max())
        ms, ms_lo, ms_hi = graph_ms(lambda: kernel(*args, *got), 100)
        # per call through the wrapper, host checks and launch included
        call = cuda_ms(lambda: kernel(*args, *got), 200)[0]
        plain = cuda_ms(lambda: twin(*args, *ref), 20)[0]
        out_bytes = 4 * (6 * N + 1)
        if name == "point_term_blocks":
            pts, _, pv, anchors, weights = args[:5]
            P = pts.shape[0]
            wg = weights * pv[:, None]
            live = (wg[:, :, None] * wg[:, None, :]) != 0
            keys = anchors.long()[:, :, None] * N + anchors.long()[:, None, :]
            work = int(torch.unique(keys[live]).numel())
            live_pts = int((wg != 0).any(1).sum())
            in_bytes = P * (12 + 12 + 4 + 16 + 16) + N * 60
            out_bytes += work * 144
            # per live point: local frames, warp, residual and b (~180
            # flops), then ~110 per anchor pair (block entries and adds);
            # the 2d_depth rows: ~40 more a point (projection, G, C,
            # G^T r) and ~60 more a pair (the rows through C)
            flops = live_pts * (180 + 16 * 110)
            if proj is not None:
                flops += live_pts * (40 + 16 * 60)
            extra = {"unique_pairs": work, "live_points": live_pts,
                     "data_term": "point3d" if proj is None else "2d_depth"}
        else:
            E = args[3].shape[1]
            valid = int((args[4] != 0).sum())
            in_bytes = N * 60 + N * E * 8 + N * 16
            out_bytes += valid * 24 * 4 + N * 36 * 4
            # per edge slot: rotation, residual and the node sums (~80
            # flops), 24 adds per valid edge, ~60 per node to expand M[i, i]
            flops = N * E * 80 + valid * 24 + N * 60
            extra = {"valid_edges": valid, "E": E}
        b, by = bound_ms(in_bytes + out_bytes, flops)
        rows.append(dict(
            name=name, route="cuda",
            source=f"occlusionfusion_tpu_torch/csrc/{src}", replaces=replaces,
            max_abs_err=max_abs, ms=ms, ms_min=ms_lo, ms_max=ms_hi,
            call_ms=call, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=None, input=label, N=N, rel_err_M=errs[0],
            rel_err_b=errs[1], rel_err_sq=errs[2], rel_err_b_f64=err64,
            **extra,
        ))
    return rows


def profiled(enabled):
    import contextlib

    if not enabled:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def report_profile(prof, wall_s, path, frames):
    """Device time by kernel name over the traced window of ``frames``
    frames, the share of the window the device was busy (sum of kernel
    times / wall), and the device ops (kernels, fills, copies) per
    frame."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpy, memset); the aten::
        # host ops that launched them carry the same time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0)
        if dt > 0:
            rows.append((dt, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    emit({"phase": "profile", "path": path, "window_s": wall_s,
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall_s,
          "device_ops_per_frame": sum(r[2] for r in rows) / frames,
          "top": [{"name": k[:80], "ms": dt / 1e3, "calls": c}
                  for dt, k, c in rows[:25]]})


def sphere_config(vol=VOL, voxel=VOXEL, max_points=MAX_POINTS, **kw):
    """The main path's FusionConfig: dense vol^3 grid, 512-node cap, dense
    Gauss-Newton (4 iterations, w_point 1, w_arap 2, w_motion 1,
    Cholesky) and the motion GNN; ``kw`` overrides fields (the envelope's
    bricks and flow)."""
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

    fields = dict(
        vol_dim=(vol, vol, vol), voxel_size=voxel, node_coverage=COVERAGE,
        max_nodes=MAX_NODES, max_points=max_points, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=COVERAGE, min_neighbors=2),
        solver="gn_dense",
        gn=GNConfig(iters=GN_ITERS, w_point=1.0, w_arap=2.0, w_motion=1.0,
                    linear_solver="cholesky"),
        brick_size=0,
    )
    fields.update(kw)
    return FusionConfig(**fields)


def envelope_config():
    """The reference envelope (bench.py's docstring) on the main path's
    sphere: the bricked 128^3 volume (brick_size -1 resolves to 8 there,
    1024 slots) and PWC flow + MaskNet at the JAX defaults."""
    return sphere_config(brick_size=-1, max_bricks=ENVELOPE_MAX_BRICKS,
                         use_flow=True)


def headline_config(vol=HEADLINE["vol"], voxel=HEADLINE["voxel"],
                    max_points=HEADLINE["max_points"],
                    max_bricks=HEADLINE["max_bricks"],
                    lepard_targets=HEADLINE["lepard_targets"]):
    """bench.py's ENVELOPE_ENV FusionConfig (brick 8, GN 2 iterations with
    w_point 1, w_arap 2, w_motion 1 and Cholesky, node coverage 0.05, the
    sparse flow lift in bf16 with MaskNet at 1/2, Lepard strided)."""
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

    cov = HEADLINE["coverage"]
    return FusionConfig(
        vol_dim=(vol, vol, vol), voxel_size=voxel, node_coverage=cov,
        max_nodes=HEADLINE["max_nodes"], max_points=max_points,
        max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=cov, min_neighbors=2),
        solver="gn_dense",
        gn=GNConfig(iters=HEADLINE["gn_iters"], w_point=1.0, w_arap=2.0,
                    w_motion=1.0, linear_solver="cholesky"),
        brick_size=8, max_bricks=max_bricks, use_flow=True,
        flow_lift="sparse", flow_bf16=True, mask_downscale=2,
        use_lepard=True, lepard_max_target_points=lepard_targets,
        lepard_subsample="strided",
    )


def headline_nets(dev, lepard=True):
    """The headline's nets: motion GNN, (PWC, MaskNet) and, with
    ``lepard``, Lepard from checkpoints/lepard_trained.npz."""
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_flow_nets,
        load_lepard_checkpoint,
        load_motion_complete_net,
    )

    pwc, mask = load_flow_nets(device=dev)
    nets = dict(flow_net=pwc, mask_net=mask)
    if lepard:
        nets["lepard_net"] = load_lepard_checkpoint(device=dev)[0]
    return load_motion_complete_net(device=dev), nets


def perception_config(stepwise=False, bf16=True):
    """The headline's FusionConfig with phase `perception`'s changes
    (flow_mode "advect", lepard_every 2; without ``bf16``, phase
    `perception_f32`'s: PWC and MaskNet in f32) or, with ``stepwise``,
    phase `perception_stepwise`'s (flow_mode "override", PWC at 1/2,
    patchwise NMS in 4x4 patches, which take the dense f32 lift,
    lepard_every 2)."""
    import dataclasses

    flow = (dict(flow_mode="override", flow_downscale=2, flow_mask_patch=4)
            if stepwise else dict(flow_mode="advect", flow_bf16=bf16))
    return dataclasses.replace(headline_config(), **flow,
                               lepard_every=PERCEPTION["lepard_every"])


def perception_lepard(dev, stepwise=False):
    """The perception phases' matcher: lepard_bridge_r5e with the
    coherence filter at PERCEPTION["coherence_tau"] and, with
    ``stepwise`` (phase `perception_stepwise`), batched_encode."""
    from occlusionfusion_tpu_torch.models.checkpoint import (
        lepard_config_from_json,
        load_lepard_checkpoint,
    )

    path = os.path.join(HERE, "checkpoints", PERCEPTION["lepard"])
    with open(path + ".json") as fh:
        cfg = lepard_config_from_json(json.load(fh))
    cfg = cfg._replace(coherence_tau=PERCEPTION["coherence_tau"],
                       batched_encode=stepwise)
    return load_lepard_checkpoint(path, device=dev, config=cfg)[0]



def matcher_points(origin, q):
    """The f32 points of a matcher case: ``origin`` + ``q`` (int16) x
    MATCHER_QUANTUM, computed in numpy's f32 so that every reader gets
    the same bits."""
    import numpy as np

    return (np.asarray(origin, np.float32)
            + q.astype(np.float32) * np.float32(MATCHER_QUANTUM))


def load_matcher_cases(path=MATCHER_CASES):
    """The JAX matcher's cases (MATCHER_CASES): a list of dicts with
    ``phase``, ``frame``, the points ``src`` [n, 3] and ``tgt`` [m, 3]
    and JAX's ``anchors_pre`` [S], ``anchors`` [S] (bool, before and
    after the coherence filter), ``blend`` [n] (bool) and ``flow``
    [ceil(n / MATCHER_FLOW_STRIDE), 3]."""
    import numpy as np

    cases = {}
    with np.load(path) as z:
        for key in z.files:
            phase, frame, name = key.split("/")
            c = cases.setdefault((phase, int(frame)),
                                 {"phase": phase, "frame": int(frame)})
            c[name] = z[key]
    for c in cases.values():
        origin = c.pop("origin")
        c["src"] = matcher_points(origin, c.pop("src_q"))
        c["tgt"] = matcher_points(origin, c.pop("tgt_q"))
    return [cases[k] for k in sorted(cases)]


def perception_sequence():
    """The textured sphere at 1 m of the perception phases: initialize
    plus PERCEPTION_FRAMES frames."""
    return sphere_sequence(PERCEPTION_FRAMES + 1, IMG_H, IMG_W,
                           HEADLINE["radius"], PERCEPTION["step"],
                           HEADLINE["distance"], textured=True,
                           lateral=PERCEPTION["lateral"])


def near_sequence():
    """The sphere at 1 m (NEAR): 16 frames after the first."""
    return sphere_sequence(N_FRAMES + 1, NEAR["h"], NEAR["w"], RADIUS,
                           STEP_Z, NEAR["distance"])


def drive_path(path, dev, seq, cfg, net, profile, **nets):
    """initialize + build_fused, then every frame of ``seq`` through the
    fused step, with the launch counts set to 0 just before and read just
    after. Returns (fusion, state, tables, info [F, 7] numpy, timings,
    counts)."""
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    fusion = DynamicFusion(seq, cfg, device=dev, **nets)
    fusion.initialize(seq.load(0))
    sc, state, tables = fusion.build_fused(net)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    infos = []
    t1 = time.perf_counter()
    state, info = fusion.register_frame_fused(
        sc, state, tables, seq.load(1), net
    )
    infos.append(info)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    with profiled(profile) as prof:
        t2 = time.perf_counter()
        for i in range(2, len(seq)):
            state, info = fusion.register_frame_fused(
                sc, state, tables, seq.load(i), net
            )
            infos.append(info)
        torch.cuda.synchronize()
        t_window = time.perf_counter() - t2
        # before the profiler's exit, which processes its trace
        t_frames = time.perf_counter() - t1
    counts = dict(D.launch_counts)
    if prof is not None:
        report_profile(prof, t_window, path, len(seq) - 2)
    fusion.adopt_fused_state(state)
    n = len(seq) - 1
    timings = {
        "init_s": t_init, "frames_s": t_frames, "frames": n,
        "frames_per_s": n / t_frames,
        "frames_per_s_after_first": (n - 1) / (t_frames - t_first),
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
    }
    info_np = torch.stack(infos).cpu().numpy()
    for i, row in enumerate(info_np, start=1):
        emit({"path": path, "frame": i, "final_loss": float(row[0]),
              "n_correspondences": int(row[1]),
              "n_visible_nodes": int(row[2]),
              "mean_confidence": float(row[3]),
              "solve_valid": bool(row[4] > 0.5),
              "n_flow_filled": int(row[5]),
              "n_lepard_matches": int(row[6])})
    return fusion, state, tables, info_np, timings, counts


def check_tracking(fusion, state, info_np, centers, counts):
    """The checks every full-size path passes (K1-K4 launched, K3' and
    K4' once per GN iteration); returns the median node translation and
    the sphere's motion."""
    import numpy as np

    n = fusion.node_count
    trans = fusion.warp.translations[:n].cpu().numpy()
    med = np.median(trans, axis=0)
    motion = centers[-1] - centers[0]
    assert np.isfinite(info_np).all(), "non-finite frame info"
    assert (info_np[:, 4] > 0.5).all(), "a GN solve was not valid"
    assert (info_np[:, 1] > 1000).all(), "too few correspondences"
    assert fusion.model_point_count == MAX_POINTS, fusion.model_point_count
    assert 200 <= n <= MAX_NODES, f"{n} nodes"
    assert np.all(np.abs(med - motion) <= 4e-3), (med, motion)
    assert np.isfinite(state.tsdf.tsdf.cpu().numpy()).all()
    for k in PATH_KERNELS:
        assert counts[k] > 0, f"kernel {k} was not launched on this path"
    for k in ("point_term_blocks", "arap_term_blocks"):
        assert counts[k] == GN_ITERS * len(info_np), counts
    return med, motion, trans


class SolveTap:
    """Within the block, keeps the arguments of the ``at``-th call of the
    fused step's solver ``name`` (``solve_dense`` or ``nicp_solve``; that
    is, of frame ``at``), or of the solver a ``module`` imports by that
    name: (problem, config, R, t)."""

    def __init__(self, at, name="solve_dense", module=None):
        self.at, self.name, self.calls, self.call = at, name, 0, None
        self.module = module

    def __enter__(self):
        from occlusionfusion_tpu_torch.fusion import fused_step

        mod = self.module or fused_step
        self.mod, self.orig = mod, getattr(mod, self.name)

        def tap(problem, config, init_rotations, init_translations, **kw):
            self.calls += 1
            if self.calls == self.at:
                self.call = (problem, config, init_rotations.clone(),
                             init_translations.clone())
            return self.orig(problem, config, init_rotations,
                             init_translations, **kw)

        setattr(mod, self.name, tap)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


class KernelInputTap:
    """Within the block, keeps the arguments K1 and K2 receive on the
    path: those of every k-NN call, by query count (``knn``, P -> call;
    ``initialize`` skins the voxel centres and the model points), or with
    ``keep_all`` every call in order, each under the ``label`` the caller
    set before it (``calls``: (label, P, call)); and those of the
    ``at``-th LBS voxel warp (that of frame ``at``), or with ``at`` None
    of the last one made outside a graph capture. Patches the names the
    path calls (``skinning.knn``, ``fused_step.lbs_warp``), which every
    tree of the port has."""

    def __init__(self, at, keep_all=False):
        self.at, self.lbs_calls, self.knn, self.lbs = at, 0, {}, None
        self.keep_all, self.label, self.calls = keep_all, "", []

    def __enter__(self):
        from occlusionfusion_tpu_torch.fusion import fused_step
        from occlusionfusion_tpu_torch.geometry import skinning

        self.mods = (skinning, fused_step)
        self.orig = (skinning.knn, fused_step.lbs_warp)
        knn, lbs_warp = self.orig

        def knn_tap(queries, refs, k, valid=None):
            call = (queries.clone(), refs.clone(), k,
                    None if valid is None else valid.clone())
            if self.keep_all:
                self.calls.append((self.label, queries.shape[0], call))
            else:
                self.knn[queries.shape[0]] = call
            return knn(queries, refs, k, valid=valid)

        def lbs_tap(points, anchors, weights, valid, state):
            import torch

            self.lbs_calls += 1
            if self.lbs_calls == self.at or self.at is None and not (
                    points.is_cuda
                    and torch.cuda.is_current_stream_capturing()):
                self.lbs = (points, anchors, weights, valid, state)
            return lbs_warp(points, anchors, weights, valid, state)

        skinning.knn = knn_tap
        fused_step.lbs_warp = lbs_tap
        return self

    def __exit__(self, *exc):
        self.mods[0].knn, self.mods[1].lbs_warp = self.orig


def k12_path_rows(knn_calls, lbs_call):
    """K1 on each k-NN call of the main path's ``initialize`` (the
    lattice voxel centres and the model points, each against its node
    table and node_valid), most queries first; K2 on the main path's
    voxel warp at frame TAP_FRAME (its skin table and warp field)."""
    rows = []
    for P in sorted(knn_calls, reverse=True):
        q, refs, _, valid = knn_calls[P]
        rows.append(knn_row(f"main_path_initialize_P{P}", q, refs, valid)[0])
    return rows + [lbs_row(f"main_path_frame_{TAP_FRAME}", *lbs_call)]


def phase_main_path(dev, profile=False):
    """Returns the launch counts, the main path's Gauss-Newton input at
    frame TAP_FRAME and the K1 and K2 inputs KernelInputTap keeps."""
    import numpy as np

    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE)
    net = load_motion_complete_net(device=dev)
    with SolveTap(TAP_FRAME) as tap, KernelInputTap(TAP_FRAME) as ktap:
        fusion, state, tables, info_np, timings, counts = drive_path(
            "main_path", dev, seq, sphere_config(), net, profile)
    out = {
        "phase": "main_path", "sphere_distance_m": DISTANCE, **timings,
        "nodes": fusion.node_count, "model_points": fusion.model_point_count,
        "voxels": int(tables.vox_points.shape[0]),
        "valid_voxels": int(tables.vox_valid.sum()),
        "launches": counts,
    }
    try:
        med, motion, trans = check_tracking(fusion, state, info_np, centers,
                                            counts)
    finally:
        emit(out)
    emit({"phase": "main_path_tracking",
          "median_node_translation": med.tolist(),
          "node_translation_z_quantiles_10_50_90": np.quantile(
              trans[:, 2], [0.1, 0.5, 0.9]).tolist(),
          "sphere_motion": motion.tolist()})
    return counts, tap.call, (ktap.knn, ktap.lbs)


def gn_path_inputs(call):
    """K3' and K4' arguments of the first GN iteration of a tapped solve."""
    from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND

    problem, config, R, t = call
    terms = GND._fixed_terms(problem, config)
    point_args = tuple(x.contiguous() for x in (
        problem.source_points, problem.target_points, problem.point_valid,
        problem.point_anchors, problem.point_weights, problem.nodes, R, t,
    )) + (terms.sw,)
    arap_args = (problem.nodes, R, t, terms.edges, terms.wa, terms.wm,
                 problem.motion_targets.contiguous())
    return point_args, arap_args, terms.proj


def assembly_ms(call, timer):
    """ms of one ``_assemble_blocks`` (the zeroed system plus every term)
    on a tapped solve's input, by ``timer`` (graph_ms: device time;
    cuda_ms: paced by the host): median, fastest, slowest trial."""
    from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND

    problem, config, R, t = call
    return timer(lambda: GND._assemble_blocks(problem, config, R, t), 20)


def phase_gn_path(call):
    """K3' and K4' against their twins on the main path's own GN input at
    frame TAP_FRAME (anchors sharing pairs as the surface makes them),
    timed with their bounds, and the whole assembly timed."""
    rows = gn_kernel_rows(f"main_path_frame_{TAP_FRAME}",
                          *gn_path_inputs(call))
    asm = assembly_ms(call, graph_ms)
    emit({"phase": "kernel", "input": f"main_path_frame_{TAP_FRAME}",
          "rows": rows, "assembly_ms": asm[0],
          "assembly_ms_min_max": asm[1:],
          "assembly_call_ms": assembly_ms(call, cuda_ms)[0]})
    return rows


def phase_envelope_flow(dev, profile=False):
    """The bricked envelope with PWC flow + MaskNet and K4 (see
    envelope_config), 16 frames after the first on the textured sphere at
    3 m. Also times flow_correspondences (PWC + lift + MaskNet) alone on
    the last frame pair, for its share of the frame."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch.fusion.flow_correspondence import (
        flow_correspondences,
    )
    from occlusionfusion_tpu_torch.fusion.fused_step import _rgbxyz_image
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_flow_nets,
        load_motion_complete_net,
    )

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE, textured=True)
    net = load_motion_complete_net(device=dev)
    pwc, mask = load_flow_nets(device=dev)
    fusion, state, tables, info_np, timings, counts = drive_path(
        "envelope_flow", dev, seq, envelope_config(), net, profile,
        flow_net=pwc, mask_net=mask)
    filled = info_np[:, 5].astype(int).tolist()
    n_bricks = int((fusion.brick_ids >= 0).sum())
    out = {
        "phase": "envelope_flow", "sphere_distance_m": DISTANCE, **timings,
        "brick_size": fusion.brick_size, "active_bricks": n_bricks,
        "max_bricks": ENVELOPE_MAX_BRICKS,
        "voxel_slots": int(tables.vox_points.shape[0]),
        "valid_voxels": int(tables.vox_valid.sum()),
        "nodes": fusion.node_count, "model_points": fusion.model_point_count,
        "flow_filled_per_frame": filled, "launches": counts,
    }
    try:
        med, motion, _ = check_tracking(fusion, state, info_np, centers,
                                        counts)
        assert fusion.brick_size == 8, fusion.brick_size
        assert 0 < n_bricks <= ENVELOPE_MAX_BRICKS, n_bricks
        assert max(filled) > 0, "flow filled no point on any frame"
    finally:
        emit(out)

    def depth_color(i):
        f = seq.load(i)
        return (torch.as_tensor(f.depth, device=dev),
                torch.as_tensor(f.color, device=dev))

    prev = _rgbxyz_image(*depth_color(N_FRAMES - 1), seq.intrinsics)
    cur = _rgbxyz_image(*depth_color(N_FRAMES), seq.intrinsics)
    with torch.no_grad():
        flow_ms = cuda_ms(lambda: flow_correspondences(pwc, prev, cur, mask),
                          3)
    frame_ms = 1e3 / timings["frames_per_s_after_first"]
    emit({"phase": "envelope_flow_tracking",
          "median_node_translation": med.tolist(),
          "sphere_motion": motion.tolist(),
          "flow_correspondences_ms": flow_ms[0],
          "flow_correspondences_ms_min_max": flow_ms[1:],
          "frame_ms_after_first": frame_ms,
          "flow_share_of_frame": flow_ms[0] / frame_ms})
    return counts


def phase_near(dev):
    """The sphere at 1 m (NEAR), where the reference algorithm overshoots
    the motion: the card must reproduce the JAX package's result."""
    import numpy as np

    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = near_sequence()
    f = DynamicFusion(seq, sphere_config(NEAR["vol"], NEAR["voxel"],
                                         NEAR["max_points"]), device=dev)
    infos = f.run_fused(motion_net=load_motion_complete_net(device=dev))
    trans = f.warp.translations[: f.node_count].cpu().numpy()
    med = np.median(trans, axis=0)
    motion = centers[-1] - centers[0]
    emit({"phase": "near", "sphere_distance_m": NEAR["distance"],
          "nodes": f.node_count, "model_points": f.model_point_count,
          "median_node_translation": med.tolist(),
          "reference_median_z": NEAR_REFERENCE_Z,
          "sphere_motion": motion.tolist()})
    assert all(i["solve_valid"] for i in infos)
    assert abs(med[2] - NEAR_REFERENCE_Z) <= 1e-3, (med, NEAR_REFERENCE_Z)
    assert med[2] > motion[2] + 4e-3, "the reference's overshoot is missing"


def frames_on(dev, seq, ids):
    """Depth [F, H, W] and colour [F, H, W, 3] of frames ``ids``."""
    import numpy as np
    import torch

    frames = [seq.load(i) for i in ids]
    return (torch.as_tensor(np.stack([f.depth for f in frames]), device=dev),
            torch.as_tensor(np.stack([f.color for f in frames]), device=dev))


def traced_replay_launches(graph, state, depths, colors, tries=3):
    """F6: the kernel launches of one replay of a short graph, counted
    from torch.profiler records. The profiler drops records of long
    traces (one replay of the envelope's 16-frame graph, 45,673 device
    ops, once lost a frame's kernels), so only a short graph is traced
    (GN paths: 2 frames; N-ICP: one step with 2 Adam iterations), until
    two traces count the same kernels, at most ``tries`` times (three:
    one of two traces of the N-ICP step once lost 20 of 2,248 records):
    each
    trace's launches by kernel must equal the capture's, and two traces
    must agree, else a record was lost and this fails (naming the device
    ops whose counts differed). Copies are left out of that agreement:
    two traces of one replay of the perception path's 2-frame graph
    counted 186 and 178 device-to-device copies, with the same kernels.
    Two traces agree where every kernel's count is the same in both.
    Returns the launches, and the device ms and ops (kernels and copies)
    of the replay."""
    traces, seen = [], {}
    while len(traces) < tries:
        by_kernel = traced_device(lambda: graph.replay(state, depths, colors),
                                  1)
        traces.append((
            {k: sum(n for name, (_, n) in by_kernel.items() if sym in name)
             for k, sym in KERNEL_SYMBOLS.items()},
            sum(v[0] for v in by_kernel.values()) / 1e3,
            sum(v[1] for v in by_kernel.values())))
        assert traces[-1][0] == graph.counts, (traces[-1][0], graph.counts)
        key = tuple(sorted((k, v[1]) for k, v in by_kernel.items()
                           if not k.startswith(("Memcpy", "Memset"))))
        if key in seen:
            return traces[-1]
        seen[key] = by_kernel
    (_, ka), (_, kb) = list(seen.items())[:2]
    diff = {k[:60]: (ka.get(k, (0, 0))[1], kb.get(k, (0, 0))[1])
            for k in set(ka) | set(kb)
            if ka.get(k, (0, 0))[1] != kb.get(k, (0, 0))[1]}
    raise AssertionError(("the profiler dropped records",
                          [t[2] for t in traces], diff))


def engine_rates(fusion, sc, state, tables, net, depths, colors, gate=None):
    """frames/s of the eager steps and of the graph engine over the same
    F frames from the same state, in turns eager, graph, graph, eager
    (the chunk's graph captured and each engine run once before);
    ``gate`` [F]: the Lepard cadence gate of the frames (None: every
    frame)."""
    import torch

    from occlusionfusion_tpu_torch.fusion.fused_step import (
        fused_register_chunk,
        fused_register_frame,
    )

    perception = (fusion.flow_net, fusion.mask_net, fusion.lepard_net)
    gate = gate or (True,) * depths.shape[0]

    def eager():
        st = state
        for j in range(depths.shape[0]):
            st, _ = fused_register_frame(sc, st, tables, net, depths[j],
                                         colors[j], fusion.intr, *perception,
                                         run_lepard=gate[j])

    def graph():
        fused_register_chunk(sc, state, tables, net, depths, colors,
                             fusion.intr, *perception, graphs=fusion.graphs,
                             lepard_on=gate)

    runs = {"eager": eager, "graph": graph}
    for fn in runs.values():
        fn()
    out = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        out[name].append(depths.shape[0] / (time.perf_counter() - t0))
    return {"rate_frames": depths.shape[0],
            "eager_frames_per_s": out["eager"],
            "graph_frames_per_s": out["graph"]}


def node_diff_stats(a, b, n):
    """Per-node differences of two states' first ``n`` nodes (the largest
    |dR| entry and the largest |dt| entry of each node): their largest,
    STEP_PERCENTILE-th percentile and median over the nodes."""
    import numpy as np

    dR = (a.rotations[:n] - b.rotations[:n]).abs().amax((1, 2))
    dt = (a.translations[:n] - b.translations[:n]).abs().amax(1)
    out = {}
    for name, x in (("dR", dR.cpu().numpy()), ("dt_m", dt.cpu().numpy())):
        out[f"max_{name}"] = float(x.max())
        out[f"p{STEP_PERCENTILE}_{name}"] = float(
            np.percentile(x, STEP_PERCENTILE))
        out[f"median_{name}"] = float(np.median(x))
    return out


def step_checks(eager, graph, state0, n, frames, check, max_limits):
    """F5: at each frame of ``check`` (indices into the F frames) the
    captured step (``graph(state, j)``, a one-step graph) and the eager
    step (``eager(state, j)``) each run twice from the same state, which
    then advances by the eager step (by the graph's elsewhere). Holds
    graph to eager: info counts equal; the median node's rotation and
    translation within STEP_MEDIAN_LIMIT; at each frame the
    STEP_PERCENTILE-th percentile over nodes, a statistic the few rim
    nodes that the atomics' rounding flips cannot move, within
    STEP_PERCENTILE_LIMITS or within 3x the same percentile between the
    two eager steps or the two graph steps of that frame, whichever is
    larger (where the state is weakly held, that rounding moves many
    nodes, between two eager steps as between graph and eager); with
    ``max_limits`` (the main path, which shows no flips) the largest node
    difference too (translation within 1e-5, rotation within 3x the
    largest between the two eager steps, or 1e-5). Returns the largest
    reading over the checked frames of each statistic, graph against
    eager, eager against eager and graph against graph, the largest share
    of its limit a percentile took, and the launches of one eager
    step."""
    import numpy as np

    from occlusionfusion_tpu_torch import device as D

    rows = {"graph_vs_eager": [], "eager_vs_eager": [], "graph_vs_graph": []}
    counts_equal, st, step_launches = True, state0, None
    for j in range(frames):
        if j not in check:
            st = graph(st, j)[0]
            continue
        D.reset_launch_counts()
        e1, ie1 = eager(st, j)
        step_launches = step_launches or dict(D.launch_counts)
        e2, ie2 = eager(st, j)
        (g1, ig1), (g2, ig2) = graph(st, j), graph(st, j)
        for ie, ig in ((ie1, ig1), (ie2, ig2)):
            counts_equal &= bool(np.array_equal(
                ie.cpu().numpy()[[1, 2, 4, 5]], ig.cpu().numpy()[0, [1, 2, 4, 5]]))
        ge = (node_diff_stats(e1, g1, n), node_diff_stats(e2, g2, n))
        rows["graph_vs_eager"].append({k: max(d[k] for d in ge)
                                       for k in ge[0]})
        rows["eager_vs_eager"].append(node_diff_stats(e1, e2, n))
        rows["graph_vs_graph"].append(node_diff_stats(g1, g2, n))
        st = e1
    out = {f"step_{kind}_{k}": max(r[k] for r in rs)
           for kind, rs in rows.items() for k in rs[0]}
    ge = {k: max(r[k] for r in rows["graph_vs_eager"])
          for k in rows["graph_vs_eager"][0]}
    p = STEP_PERCENTILE
    # each frame's percentile against the larger of the absolute limit
    # and 3x that frame's run-to-run reading
    share = {k: max(g[f"p{p}_{k}"] / max(v, 3 * e[f"p{p}_{k}"],
                                         3 * gg[f"p{p}_{k}"])
                    for g, e, gg in zip(*rows.values()))
             for k, v in STEP_PERCENTILE_LIMITS.items()}
    out.update(step_frames_checked=[j + 1 for j in check],
               step_counts_equal=counts_equal,
               step_graph_vs_eager_p_dt_m_per_frame=[
                   r[f"p{p}_dt_m"] for r in rows["graph_vs_eager"]],
               step_limits={"median": STEP_MEDIAN_LIMIT,
                            **{f"p{p}_{k}": v for k, v in
                               STEP_PERCENTILE_LIMITS.items()}},
               **{f"step_p{p}_{k}_share_of_limit": v
                  for k, v in share.items()},
               eager_step_launches=step_launches)

    def check_limits():
        assert counts_equal, rows
        assert ge["median_dR"] <= STEP_MEDIAN_LIMIT, ge
        assert ge["median_dt_m"] <= STEP_MEDIAN_LIMIT, ge
        for k, v in share.items():
            assert v <= 1.0, (k, v, rows)
        if max_limits:
            assert ge["max_dt_m"] <= 1e-5, ge
            assert ge["max_dR"] <= max(
                1e-5, 3 * out["step_eager_vs_eager_max_dR"]), out

    return out, check_limits


def graph_case(path, fusion, sc, state0, tables, net, depths, colors,
               check, max_limits, rate_frames, full_eager, gate=None):
    """Phase graph's checks of one path (see phase_graph), from
    ``state0`` over the frames ``depths``/``colors``: the step checks
    (step_checks) at the frames ``check``; with ``full_eager`` the
    F-frame replay against F eager steps (median node translation within
    1 mm, launches per frame equal); the launches of one traced replay of
    a short graph (traced_replay_launches; 2 frames of the GN paths, one
    step with 2 Adam iterations of N-ICP) and of every one-step graph the
    step checks captured, one per pattern of the Lepard gate
    (``gate`` [F], the frames' cadence gate; None: every frame); frames/s
    of both engines over the first ``rate_frames`` frames. Emits and
    returns the phase's row; every check is made after the row is
    emitted."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.fused_step import (
        fused_register_chunk,
        fused_register_frame,
    )

    perception = (fusion.flow_net, fusion.mask_net, fusion.lepard_net)
    n, F = fusion.node_count, depths.shape[0]
    gate = tuple(bool(g) and sc.use_lepard for g in gate or (True,) * F)

    def eager(st, j):
        return fused_register_frame(sc, st, tables, net, depths[j], colors[j],
                                    fusion.intr, *perception,
                                    run_lepard=gate[j])

    def chunk(st, lo, hi, config=sc):
        return fused_register_chunk(
            config, st, tables, net, depths[lo:hi], colors[lo:hi],
            fusion.intr, *perception, graphs=fusion.graphs,
            lepard_on=gate[lo:hi])

    def graphs_of(steps, config=sc):
        """The captured graphs of ``steps`` steps, by gate pattern."""
        return {k[-1]: g for k, g in fusion.graphs.items()
                if k[0] == config and k[1] == steps and k[5] == id(tables)}

    def graph_of(steps, config=sc):
        (g,) = graphs_of(steps, config).values()
        return g

    out = {"phase": "graph", "path": path, "frames": F, "nodes": n}
    checks = []
    if full_eager:
        torch.cuda.synchronize()
        D.reset_launch_counts()
        st, rows = state0, []
        for j in range(F):
            st, info = eager(st, j)
            rows.append(info)
        torch.cuda.synchronize()
        eager_counts = dict(D.launch_counts)
        state_e, info_e = st, torch.stack(rows).cpu().numpy()
        state_g, info_g = chunk(state0, 0, F)
        info_g = info_g.cpu().numpy()
        full = graph_of(F)
        med_e = np.median(state_e.translations[:n].cpu().numpy(), axis=0)
        med_g = np.median(state_g.translations[:n].cpu().numpy(), axis=0)
        out.update(
            chunk_median_translation_diff_m=float(np.abs(med_e - med_g).max()),
            chunk_diff=node_diff_stats(state_e, state_g, n),
            chunk_counts_equal_frames=int(np.sum(np.all(
                info_e[:, [1, 2, 4, 5]] == info_g[:, [1, 2, 4, 5]], axis=1))),
            eager_launches=eager_counts,
            graph_launches_per_replay=full.counts,
            capture_s=full.capture_s)

        def check_full():
            assert np.abs(med_e - med_g).max() <= 1e-3, (med_e, med_g)
            for k in ("lbs_warp", "point_term_blocks", "arap_term_blocks"):
                assert eager_counts[k] == full.counts[k] > 0, (
                    k, eager_counts, full.counts)

        checks.append(check_full)
    steps, check_steps = step_checks(eager, lambda st, j: chunk(st, j, j + 1),
                                     state0, n, F, check, max_limits)
    out.update(steps)
    checks.append(check_steps)
    # F6: the launches of a replay short enough that the profiler keeps
    # every record, traced: 2 frames of the GN paths; the N-ICP step's
    # own graph is ~32k device ops (one trace of it lost 684 records), so
    # the same step with 2 Adam iterations; the real graphs' launches must
    # be as many per frame
    short_sc, short_frames = sc, 2
    if sc.solver == "nicp":
        short_sc, short_frames = sc._replace(
            nicp=sc.nicp._replace(iters=2)), 1
    chunk(state0, 0, short_frames, short_sc)
    short = graph_of(short_frames, short_sc)
    traced, replay_ms, replay_ops = traced_replay_launches(
        short, state0, depths[:short_frames], colors[:short_frames])
    # the GN paths' one-step graphs of the step checks, one per gate
    # pattern, traced too (an N-ICP step is too long to trace whole): the
    # kernels' launches are the same whether the matcher runs or not
    one_steps = graphs_of(1)
    one_step = one_steps[(gate[check[0]],)]
    patterns = {}
    for pattern, g in one_steps.items():
        row = {"capture_s": g.capture_s}
        if sc.solver != "nicp":
            j = gate.index(pattern[0])
            row.update(zip(("launches", "device_ms", "device_ops"),
                           traced_replay_launches(g, state0, depths[j:j + 1],
                                                  colors[j:j + 1], tries=3)))
        patterns["lepard" if pattern[0] else "no_lepard"] = row
    out.update(traced_replay_frames=short_frames,
               traced_launches_per_replay=traced,
               traced_replay_device_ms=replay_ms,
               traced_replay_device_ops=replay_ops,
               traced_device_ops_per_frame=replay_ops / short_frames,
               one_step_graph_launches=one_step.counts,
               one_step_capture_s=one_step.capture_s,
               one_step_patterns=patterns)

    def check_launches():
        per_frame = {k: v // short_frames for k, v in traced.items()}
        for g in one_steps.values():
            assert per_frame == g.counts, (per_frame, g.counts)
        if full_eager:
            assert {k: v * F for k, v in per_frame.items()} == full.counts, (
                traced, full.counts)
        assert steps["eager_step_launches"] == one_step.counts, (
            steps["eager_step_launches"], one_step.counts)
        assert one_step.counts["lbs_warp"] == 1
        assert len(one_steps) == len({(gate[j],) for j in check}), (
            list(one_steps), check)

    checks.append(check_launches)
    try:
        for c in checks:
            c()
        out.update(engine_rates(fusion, sc, state0, tables, net,
                                depths[:rate_frames], colors[:rate_frames],
                                gate[:rate_frames]))
    finally:
        emit(out)
    return out


def phase_graph(dev):
    """The main path and the envelope through the graph engine against
    the eager steps, on the same 16 frames (graph_case): every
    GRAPH_CHECK_STRIDE-th frame's captured step against its eager step
    from the same state (F5,
    step_checks; max-over-nodes limits on the main path only), the
    16-frame replay against the 16 eager steps, the launches of a traced
    2-frame replay (F6), frames/s in turns."""
    import torch

    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_flow_nets,
        load_motion_complete_net,
    )

    net = load_motion_complete_net(device=dev)
    pwc, mask = load_flow_nets(device=dev)
    cases = {
        "main_path": (sphere_config(), False, {}),
        "envelope_flow": (envelope_config(), True,
                          dict(flow_net=pwc, mask_net=mask)),
    }
    for path, (cfg, textured, nets) in cases.items():
        seq, _ = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                 DISTANCE, textured=textured)
        fusion = DynamicFusion(seq, cfg, device=dev, **nets)
        fusion.initialize(seq.load(0))
        sc, state0, tables = fusion.build_fused(net)
        depths, colors = frames_on(dev, seq, range(1, N_FRAMES + 1))
        graph_case(path, fusion, sc, state0, tables, net, depths, colors,
                   check=range(0, N_FRAMES, GRAPH_CHECK_STRIDE),
                   max_limits=path == "main_path", rate_frames=N_FRAMES,
                   full_eager=True)
        del fusion, sc, state0, tables
        torch.cuda.empty_cache()


def phase_headline(dev, profile=False):
    """bench.py's ENVELOPE_ENV on bench.py's sequence through run_fused
    (CUDA graphs, chunk 16) and get_deformed_mesh, with the launch counts
    set to 0 just before and read just after; then eager and graph
    frames/s in turns and, with ``profile``, one traced replay. Returns
    the launch counts and K1's row on its get_deformed_mesh input (the
    mesh vertices against the node table)."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion

    seq, centers = sphere_sequence(
        HEADLINE_FRAMES + 1, IMG_H, IMG_W, HEADLINE["radius"],
        HEADLINE["step"], HEADLINE["distance"])
    net, nets = headline_nets(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    fusion = DynamicFusion(seq, headline_config(), device=dev, **nets)
    # K1's inputs in initialize, and K2's and the GN solve's in the eager
    # warm-up step before capture (frame 1 from a clone of the state)
    with SolveTap(1) as stap, KernelInputTap(1) as ktap:
        infos = fusion.run_fused(chunk=CHUNK, motion_net=net)
    with KernelInputTap(0) as mtap:  # K1's input in get_deformed_mesh
        verts, faces = fusion.get_deformed_mesh()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    (graph,) = fusion.graphs.values()
    n = fusion.node_count
    trans = fusion.warp.translations[:n].cpu().numpy()
    med = np.median(trans, axis=0)
    motion = centers[-1] - centers[0]
    per_frame = {k: graph.counts[k] // CHUNK for k in graph.counts}
    out = {
        "phase": "headline", "wall_s": wall, "frames": len(infos),
        "nodes": n, "model_points": fusion.model_point_count,
        "active_bricks": int((fusion.brick_ids >= 0).sum()),
        "voxel_slots": int(fusion.vox_points.shape[0]),
        "valid_voxels": int(fusion.vox_table.valid.sum()),
        "mesh_vertices": int(verts.shape[0]), "mesh_faces": int(faces.shape[0]),
        "median_node_translation": med.tolist(),
        "reference_median_z": HEADLINE_REFERENCE_Z,
        "sphere_motion": motion.tolist(),
        "n_correspondences": [i["n_correspondences"] for i in infos],
        "n_flow_filled": [i["n_flow_filled"] for i in infos],
        "n_lepard_matches": [i["n_lepard_matches"] for i in infos],
        "reference_n_correspondences": HEADLINE_REFERENCE_CORRESPONDENCES,
        "reference_n_lepard_matches": HEADLINE_REFERENCE_LEPARD,
        "track_lost": fusion.track_lost,
        "launches": counts, "launches_per_replay": graph.counts,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
    }
    try:
        assert len(infos) == HEADLINE_FRAMES
        assert all(i["solve_valid"] for i in infos), infos
        assert all(np.isfinite(i["final_loss"]) for i in infos), infos
        assert not fusion.track_lost
        assert np.isfinite(verts).all() and faces.shape[0] > 0
        assert abs(med[2] - HEADLINE_REFERENCE_Z) <= 2e-3, (
            med, HEADLINE_REFERENCE_Z)
        # per frame, the correspondences and the Lepard matches against
        # the JAX package's on the same input
        for key, ref, tol in (
                ("n_correspondences", HEADLINE_REFERENCE_CORRESPONDENCES,
                 HEADLINE_CORRESPONDENCE_TOL),
                ("n_lepard_matches", HEADLINE_REFERENCE_LEPARD,
                 HEADLINE_LEPARD_TOL)):
            got = [i[key] for i in infos]
            assert all(abs(a - b) <= tol * b for a, b in zip(got, ref)), (
                key, got, ref)
        assert max(HEADLINE_REFERENCE_LEPARD) > 0
        # K1: initialize (voxels, model points) and the mesh; the rest per
        # replayed frame plus the warm-up step before capture
        assert counts["knn"] == 3, counts
        assert per_frame == {"knn": 0, "lbs_warp": 1,
                             "point_term_blocks": HEADLINE["gn_iters"],
                             "arap_term_blocks": HEADLINE["gn_iters"]}, (
            graph.counts)
        for k, m in per_frame.items():
            if m:
                assert counts[k] == m * (HEADLINE_FRAMES + 1), (k, counts)
    finally:
        emit(out)
    # the engines in turns, from the tables and state build_fused gives
    # now (the canonical model after the run)
    sc, state0, tables = fusion.build_fused(net)
    depths, colors = frames_on(dev, seq, range(1, HEADLINE_FRAMES + 1))
    rates = engine_rates(fusion, sc, state0, tables, net, depths, colors)
    emit({"phase": "headline_rates", **rates})
    if profile:
        (graph,) = [g for k, g in fusion.graphs.items() if k[5] == id(tables)]
        with profiled(True) as prof:
            t0 = time.perf_counter()
            graph.replay(state0, depths, colors)
            torch.cuda.synchronize()
            t_window = time.perf_counter() - t0
        report_profile(prof, t_window, "headline_graph_replay",
                       HEADLINE_FRAMES)
    return counts, headline_rows(ktap, mtap, stap.call)


def headline_rows(ktap, mtap, solve, path="headline"):
    """Every kernel of the headline (or of the headline-sized ``path``) on
    its own inputs: K1 on its calls in initialize (the voxel slots and the
    model points) and in get_deformed_mesh (the mesh vertices), each
    against the 256-node table; K2 on the 524,288 brick slots and K3'/K4'
    on the GN system (N = 256, w_arap = 2) of the warm-up step before
    capture."""
    rows = []
    for P in sorted(ktap.knn, reverse=True):
        q, refs, _, valid = ktap.knn[P]
        rows.append(knn_row(f"{path}_initialize_P{P}", q, refs, valid)[0])
    (P, (q, refs, _, valid)), = mtap.knn.items()
    rows.append(knn_row(f"{path}_get_deformed_mesh_P{P}", q, refs,
                        valid)[0])
    rows.append(lbs_row(f"{path}_warmup_frame_1", *ktap.lbs))
    rows += gn_kernel_rows(f"{path}_warmup_frame_1", *gn_path_inputs(solve))
    return rows


def perception_first_frame(fusion, loop, net):
    """The median node translation after the first frame (the matcher
    not yet run), and that frame's correspondences, of ``loop``
    ("run_fused" or "run") from a fresh initialize."""
    import numpy as np

    (info,) = getattr(fusion, loop)(end=2, motion_net=net)
    n = fusion.node_count
    return (np.median(fusion.warp.translations[:n].cpu().numpy(), axis=0),
            info["n_correspondences"])


def perception_ensemble(dev, seq, cfg, nets, net, loop):
    """The port's runs of ``loop`` ("run_fused" or "run") on ``seq`` with
    the depth scaled by 1 + eps for each eps in PERCEPTION_ENSEMBLE, as
    scripts/torch_perception_reference.py runs JAX: per run the median
    node translation, and per frame the correspondences and Lepard
    matches."""
    import numpy as np

    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion

    runs = []
    for eps in PERCEPTION_ENSEMBLE:
        s = ArraySequence(seq.colors,
                          [d * np.float32(1 + eps) for d in seq.depths],
                          seq.intrinsics)
        fusion = DynamicFusion(s, cfg, device=dev, **nets)
        infos = getattr(fusion, loop)(motion_net=net)
        n = fusion.node_count
        runs.append({
            "median_node_translation": np.median(
                fusion.warp.translations[:n].cpu().numpy(), axis=0).tolist(),
            "n_correspondences": [i["n_correspondences"] for i in infos],
            "n_lepard_matches": [i["n_lepard_matches"] for i in infos]})
        del fusion
    return runs


def check_perception(out, infos, med, first, ref, counts, ensemble,
                     margin=0.0):
    """The perception phases' checks against the JAX package's result
    ``ref`` (PERCEPTION_REFERENCE or PERCEPTION_STEPWISE_REFERENCE). The
    result after all frames is unstable on this input (F9): a relative
    change of 1e-6 in the depth moves JAX's own median by millimetres to
    centimetres. So the median after all frames (``med``) and each
    median of the port's own perturbed runs (``ensemble``,
    perception_ensemble) must lie, on each axis, within the range of
    JAX's runs (its result and its PERCEPTION_ENSEMBLE runs) widened on
    either side by the larger of that range and the port's runs' range
    (five runs each; one side's five can span a fifth of the other's),
    or by ``margin`` (per axis) where that is larger. The first frame's median (``first``, a
    run of its own, with its correspondences) is within 2 mm on each
    axis and 0.5%; each frame's correspondences and Lepard matches
    within HEADLINE_*_TOL of JAX's on the frames that every JAX run
    reproduces (``ref["stable_frames"]``) where the port's own five runs
    (``med``'s and the ensemble's) agree within that tolerance too: the
    atomics' rounding (K3', K4', ``index_add_``) moves one run's counts at
    the matcher's near ties (F9), while a fault of the port moves all
    five alike and keeps the frame held; the dropped frames are printed,
    and the check fails where it drops frame 1 (no matcher has run) or
    more than one stable frame; on every frame and in
    every port run, within the range of JAX's runs widened by the larger
    of that range and the port's runs' range, and HEADLINE_*_TOL of its
    top; no matches on the frames the
    cadence gate skips, some on every other; every solve valid; K2 once
    and K3'/K4' once per GN iteration a frame. The matcher itself is
    held to JAX on JAX's own inputs in phase `perception_matcher`."""
    import numpy as np

    every = PERCEPTION["lepard_every"]
    jax_runs = np.asarray([ref["median_node_translation"]]
                          + ref["ensemble_median_node_translation"])
    lo, hi = jax_runs.min(0), jax_runs.max(0)
    port_runs = np.asarray([med] + [r["median_node_translation"]
                                    for r in ensemble])
    span = np.maximum(np.maximum(hi - lo, np.ptp(port_runs, axis=0)),
                      margin)
    out.update(first_frame_median_node_translation=first[0].tolist(),
               reference_first_frame_median_node_translation=ref[
                   "first_frame_median_node_translation"],
               first_frame_correspondences=first[1],
               reference_median_range_min=lo.tolist(),
               reference_median_range_max=hi.tolist(),
               median_range_min=port_runs.min(0).tolist(),
               median_range_max=port_runs.max(0).tolist(),
               ensemble=ensemble,
               reference_stable_frames=ref["stable_frames"])
    assert len(infos) == PERCEPTION_FRAMES
    assert all(i["solve_valid"] for i in infos), infos
    assert all(np.isfinite(i["final_loss"]) for i in infos), infos
    assert np.isfinite(port_runs).all(), port_runs
    assert np.all((port_runs >= lo - span) & (port_runs <= hi + span)), (
        port_runs, lo, hi)
    assert np.all(np.abs(first[0] - np.asarray(
        ref["first_frame_median_node_translation"])) <= 2e-3), (first, ref)
    assert abs(first[1] - ref["n_correspondences"][0]) <= (
        HEADLINE_CORRESPONDENCE_TOL * ref["n_correspondences"][0]), first
    tols = (("n_correspondences", HEADLINE_CORRESPONDENCE_TOL),
            ("n_lepard_matches", HEADLINE_LEPARD_TOL))
    ours = {}
    for key, tol in tols:
        got = {i["frame"]: i[key] for i in infos}
        ours[key] = np.asarray([[got[f] for f in sorted(got)]]
                               + [r[key] for r in ensemble])
    # the stable frames where the port's five runs disagree beyond the
    # tolerance on either count
    dropped = sorted(
        f for f in ref["stable_frames"] for key, tol in tols
        if np.ptp(ours[key][:, f - 1]) > tol * ref[key][f - 1])
    dropped = sorted(set(dropped))
    out["dropped_stable_frames"] = dropped
    emit({"phase": "perception_stable_frames", "held": [
        f for f in ref["stable_frames"] if f not in dropped],
        "dropped": dropped})
    assert 1 not in dropped and len(dropped) <= 1, dropped
    for key, tol in tols:
        got = {i["frame"]: i[key] for i in infos}
        for f in ref["stable_frames"]:
            if f in dropped:
                continue
            b = ref[key][f - 1]
            assert abs(got[f] - b) <= tol * b, (key, f, got, ref[key])
        runs = np.asarray([ref[key]] + ref["ensemble_" + key])
        rlo, rhi = runs.min(0), runs.max(0)
        pad = np.maximum(rhi - rlo, np.ptp(ours[key], axis=0)) + tol * rhi
        assert np.all((ours[key] >= rlo - pad) & (ours[key] <= rhi + pad)), (
            key, ours[key], runs)
    for i in infos:
        assert (i["n_lepard_matches"] > 0) == (i["frame"] % every == 0), i
    for k in ("lbs_warp", "point_term_blocks", "arap_term_blocks"):
        per = 1 if k == "lbs_warp" else HEADLINE["gn_iters"]
        assert counts[k] >= per * PERCEPTION_FRAMES, (k, counts)
    out["checked"] = True


def phase_perception(dev):
    """Phase `perception`: the headline's settings with flow_mode
    "advect", Lepard from lepard_bridge_r5e with its coherence filter on,
    lepard_every 2 (perception_config, perception_lepard), on the
    textured sphere moving sideways (perception_sequence), through
    run_fused(chunk=16) and get_deformed_mesh, with the launch counts set
    to 0 just before and read just after, held to the JAX package's
    result (PERCEPTION_REFERENCE; check_perception, with the port's own
    perturbed runs, and the medians' range widened by at least the shift
    that the bf16 nets make in JAX: its bf16 run against its f32 run,
    PERCEPTION_F32_REFERENCE); flow must set targets
    on every frame after the first, and one chunk graph is captured per
    pattern of the cadence gate. Then phase graph's checks on this path
    from a fresh initialize (graph_case: the step checks at frames 1 and
    2, gate off and on; the traced launches of each captured pattern;
    frames/s in turns). Returns the launch counts and the kernel rows on
    this path's own inputs (headline_rows)."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.fused_step import lepard_gate
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion

    seq, centers = perception_sequence()
    net, nets = headline_nets(dev, lepard=False)
    nets["lepard_net"] = perception_lepard(dev)
    cfg = perception_config()
    first = perception_first_frame(DynamicFusion(seq, cfg, device=dev, **nets),
                                   "run_fused", net)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    fusion = DynamicFusion(seq, cfg, device=dev, **nets)
    with SolveTap(1) as stap, KernelInputTap(1) as ktap:
        infos = fusion.run_fused(chunk=CHUNK, motion_net=net)
    with KernelInputTap(0) as mtap:
        verts, faces = fusion.get_deformed_mesh()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    graphs = list(fusion.graphs.values())
    sc = fusion.build_fused(net)[0]
    ids = list(range(1, PERCEPTION_FRAMES + 1))
    gates = {lepard_gate(sc, ids[lo:lo + CHUNK])
             for lo in range(0, len(ids), CHUNK)}
    n = fusion.node_count
    med = np.median(fusion.warp.translations[:n].cpu().numpy(), axis=0)
    motion = centers[-1] - centers[0]
    pv = stap.call[0].point_valid
    out = {
        "phase": "perception", "wall_s": wall, "frames": len(infos),
        "nodes": n, "model_points": fusion.model_point_count,
        "active_bricks": int((fusion.brick_ids >= 0).sum()),
        "mesh_vertices": int(verts.shape[0]),
        "median_node_translation": med.tolist(),
        "reference_median_node_translation": PERCEPTION_REFERENCE[
            "median_node_translation"],
        "sphere_motion": motion.tolist(),
        "tracking_error_m": (med - motion).tolist(),
        "n_correspondences": [i["n_correspondences"] for i in infos],
        "n_flow_filled": [i["n_flow_filled"] for i in infos],
        "n_lepard_matches": [i["n_lepard_matches"] for i in infos],
        "reference_n_correspondences": PERCEPTION_REFERENCE[
            "n_correspondences"],
        "reference_n_lepard_matches": PERCEPTION_REFERENCE[
            "n_lepard_matches"],
        "chunk_graphs": len(graphs), "gate_patterns": len(gates),
        "capture_s": [g.capture_s for g in graphs],
        "launches": counts, "launches_per_replay": [g.counts for g in graphs],
        "warmup_steps": sum(len(set(g.lepard_on)) for g in graphs),
        "warmup_fractional_point_weights": int(((pv > 0) & (pv < 1)).sum()),
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
    }
    t = time.perf_counter()
    ensemble = perception_ensemble(dev, seq, cfg, nets, net, "run_fused")
    out["ensemble_s"] = time.perf_counter() - t
    # PWC and MaskNet in bf16 round otherwise in cuDNN than in XLA on
    # the CPU; in JAX alone, bf16 nets move the result from the f32 run's
    # by this much (PERCEPTION_F32_REFERENCE), and the card is held to
    # JAX's range widened by it where it is the larger
    bf16_shift = np.abs(np.subtract(
        PERCEPTION_REFERENCE["median_node_translation"],
        PERCEPTION_F32_REFERENCE["median_node_translation"]))
    out["bf16_shift_in_jax"] = bf16_shift.tolist()
    try:
        check_perception(out, infos, med, first, PERCEPTION_REFERENCE,
                         counts, ensemble, margin=bf16_shift)
        assert not fusion.track_lost
        assert np.isfinite(verts).all() and faces.shape[0] > 0
        assert all(i["n_flow_filled"] > 0 for i in infos[1:]), infos
        assert len(graphs) == len(gates) == 1, (len(graphs), gates)
        # K1: initialize (voxel slots, model points) and the mesh; the rest
        # per replayed frame plus the warm-up steps before capture (one per
        # gate value of the pattern, frame 1's, gate off, first)
        assert counts["knn"] == 3, counts
        steps = PERCEPTION_FRAMES + out["warmup_steps"]
        assert counts["lbs_warp"] == steps, counts
        for k in ("point_term_blocks", "arap_term_blocks"):
            assert counts[k] == HEADLINE["gn_iters"] * steps, counts
        assert out["warmup_fractional_point_weights"] > 0
    finally:
        emit(out)
    rows = headline_rows(ktap, mtap, stap.call, "perception")
    del ktap, mtap, stap
    # phase graph's checks, from a fresh initialize
    t = time.perf_counter()
    fusion.initialize(seq.load(0))
    sc, state0, tables = fusion.build_fused(net)
    depths, colors = frames_on(dev, seq, ids)
    graph_case("perception", fusion, sc, state0, tables, net, depths, colors,
               check=(0, 1), max_limits=False, rate_frames=CHUNK,
               full_eager=False,
               gate=lepard_gate(sc, ids))
    emit({"phase": "perception_graph_done", "s": time.perf_counter() - t})
    del fusion, sc, state0, tables
    torch.cuda.empty_cache()
    return counts, rows


def held_perception_run(dev, phase, stepwise, bf16, ref):
    """One run of a perception phase's settings
    (perception_config(stepwise, bf16), perception_lepard(stepwise)) on
    the perception input through DynamicFusion.run (``stepwise``) or
    run_fused(chunk=16), with the launch counts set to 0 just before and
    read just after, held to the JAX package's result ``ref``
    (check_perception, with the port's own perturbed runs); flow must set
    targets on every frame after the first, and K2 run once a frame in
    the stepwise loop, K1 never. Returns (out, seq, nets, motion net)."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion

    loop = "run" if stepwise else "run_fused"
    seq, centers = perception_sequence()
    net, nets = headline_nets(dev, lepard=False)
    nets["lepard_net"] = perception_lepard(dev, stepwise)
    cfg = perception_config(stepwise, bf16)
    first = perception_first_frame(DynamicFusion(seq, cfg, device=dev, **nets),
                                   loop, net)
    fusion = DynamicFusion(seq, cfg, device=dev, **nets)
    torch.cuda.synchronize()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    infos = (fusion.run(motion_net=net) if stepwise else
             fusion.run_fused(chunk=CHUNK, motion_net=net))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    n = fusion.node_count
    med = np.median(fusion.warp.translations[:n].cpu().numpy(), axis=0)
    motion = centers[-1] - centers[0]
    del fusion
    out = {
        "phase": phase, "wall_s": wall, "frames": len(infos),
        "nodes": n, "frames_per_s_with_initialize": len(infos) / wall,
        "median_node_translation": med.tolist(),
        "reference_median_node_translation": ref["median_node_translation"],
        "sphere_motion": motion.tolist(),
        "tracking_error_m": (med - motion).tolist(),
        "n_correspondences": [i["n_correspondences"] for i in infos],
        "n_flow_filled": [i["n_flow_filled"] for i in infos],
        "n_lepard_matches": [i["n_lepard_matches"] for i in infos],
        "reference_n_correspondences": ref["n_correspondences"],
        "reference_n_lepard_matches": ref["n_lepard_matches"],
        "launches": counts,
    }
    t = time.perf_counter()
    ensemble = perception_ensemble(dev, seq, cfg, nets, net, loop)
    out["ensemble_s"] = time.perf_counter() - t
    try:
        check_perception(out, infos, med, first, ref, counts, ensemble)
        assert all(i["n_flow_filled"] > 0 for i in infos[1:]), infos
        if stepwise:
            assert counts["knn"] == 2, counts  # initialize only
            assert counts["lbs_warp"] == PERCEPTION_FRAMES, counts
    finally:
        emit(out)
    torch.cuda.empty_cache()
    return out, seq, nets, net


def phase_perception_stepwise(dev):
    """Phase `perception_stepwise`: the same input through the stepwise
    DynamicFusion.run with flow_mode "override", PWC at 1/2, patchwise NMS
    in 4x4 patches (the dense lift) and the perception matcher with
    batched_encode, lepard_every 2, held to the JAX package's stepwise
    result (held_perception_run, PERCEPTION_STEPWISE_REFERENCE); then
    batched_encode_check. Returns the launch counts."""
    out, seq, nets, _ = held_perception_run(
        dev, "perception_stepwise", True, True, PERCEPTION_STEPWISE_REFERENCE)
    emit({"phase": "perception_batched_encode",
          **batched_encode_check(dev, nets["lepard_net"], seq)})
    return out["launches"]


def phase_perception_f32(dev):
    """Phase `perception_f32`: phase `perception`'s settings with PWC and
    MaskNet in f32, through run_fused(chunk=16), held to the JAX
    package's run with the nets in f32 (held_perception_run,
    PERCEPTION_F32_REFERENCE): the same checks without the bf16 nets,
    which round otherwise in cuDNN than in XLA on the CPU."""
    held_perception_run(dev, "perception_f32", False, False,
                        PERCEPTION_F32_REFERENCE)


def phase_perception_matcher(dev):
    """Phase `perception_matcher`: the perception phases' matcher
    (perception_lepard: lepard_bridge_r5e with the coherence filter, and
    batched_encode for the stepwise phase's cases) on the card, on the
    JAX matcher's own inputs at every frame where it ran in the two
    perception runs (MATCHER_CASES, load_matcher_cases), held to JAX's
    results on them: the matched anchors before the coherence filter
    (the same net with the filter off) and after it, and the blend mask,
    equal; the blended flow within MATCHER_FLOW_TOL m at the stored
    points. The cases must give the filter work: it drops anchors in
    JAX in at least one of them."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch.models import lepard as L

    nets = {}
    for stepwise in (False, True):
        net = perception_lepard(dev, stepwise)
        off = L.LepardNet(net.config._replace(coherence_tau=0.0))
        off.load_state_dict(net.state_dict())
        nets["perception_stepwise" if stepwise else "perception"] = (
            net, off.to(dev).eval())
    rows, dropped = [], 0
    for c in load_matcher_cases():
        net, off = nets[c["phase"]]
        src, tgt = (torch.as_tensor(c[k], device=dev) for k in ("src", "tgt"))
        ones = (torch.ones(len(src), dtype=torch.bool, device=dev),
                torch.ones(len(tgt), dtype=torch.bool, device=dev))
        with torch.no_grad():
            flow, blend, m = L.scene_flow(net, src, ones[0], tgt, ones[1])
            pre = L.scene_flow(off, src, ones[0], tgt, ones[1])[2]
        blend = blend.cpu().numpy()
        flow = flow.cpu().numpy()[::MATCHER_FLOW_STRIDE]
        both = blend[::MATCHER_FLOW_STRIDE] & c["blend"][::MATCHER_FLOW_STRIDE]
        row = {
            "phase": c["phase"], "frame": c["frame"],
            "anchors_pre": int(pre.match_valid.sum()),
            "reference_anchors_pre": int(c["anchors_pre"].sum()),
            "anchors": int(m.match_valid.sum()),
            "reference_anchors": int(c["anchors"].sum()),
            "blend": int(blend.sum()),
            "reference_blend": int(c["blend"].sum()),
            "anchors_pre_differ": int((pre.match_valid.cpu().numpy()
                                       != c["anchors_pre"]).sum()),
            "anchors_differ": int((m.match_valid.cpu().numpy()
                                   != c["anchors"]).sum()),
            "blend_differ": int((blend != c["blend"]).sum()),
            "flow_max_abs_err_m": float(np.abs(flow - c["flow"])[both].max())
            if both.any() else 0.0,
        }
        rows.append(row)
        dropped += row["reference_anchors_pre"] - row["reference_anchors"]
    out = {"phase": "perception_matcher", "cases": rows,
           "filter_dropped_in_jax": dropped}
    try:
        assert len(rows) == 2 * (PERCEPTION_FRAMES
                                 // PERCEPTION["lepard_every"]), rows
        for r in rows:
            assert r["anchors_pre_differ"] == r["anchors_differ"] == 0, r
            assert r["blend_differ"] == 0, r
            assert r["flow_max_abs_err_m"] <= MATCHER_FLOW_TOL, r
        assert dropped > 0, out
    finally:
        emit(out)


def batched_encode_check(dev, lepard_net, seq):
    """The stepwise matcher (batched_encode) against the same weights
    encoding one cloud after the other, on the card, on frame 1's and
    frame 2's depth subsamples (8192 and 2048 points, strided): the
    matches and the blend mask equal, the features within 1e-5 of their
    scale (atomics' rounding apart, the same sums), the flows within
    1e-5 m; and the milliseconds of each encode (cuda_ms, host launches
    included)."""
    import torch

    from occlusionfusion_tpu_torch.fusion.fused_step import (
        _deterministic_target_subsample,
    )
    from occlusionfusion_tpu_torch.models import lepard as L

    plain = L.LepardNet(lepard_net.config._replace(batched_encode=False))
    plain.load_state_dict(lepard_net.state_dict())
    plain = plain.to(dev).eval()
    clouds = []
    for i, cap in ((1, 8192), (2, 2048)):
        depth = torch.as_tensor(seq.load(i).depth, device=dev)
        clouds += _deterministic_target_subsample(depth, seq.intrinsics, cap,
                                                  "strided")
    with torch.no_grad():
        enc = [L._encode_pair(net, *clouds) for net in (lepard_net, plain)]
        (fb, mb, rb), (fp, mp, rp) = (L.scene_flow(net, *clouds)
                                      for net in (lepard_net, plain))
        times = [cuda_ms(lambda n=n: L._encode_pair(n, *clouds), 5)[0]
                 for n in (lepard_net, plain)]
    feat_err = max(float((a[0] - b[0]).abs().max() / b[0].abs().max())
                   for a, b in zip(*enc))
    out = {"matches": int(rb.match_valid.sum()), "blended": int(mb.sum()),
           "feature_rel_err": feat_err,
           "flow_max_abs_err_m": float((fb - fp).abs().max()),
           "encode_ms_batched": times[0], "encode_ms_one_by_one": times[1]}
    assert torch.equal(rb.match_valid, rp.match_valid), out
    assert torch.equal(mb, mp) and out["matches"] > 0, out
    assert feat_err <= 1e-5 and out["flow_max_abs_err_m"] <= 1e-5, out
    return out


def spheres_depths(frames, h, w, intr):
    """Closed-form z-depth of the nearest of each frame's spheres
    ((centre, radius), ...; None: an empty frame) seen from the pinhole
    camera at the origin."""
    import numpy as np

    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy,
                  np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depths = []
    for spheres in frames:
        best = np.full((h, w), np.inf)
        for c, r in spheres or ():
            c = np.asarray(c, np.float32)
            b = d @ c
            disc = b * b - (c @ c - r * r)
            t = b - np.sqrt(np.maximum(disc, 0))
            best = np.where((disc > 0) & (t > 0) & (t < best), t, best)
        depths.append(np.where(np.isfinite(best), best * d[..., 2], 0.0)
                      .astype(np.float32))
    return depths


def parity_keyframe_sequences():
    """The keyframe parity rows' inputs, at the size of
    tests/test_torch_keyframe_*.py: `keyframe`, tests/test_fusion_e2e.py's
    sphere (1 m, 4 mm a frame back) with a second one sliding in from the
    right (128x128, f = 300 px); `recovery`, that sphere, a frame without
    depth, then the sphere 2 cm to the side; `cluster`,
    tests/test_cluster_filter.py's two components, the second 90%
    occluded in frame 1, its sliver of depth shifted 2 cm (96x160,
    f = 220 px)."""
    import numpy as np

    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    def seq(depths, intr):
        h, w = depths[0].shape
        return ArraySequence([np.full((h, w, 3), 128.0, np.float32)]
                             * len(depths), depths, intr)

    e2e = Intrinsics(300.0, 300.0, 64.0, 64.0)
    appearing = spheres_depths(
        [[((0.0, 0.0, 1.0 + 0.004 * i), 0.1),
          ((0.22 - 0.02 * i, 0.0, 0.95), 0.04)] for i in range(5)],
        128, 128, e2e)
    lost = spheres_depths(
        [[((0.0, 0.0, 1.0), 0.1)], [((0.0, 0.0, 1.004), 0.1)], None,
         [((0.02, 0.0, 1.004), 0.1)]], 128, 128, e2e)
    two = Intrinsics(220.0, 220.0, 80.0, 48.0)
    ca, cb = np.asarray([-0.12, 0.0, 0.6]), np.asarray([0.12, 0.0, 0.6])
    d0, d1 = spheres_depths([[(ca, 0.07), (cb, 0.07)],
                             [(ca + [0, 0, 0.004], 0.07), (cb, 0.07)]],
                            96, 160, two)
    right = np.zeros((96, 160), bool)
    right[:, 80:] = True
    b_pix = (d1 > 0) & right
    rows = np.nonzero(b_pix)[0]
    keep = np.zeros((96, 160), bool)
    rmin = rows.min()
    keep[rmin: rmin + max((rows.max() - rmin) // 10, 2)] = True
    d1 = np.where(b_pix & ~keep, 0.0, d1)
    d1 = np.where(b_pix & keep, d1 + 0.02, d1).astype(np.float32)
    return {"keyframe": seq(appearing, e2e), "recovery": seq(lost, e2e),
            "cluster": seq([d0, d1], two)}


def phase_parity(dev, paths):
    """The ``paths`` among the main path, the envelope, the headline,
    N-ICP (20 Adam iterations), the two perception phases' settings
    (perception: run_fused; perception_stepwise: the stepwise run) and
    flow without MaskNet at a small size
    (tests/test_torch_fusion_slice.py's and tests/test_torch_flow_slice.py's:
    48^3, 128x128, 4 frames; the perception rows on the sphere moving
    sideways too, with the nets in f32, and the row perception_bf16 with
    them in bf16 as the full-size phase runs them) on the card (kernels,
    graph replays) and on the CPU (twins, eager steps): per-frame info
    and node transforms must agree.
    The paths with the matcher run their perception in bf16 or the
    matcher's ops, which round differently in cuDNN and on the CPU, so
    they have limits of their own, about 10x the headline's readings
    (HEADLINE_PARITY_LIMITS); the others PARITY_LIMITS. In the row
    perception_bf16 that rounding moves the deformed points enough to
    change the matcher's near-tie anchors on this input (F9): its limits
    are PERCEPTION_BF16_PARITY_LIMITS, and it prints its witness, the
    gap between the run in bf16 and the same run with the nets in f32
    on the card and on the CPU."""
    import dataclasses

    import numpy as np

    from occlusionfusion_tpu_torch.fusion.pipeline import (
        DynamicFusion,
        FusionConfig,
    )
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_flow_nets,
        load_lepard_checkpoint,
        load_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
    from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig

    small = dict(
        vol_dim=(48, 48, 48), voxel_size=0.008, node_coverage=0.04,
        max_nodes=256, max_points=2048, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=0.04, min_neighbors=2),
    )
    small_headline = headline_config(vol=48, voxel=0.008, max_points=2048,
                                     max_bricks=256, lepard_targets=512)
    gn = dict(iters=6, w_point=1.0, w_arap=10.0, w_motion=1.0)
    grey = sphere_sequence(5, 128, 128, 0.1, 0.004)[0]
    textured = sphere_sequence(5, 128, 128, 0.1, 0.004, textured=True)[0]
    sideways = sphere_sequence(5, 128, 128, 0.1, PERCEPTION["step"],
                               textured=True,
                               lateral=PERCEPTION["lateral"])[0]

    def flow_nets(d, mask=True):
        pwc, mask_net = load_flow_nets(device=d)
        return dict(flow_net=pwc, mask_net=mask_net if mask else None)

    def perception_nets(d, stepwise):
        return dict(headline_nets(d, lepard=False)[1],
                    lepard_net=perception_lepard(d, stepwise))

    def perception_small(stepwise, bf16=False):
        # the nets in f32 but in the row perception_bf16: bf16 rounds
        # otherwise in cuDNN and on the CPU, and that row's limits come
        # from the gap between bf16 and f32 on the CPU (its witness)
        full = perception_config(stepwise)
        return dataclasses.replace(
            small_headline, flow_mode=full.flow_mode,
            flow_downscale=full.flow_downscale,
            flow_mask_patch=full.flow_mask_patch,
            lepard_every=full.lepard_every, flow_bf16=bf16)

    bricked_flow = FusionConfig(solver="gn_dense", gn=GNConfig(**gn),
                                brick_size=8, max_bricks=256, use_flow=True,
                                **small)
    # path: (sequence, config, nets(device), limits, loop)
    cases = {
        "main_path": (grey, FusionConfig(solver="gn_dense",
                                         gn=GNConfig(**gn), **small),
                      lambda d: {}, PARITY_LIMITS, "run_fused"),
        "envelope_flow": (textured, bricked_flow, flow_nets, PARITY_LIMITS,
                          "run_fused"),
        "headline": (textured, small_headline,
                     lambda d: headline_nets(d)[1], HEADLINE_PARITY_LIMITS,
                     "run_fused"),
        "nicp": (grey, FusionConfig(nicp=NICPConfig(iters=20), **small),
                 lambda d: {}, PARITY_LIMITS, "run_fused"),
        "perception": (sideways, perception_small(False),
                       lambda d: perception_nets(d, False),
                       HEADLINE_PARITY_LIMITS, "run_fused"),
        "perception_stepwise": (sideways, perception_small(True),
                                lambda d: perception_nets(d, True),
                                HEADLINE_PARITY_LIMITS, "run"),
        "flow_no_mask": (textured, bricked_flow,
                         lambda d: flow_nets(d, mask=False), PARITY_LIMITS,
                         "run_fused"),
        # the full-size phase's bf16 nets, with the witness printed
        "perception_bf16": (sideways, perception_small(False, bf16=True),
                            lambda d: perception_nets(d, False),
                            PERCEPTION_BF16_PARITY_LIMITS, "run_fused"),
        # block-Jacobi PCG with the 2d_depth rows (K3''s 2d_depth
        # branch); cg, as ns takes most of the phase on the CPU
        "gn_solvers": (grey, FusionConfig(solver="gn_dense", gn=GNConfig(
            **gn, linear_solver="cg", **GN_2D_DEPTH), **small),
            lambda d: {}, PARITY_LIMITS, "run_fused"),
        # N-ICP with the chamfer cost on the default subsample table, at
        # a weight where this small sphere is not chaotic: two CPU runs
        # of it with four threads (another scatter-add order) differ
        # after 4 frames by 5 cm at w_chamfer 1, 2.5e-5 m at 0.1 (the
        # card against the CPU: 4.3 cm), 6.4e-6 m at 0.01 (card against
        # CPU 1.8e-5 m, rotations 1.6e-3: the chamfer's near-tie
        # neighbours turn rounding into rotation about the sphere's
        # centre, as the matcher's do; so the matcher's limits)
        "nicp_costs": (grey, FusionConfig(nicp=NICPConfig(
            iters=20, w_chamfer=0.01), **small),
            lambda d: {}, HEADLINE_PARITY_LIMITS, "run_fused"),
    }
    if any(p in paths for p in ("keyframe", "recovery", "cluster")):
        kf = parity_keyframe_sequences()
        gn0 = dict(gn, w_motion=0.0)
        nicp60 = NICPConfig(iters=60, w_motion=0.0, lr=0.02)
        cases.update({
            # growth with the brick refresh and keyframes, run_fused
            "keyframe": (kf["keyframe"], FusionConfig(
                solver="gn_dense", gn=GNConfig(**gn), brick_size=4,
                max_bricks=1024, growth_interval=2, keyframe_interval=2,
                loop_min_separation=2, **small), lambda d: {},
                PARITY_LIMITS, "run_fused"),
            # a lost track recovered with the matcher's feature seed
            "recovery": (kf["recovery"], FusionConfig(
                nicp=nicp60, use_motion_model=False, keyframe_interval=1,
                loop_min_separation=2, relocalize_recovery=True,
                relocalize_feat_min_points=8, lepard_max_target_points=512,
                **small), lambda d: {"lepard_net": load_lepard_checkpoint(
                    device=d)[0]}, HEADLINE_PARITY_LIMITS, "run"),
            # a starved component frozen (K3' and K4' with frozen nodes)
            "cluster": (kf["cluster"], FusionConfig(
                solver="gn_dense", gn=GNConfig(**gn0), nicp=nicp60,
                use_motion_model=False, min_cluster_matches=400.0,
                **dict(small, node_coverage=0.035, graph=GraphConfig(
                    node_coverage=0.035, min_neighbors=2))),
                lambda d: {}, PARITY_LIMITS, "run"),
        })

    def run_on(d, seq, cfg, nets_of, loop):
        f = DynamicFusion(seq, cfg, device=d, **nets_of(d))
        return f, getattr(f, loop)(
            motion_net=load_motion_complete_net(device=d))

    def gap(a, b):
        (fa, ia), (fb, ib) = a, b
        n = fb.node_count
        assert fa.node_count == n
        dts = np.abs(fa.warp.translations[:n].cpu().numpy()
                     - fb.warp.translations[:n].cpu().numpy())
        dR = float(np.abs(fa.warp.rotations[:n].cpu().numpy()
                          - fb.warp.rotations[:n].cpu().numpy()).max())

        def info_diff(key):
            return max(abs(x[key] - y[key]) for x, y in zip(ia, ib))

        return {"max_dt_m": float(dts.max()),
                "median_dt_m": float(np.median(dts)), "max_dR": dR,
                "max_dconf": info_diff("mean_confidence"),
                "max_dcorr": info_diff("n_correspondences"),
                "max_dflow": info_diff("n_flow_filled"),
                "max_dlepard": info_diff("n_lepard_matches")}

    for path in paths:
        seq, cfg, nets_of, limits, loop = cases[path]
        runs = {d: run_on(d, seq, cfg, nets_of, loop) for d in (dev, "cpu")}
        (fg, ig), (fc, ic) = runs[dev], runs["cpu"]
        n = fc.node_count
        got = gap(runs[dev], runs["cpu"])
        witness = None
        if path == "perception_bf16":
            f32 = dataclasses.replace(cfg, flow_bf16=False)
            witness = {d: gap(runs[d], run_on(d, seq, f32, nets_of, loop))
                       for d in (dev, "cpu")}
        emit({"phase": "parity", "path": path, "loop": loop, "nodes": n,
              **got, "limits": limits, "witness_bf16_vs_f32": witness,
              "flow_filled_card": [i["n_flow_filled"] for i in ig],
              "flow_filled_cpu": [i["n_flow_filled"] for i in ic],
              "lepard_matches_card": [i["n_lepard_matches"] for i in ig],
              "lepard_matches_cpu": [i["n_lepard_matches"] for i in ic]})
        assert all(got[k] <= v for k, v in limits.items()), (path, got)
        if cfg.use_flow:
            assert sum(i["n_flow_filled"] for i in ig) > 0, "no flow fill"
        if path in ("headline", "perception", "perception_bf16"):
            assert sum(i["n_lepard_matches"] for i in ig) > 0, "no matches"
        if cfg.use_lepard:
            assert all(i["n_lepard_matches"] == 0 for i in ig
                       if i["frame"] % cfg.lepard_every), ig
        if path == "keyframe":
            assert [i.get("n_new_nodes") for i in ig] == [
                i.get("n_new_nodes") for i in ic], (ig, ic)
            assert ig[-1]["n_new_nodes"] > 0, ig
            np.testing.assert_array_equal(fg.brick_ids, fc.brick_ids)
        if path == "recovery":
            assert [i["reloc_feat_matches"] for i in ig] == [
                i["reloc_feat_matches"] for i in ic], (ig, ic)
            assert ig[2]["reloc_feat_matches"] >= 8 and not fg.track_lost
            assert abs(ig[2]["pose_correction"]
                       - ic[2]["pose_correction"]) <= 1e-4, (ig, ic)
        if path == "cluster":
            t = fg.warp.translations[:n].cpu().numpy()
            is_b = fg.nodes[:n, 0].cpu().numpy() > 0.0
            assert np.abs(t[is_b]).max() == 0.0 and np.abs(
                t[~is_b]).max() > 1e-3


def nicp_config(vol=VOL, voxel=VOXEL, max_points=MAX_POINTS,
                iters=NICP_ITERS, max_bricks=NICP_MAX_BRICKS):
    """The JAX FusionConfig defaults (solver "nicp" with
    NICPConfig(iters), the motion GNN, brick_size -1: bricks of 8 at
    128^3, dense below) with the main path's sphere settings."""
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig

    cfg = FusionConfig(
        vol_dim=(vol, vol, vol), voxel_size=voxel, node_coverage=COVERAGE,
        max_nodes=MAX_NODES, max_points=max_points, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=COVERAGE, min_neighbors=2),
        nicp=NICPConfig(iters=iters), max_bricks=max_bricks,
    )
    assert cfg.solver == "nicp" and cfg.brick_size == -1
    return cfg


def keyframe_sequence(n_frames=KEYFRAME_FRAMES + 1, h=IMG_H, w=IMG_W,
                      distance=DISTANCE):
    """The keyframe phases' input: an ellipsoid (KEYFRAME_AXES) at
    ``distance`` receding STEP_Z a frame until frame KEYFRAME_TURN, then
    coming back, and a sphere (KEYFRAME_SECOND) sliding in from the right,
    out of view at frame 0, until it stops beside the ellipsoid and moves
    in depth with it; ray-cast in closed form, flat grey. Returns the
    sequence and the ellipsoid's centres."""
    import numpy as np

    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    intr = Intrinsics(2.3 * w, 2.3 * w, w / 2, h / 2)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy,
                  np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sec = KEYFRAME_SECOND
    depths, centers = [], []
    for i in range(n_frames):
        c = np.array([0.0, 0.0, distance
                      + STEP_Z * (KEYFRAME_TURN - abs(KEYFRAME_TURN - i))])
        c2 = np.array([max(sec["x_stop"], sec["x0"] + sec["dx"] * i), 0.0,
                       c[2]])
        best = np.full((h, w), np.inf)
        for ci, axes in ((c, KEYFRAME_AXES), (c2, (sec["radius"],) * 3)):
            # |(t d - c) / axes| = 1, the nearest root
            ds, cs = d / np.asarray(axes), ci / np.asarray(axes)
            a = np.sum(ds * ds, -1)
            b = ds @ cs
            disc = b * b - a * (cs @ cs - 1.0)
            t = (b - np.sqrt(np.maximum(disc, 0))) / a
            best = np.where((disc > 0) & (t > 0) & (t < best), t, best)
        depths.append(np.where(np.isfinite(best), best * d[..., 2], 0.0)
                      .astype(np.float32))
        centers.append(c)
    colors = [np.full((h, w, 3), 128.0, np.float32)] * n_frames
    return ArraySequence(colors, depths, intr), centers


def keyframe_config(stepwise=False, **kw):
    """The JAX FusionConfig defaults (N-ICP with 100 iterations, the
    motion GNN, bricks of 8 in 2048 slots over 128^3 at 5 mm, node
    coverage 0.05 m, a 512-node cap, 8192 points) with the keyframe
    phases' intervals."""
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig

    if stepwise:
        kw = {**KEYFRAME_STEPWISE, **kw}
    else:
        kw = dict(growth_interval=KEYFRAME_GROWTH,
                  keyframe_interval=KEYFRAME_INTERVAL, **kw)
    cfg = FusionConfig(**kw)
    assert (cfg.solver, cfg.nicp.iters, cfg.vol_dim, cfg.max_nodes) == (
        "nicp", NICP_ITERS, (VOL,) * 3, MAX_NODES)
    return cfg


def main_node_median(nodes, translations, n, center):
    """The median translation of the nodes within KEYFRAME_MAIN_RADIUS
    (in units of KEYFRAME_AXES) of the ellipsoid's centre (canonical
    space)."""
    import numpy as np

    g = nodes[:n]
    main = np.linalg.norm((g - np.asarray(center)) / np.asarray(
        KEYFRAME_AXES), axis=1) < KEYFRAME_MAIN_RADIUS
    return np.median(translations[:n][main], axis=0), int(main.sum())


def check_against_reference(med_z, infos, ref_z, ref_corr):
    """Median node z within 1 mm of the JAX package's, each frame's
    correspondences within NICP_CORRESPONDENCE_TOL of its."""
    import numpy as np

    assert len(infos) == N_FRAMES
    assert all(i["solve_valid"] for i in infos), infos
    assert all(np.isfinite(i["final_loss"]) for i in infos), infos
    assert abs(med_z - ref_z) <= 1e-3, (med_z, ref_z)
    got = [i["n_correspondences"] for i in infos]
    assert all(abs(a - b) <= NICP_CORRESPONDENCE_TOL * b
               for a, b in zip(got, ref_corr)), (got, ref_corr)


def phase_nicp_path(dev, profile=False):
    """The JAX defaults (nicp_config) on the main path's sphere through
    run_fused(chunk=16) (N-ICP: one captured step, replayed per frame)
    and get_deformed_mesh, with the launch counts set to 0 just before and
    read just after, held to the JAX package's result; K1's and K2's
    inputs kept (initialize; the warm-up step before capture). Then the
    graph checks from a fresh initialize (graph_case, at the frames
    NICP_CHECK_FRAMES) and, with ``profile``, one traced frame. Returns
    the launch counts and the kernel rows on this path's inputs."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE)
    net = load_motion_complete_net(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    fusion = DynamicFusion(seq, nicp_config(), device=dev)
    with KernelInputTap(1) as ktap:
        infos = fusion.run_fused(chunk=CHUNK, motion_net=net)
        verts, faces = fusion.get_deformed_mesh()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    (graph,) = fusion.graphs.values()
    n = fusion.node_count
    med = np.median(fusion.warp.translations[:n].cpu().numpy(), axis=0)
    motion = centers[-1] - centers[0]
    out = {
        "phase": "nicp_path", "wall_s": wall, "capture_s": graph.capture_s,
        "graph_steps": graph.steps, "frames": len(infos), "nodes": n,
        "model_points": fusion.model_point_count,
        "active_bricks": int((fusion.brick_ids >= 0).sum()),
        "voxel_slots": int(fusion.vox_points.shape[0]),
        "valid_voxels": int(fusion.vox_table.valid.sum()),
        "mesh_vertices": int(verts.shape[0]),
        "median_node_translation": med.tolist(),
        "reference_median_z": NICP_REFERENCE_Z,
        "tracking_error_z_m": float(med[2] - motion[2]),
        "sphere_motion": motion.tolist(),
        "n_correspondences": [i["n_correspondences"] for i in infos],
        "reference_n_correspondences": NICP_REFERENCE_CORRESPONDENCES,
        "final_loss": [i["final_loss"] for i in infos],
        "launches": counts, "launches_per_replay": graph.counts,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
    }
    try:
        check_against_reference(med[2], infos, NICP_REFERENCE_Z,
                                NICP_REFERENCE_CORRESPONDENCES)
        assert not fusion.track_lost
        assert np.isfinite(verts).all() and faces.shape[0] > 0
        assert fusion.brick_size == 8 and 200 <= n <= MAX_NODES, n
        assert graph.steps == 1
        # K1: initialize (voxel slots, model points) and the mesh; K2 in
        # every replayed frame plus the warm-up step before capture
        assert graph.counts == {"knn": 0, "lbs_warp": 1,
                                "point_term_blocks": 0,
                                "arap_term_blocks": 0}, graph.counts
        assert counts == {"knn": 3, "lbs_warp": N_FRAMES + 1,
                          "point_term_blocks": 0,
                          "arap_term_blocks": 0}, counts
    finally:
        emit(out)
    rows = []
    for P in (int(fusion.vox_points.shape[0]),
              int(fusion.model_points.shape[0])):
        q, refs, _, valid = ktap.knn[P]
        rows.append(knn_row(f"nicp_path_initialize_P{P}", q, refs, valid)[0])
    rows.append(lbs_row("nicp_path_warmup_frame_1", *ktap.lbs))
    del ktap
    # the graph checks, from a fresh initialize
    fusion.initialize(seq.load(0))
    sc, state0, tables = fusion.build_fused(net)
    depths, colors = frames_on(dev, seq, range(1, N_FRAMES + 1))
    graph_case("nicp_path", fusion, sc, state0, tables, net, depths, colors,
               check=NICP_CHECK_FRAMES, max_limits=False,
               rate_frames=NICP_RATE_FRAMES, full_eager=False)
    if profile:
        (step,) = [g for k, g in fusion.graphs.items()
                   if k[0] == sc and k[5] == id(tables)]
        with profiled(True) as prof:
            t0 = time.perf_counter()
            step.replay(state0, depths[:1], colors[:1])
            torch.cuda.synchronize()
            t_window = time.perf_counter() - t0
        report_profile(prof, t_window, "nicp_path_graph_replay", 1)
    del fusion, sc, state0, tables
    torch.cuda.empty_cache()
    return counts, rows


def phase_stepwise(dev):
    """The N-ICP path's input through the stepwise loop
    (DynamicFusion.run, one eager register_frame a frame), with the launch
    counts set to 0 just before and read just after, held to the JAX
    package's stepwise result. Returns the launch counts and the N-ICP
    solve's input at frame TAP_FRAME."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE)
    net = load_motion_complete_net(device=dev)
    fusion = DynamicFusion(seq, nicp_config(), device=dev)
    # each frame's seconds: register_frame reads its info back, so a
    # frame has ended on the card when it returns
    times, register = [], fusion.register_frame

    def timed(frame, motion_net=None):
        t = time.perf_counter()
        if frame.index == KEYFRAME_RESUME_CHECK_FRAME:
            with tap:
                info = register(frame, motion_net)
        else:
            info = register(frame, motion_net)
        times.append(time.perf_counter() - t)
        return info

    fusion.register_frame = timed
    torch.cuda.synchronize()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    with SolveTap(TAP_FRAME, "nicp_solve") as tap:
        infos = fusion.run(motion_net=net)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    n = fusion.node_count
    med = np.median(fusion.warp.translations[:n].cpu().numpy(), axis=0)
    motion = centers[-1] - centers[0]
    out = {
        "phase": "stepwise", "wall_s": wall, "frames": len(infos),
        "nodes": n, "init_s": wall - sum(times),
        "frames_per_s": N_FRAMES / sum(times),
        "frames_per_s_after_first": (N_FRAMES - 1) / sum(times[1:]),
        "median_node_translation": med.tolist(),
        "reference_median_z": STEPWISE_REFERENCE_Z,
        "tracking_error_z_m": float(med[2] - motion[2]),
        "n_correspondences": [i["n_correspondences"] for i in infos],
        "launches": counts,
    }
    try:
        check_against_reference(med[2], infos, STEPWISE_REFERENCE_Z,
                                STEPWISE_REFERENCE_CORRESPONDENCES)
        assert not fusion.track_lost
        assert counts == {"knn": 2, "lbs_warp": N_FRAMES,
                          "point_term_blocks": 0,
                          "arap_term_blocks": 0}, counts
        assert tap.call is not None
    finally:
        emit(out)
    return counts, tap.call


def rotation_angle(Ra, Rb):
    """The angle (rad) of Ra^T Rb."""
    import numpy as np

    c = (np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def check_keyframe_reference(out, infos, ref, exact_until):
    """The keyframe phases' checks against the JAX package's run (ref).
    Up to frame ``exact_until`` (the first growth's, and in the stepwise
    loop its keyframes' loop closures), as JAX: each growth's new nodes
    and bricks equal, the correspondences within NICP_CORRESPONDENCE_TOL,
    the loop closures equal, the keyframe poses within 1 mm and 1e-3 rad
    (fused only). Later the grown nodes, which no model point anchors,
    make the run chaotic on the card itself (ROADMAP F12): each growth's
    counts, the node and brick counts, the main nodes' median translation
    and the correspondences within KEYFRAME_SPREAD_LIMITS of JAX's, limits
    three times the largest gap between the card's own runs."""
    import numpy as np

    lim = KEYFRAME_SPREAD_LIMITS[out["phase"]]
    assert all(i["solve_valid"] for i in infos), infos
    keys = ("frame", "n_new_nodes", "n_new_bricks")
    got = [tuple(g[k] for k in keys) for g in out["growth"]]
    want = [tuple(g[k] for k in keys) for g in ref["growth"]]
    assert [g[0] for g in got] == [g[0] for g in want], (got, want)
    assert any(g[1] for g in got) and any(g[2] for g in got), got
    for g, w in zip(got, want):
        tol = (0, 0) if g[0] <= exact_until else (lim["growth_nodes"],
                                                  lim["growth_bricks"])
        assert abs(g[1] - w[1]) <= tol[0] and abs(g[2] - w[2]) <= tol[1], (
            got, want)
    assert abs(out["nodes"] - ref["nodes"]) <= lim["nodes"]
    assert abs(out["active_bricks"] - ref["active_bricks"]) <= lim[
        "active_bricks"]
    corr = np.asarray([i["n_correspondences"] for i in infos])
    rel = np.abs(corr - ref["n_correspondences"]) / np.asarray(
        ref["n_correspondences"])
    frames = np.asarray([i["frame"] for i in infos])
    early = frames <= exact_until
    assert rel[early].max() <= NICP_CORRESPONDENCE_TOL, rel
    assert rel[~early].max() <= lim["correspondences"], rel
    dm = np.abs(np.asarray(out["main_median_translation"])
                - ref["main_median_translation"])
    assert dm.max() <= lim["main_median_m"], dm
    traj = ref["trajectory"]
    assert out["trajectory"]["frames"] == traj["frames"]
    loops = [(k["frame"], k["loop_closures"]) for k in out["keyframes"]]
    want_loops = [(k["frame"], k["loop_closures"]) for k in ref["keyframes"]]
    assert [x for x in loops if x[0] <= exact_until] == [
        x for x in want_loops if x[0] <= exact_until], (loops, want_loops)
    if out["phase"] == "keyframe_path":
        for f, Ra, Rb, ta, tb in zip(traj["frames"], out["trajectory"]["R"],
                                     traj["R"], out["trajectory"]["t"],
                                     traj["t"]):
            if f <= exact_until:
                assert rotation_angle(Ra, Rb) <= 1e-3, f
                assert np.abs(np.asarray(ta) - tb).max() <= 1e-3, f


def keyframe_outcome(fusion, infos, centers):
    """The keyframe phases' readings of a run."""
    import numpy as np

    n = fusion.node_count
    med, n_main = main_node_median(fusion.nodes.cpu().numpy(),
                                   fusion.warp.translations.cpu().numpy(),
                                   n, centers[0])
    ids, R, t = fusion.trajectory()
    return {
        "nodes": n, "main_nodes": n_main,
        "active_bricks": int((fusion.brick_ids >= 0).sum()),
        "main_median_translation": med.tolist(),
        "trajectory": {"frames": ids.tolist(), "R": R.tolist(),
                       "t": t.tolist()},
        "keyframes": [{k: i[k] for k in ("frame", "pose_correction",
                                         "loop_closures",
                                         "reloc_feat_matches")}
                      for i in infos if "loop_closures" in i],
        "n_correspondences": [i["n_correspondences"] for i in infos],
    }


def label_growth(fusion, tap):
    """Label the k-NN calls of ``fusion``'s growth keyframes in ``tap``:
    the refresh's (brick centres, voxel slots) and the growth's (voxel
    slots, model points), each with its frame; and record each refresh's
    new bricks in the returned list."""
    refreshes = []
    refresh, grow = fusion._refresh_bricks, fusion._grow

    def labelled_refresh(frame):
        tap.label = f"refresh_frame_{frame.index}"
        n = refresh(frame)
        refreshes.append({"frame": frame.index, "n_new_bricks": n})
        tap.label = f"growth_frame_{frame.index}"
        return n

    def labelled_grow(frame):
        tap.label = f"growth_frame_{frame.index}"
        try:
            return grow(frame)
        finally:
            tap.label = "after_growth"

    fusion._refresh_bricks = labelled_refresh
    fusion._grow = labelled_grow
    return refreshes


def phase_keyframe_path(dev, checks=True):
    """The N-ICP path's settings with growth and keyframes every 16th
    frame (keyframe_config) on keyframe_sequence through
    run_fused(chunk=16) over KEYFRAME_FRAMES frames and
    get_deformed_mesh, the launch counts set to 0 just before and read
    just after, held to the JAX package's run (KEYFRAME_REFERENCE,
    check_keyframe_reference); K1's inputs kept for every call (the
    initialize, each refresh and growth, the mesh) and K2's of the last
    step outside a capture (the warm-up of the graph captured on the
    grown tables). Prints frames/s, each growth keyframe's host seconds
    and its recapture's, initialize seconds and peak memory. Returns the
    launch counts and the kernel rows on these inputs (none, and no
    check, without ``checks``)."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = keyframe_sequence()
    net = load_motion_complete_net(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fusion = DynamicFusion(seq, keyframe_config(), device=dev)
    init = fusion.initialize
    init_s = []

    def timed_init(frame):
        t = time.perf_counter()
        init(frame)
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t)

    fusion.initialize = timed_init
    D.reset_launch_counts()
    t0 = time.perf_counter()
    with KernelInputTap(None, keep_all=True) as ktap:
        ktap.label = "initialize"
        refreshes = label_growth(fusion, ktap)
        infos = fusion.run_fused(chunk=CHUNK, motion_net=net)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        ktap.label = "get_deformed_mesh"
        verts, faces = fusion.get_deformed_mesh()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    growth = [{k: g[k] for k in ("frame", "n_new_nodes", "n_new_bricks",
                                 "grow_s", "rebuild_s", "capture_s")}
              for g in fusion.growth_log]
    assert [g["n_new_bricks"] for g in growth] == [
        r["n_new_bricks"] for r in refreshes]
    out = {"phase": "keyframe_path", "wall_s": wall, "frames": len(infos),
           "initialize_s": init_s[0],
           "frames_per_s": len(infos) / (run_s - init_s[0]),
           "growth": growth, "graphs_kept": len(fusion.graphs),
           "mesh_vertices": int(verts.shape[0]),
           **keyframe_outcome(fusion, infos, centers),
           "reference": {k: KEYFRAME_REFERENCE[k] for k in (
               "growth", "nodes", "active_bricks",
               "main_median_translation")},
           "final_loss": [i["final_loss"] for i in infos],
           "launches": counts,
           "peak_mem_bytes": int(torch.cuda.max_memory_allocated())}
    if not checks:
        emit(out)
        return counts, []
    rows = [knn_row(f"keyframe_path_{label}_P{P}", q, refs, valid)[0]
            for label, P, (q, refs, _, valid) in ktap.calls
            if label not in ("initialize", "get_deformed_mesh")]
    rows.append(lbs_row("keyframe_path_grown_table_warmup", *ktap.lbs))
    try:
        check_keyframe_reference(out, infos, KEYFRAME_REFERENCE,
                                 KEYFRAME_GROWTH)
        assert np.isfinite(verts).all() and faces.shape[0] > 0
        assert not fusion.track_lost
        # K1: initialize (slots, points), each refresh (brick centres;
        # the slots where it added bricks), each growth that added nodes
        # (slots, points) and the mesh; K2: every replayed frame and the
        # warm-up step of each graph (one per table set: a rebuild takes
        # a new graph, and the old one is dropped)
        rebuilds = sum(1 for g in growth[:-1]
                       if g["n_new_nodes"] or g["n_new_bricks"])
        n_knn = 3 + sum(1 + (g["n_new_bricks"] > 0)
                        + 2 * (g["n_new_nodes"] > 0) for g in growth)
        assert counts == {"knn": n_knn, "lbs_warp": len(infos) + 1
                          + rebuilds, "point_term_blocks": 0,
                          "arap_term_blocks": 0}, counts
        # the graph of each table set is dropped at the next rebuild:
        # none is left after a rebuild at the last frame
        assert len(fusion.graphs) == int(not (
            growth[-1]["n_new_nodes"] or growth[-1]["n_new_bricks"])), (
            len(fusion.graphs))
        assert len(ktap.calls) == n_knn
        assert rows[-1]["N"] == MAX_NODES
    finally:
        emit(out)
    del ktap, fusion
    torch.cuda.empty_cache()
    return counts, rows


def map_tensors(tree, fn):
    """``tree`` (tuples, NamedTuples, lists, dicts) with ``fn`` applied
    to every tensor leaf; other leaves kept as they are."""
    import torch

    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(x, fn) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(x, fn) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    return tree


def tree_differences(a, b, path="args"):
    """The paths at which two argument trees differ: tensors by dtype,
    shape and every bit, NamedTuples field by field, networks (objects
    with parameters) by identity, other leaves by ==."""
    import torch

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
        return [] if same else [path]
    if type(a) is not type(b):
        return [path]
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return [d for f in a._fields for d in tree_differences(
            getattr(a, f), getattr(b, f), f"{path}.{f}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in tree_differences(x, y, f"{path}[{i}]")]
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            return [path]
        return [d for k in a for d in tree_differences(a[k], b[k],
                                                       f"{path}.{k}")]
    if hasattr(a, "parameters"):
        return [] if a is b else [path]
    return [] if a == b else [path]


class StepArgumentTap:
    """While entered, record (cloned) the arguments of every call the
    stepwise loop makes to the fused step (``pipeline.fused_register_
    frame``), so that a resumed run's step can be compared with the
    uninterrupted run's and replayed."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from occlusionfusion_tpu_torch.fusion import pipeline

        self._step = pipeline.fused_register_frame

        def tapped(*args, **kwargs):
            self.calls.append(map_tensors((args, kwargs),
                                          lambda t: t.clone()))
            return self._step(*args, **kwargs)

        pipeline.fused_register_frame = tapped
        return self

    def __exit__(self, *exc):
        from occlusionfusion_tpu_torch.fusion import pipeline

        pipeline.fused_register_frame = self._step


def deterministic_step(call):
    """Run the fused step once more on a copy of recorded arguments with
    torch's deterministic algorithms (the scatter-adds of N-ICP's backward
    in a fixed order) -> ((rotations, translations, tsdf), the messages of
    the ops that have no deterministic version)."""
    import warnings

    import torch

    from occlusionfusion_tpu_torch.fusion.fused_step import (
        fused_register_frame,
    )

    args, kwargs = map_tensors(call, lambda t: t.clone())
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, _ = fused_register_frame(*args, **kwargs)
            if state.rotations.is_cuda:
                torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(before)
    return ((state.rotations, state.translations, state.tsdf.tsdf),
            sorted({str(w.message).split("\n")[0][:160] for w in caught}))


def keyframe_case_quantize(flat):
    """A save_state snapshot's flat arrays -> the growth case's ``in/``
    arrays: the TSDF as int16 (KEYFRAME_CASE_TSDF_Q), the weights and
    colours (whole numbers: frame counts, and the flat grey's 128 or 0)
    as uint16, everything else as it is."""
    import numpy as np

    case = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k == "tsdf/tsdf":
            case["in/tsdf/tsdf_q"] = np.round(
                v * KEYFRAME_CASE_TSDF_Q).astype(np.int16)
        elif k in ("tsdf/weight", "tsdf/color"):
            assert np.array_equal(v, np.round(v)) and 0 <= v.min() and (
                v.max() < 65536), k
            case[f"in/{k}_u16"] = v.astype(np.uint16)
        else:
            case[f"in/{k}"] = v
    return case


def keyframe_case_snapshot(case, path):
    """Write the growth case's input (``in/`` arrays of
    keyframe_case_quantize, dequantized) as a save_state snapshot at
    ``path``, which either package's load_state reads."""
    import numpy as np

    flat = {}
    for key in case:
        if not key.startswith("in/"):
            continue
        v, k = np.asarray(case[key]), key[3:]
        if k == "tsdf/tsdf_q":
            flat["tsdf/tsdf"] = (v.astype(np.float32)
                                 / np.float32(KEYFRAME_CASE_TSDF_Q))
        elif k.endswith("_u16"):
            flat[k[:-4]] = v.astype(np.float32)
        else:
            flat[k] = v
    np.savez(path, **flat)


def node_gaps(a, b, n):
    """The median node's translation gap (largest axis of the medians'
    difference), the STEP_PERCENTILE-th percentile of the node translation
    and rotation gaps and the largest translation gap between two
    (rotations, translations) pairs over the first ``n`` nodes."""
    import numpy as np

    Ra, ta = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)[:n]
              for x in a)
    Rb, tb = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)[:n]
              for x in b)
    dt = np.linalg.norm(ta - tb, axis=1)
    dR = np.abs(Ra - Rb).reshape(n, -1).max(1)
    return {"median_dt_m": float(np.abs(np.median(ta, 0)
                                        - np.median(tb, 0)).max()),
            "p_dt_m": float(np.percentile(dt, STEP_PERCENTILE)),
            "p_dR": float(np.percentile(dR, STEP_PERCENTILE)),
            "max_dt_m": float(dt.max())}


def phase_keyframe_growth_case(dev, checks=True):
    """keyframe_path's growth keyframe at KEYFRAME_CASE_FRAME on exactly
    the JAX package's input (KEYFRAME_CASE_NPZ): load_state of that
    state, the growth (refresh + grow), then the next frame through
    run_fused's engine on the rebuilt tables (a graph captured there and
    replayed twice from the same state, and one eager step), held to
    JAX's results on that input (see KEYFRAME_CASE_FRAME). Without
    ``checks`` the readings only."""
    import tempfile

    import numpy as np
    import torch

    from occlusionfusion_tpu_torch.fusion.fused_step import (
        fused_register_chunk,
        lepard_gate,
    )
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    case = np.load(KEYFRAME_CASE_NPZ)
    frame = KEYFRAME_CASE_FRAME
    seq, _ = keyframe_sequence(frame + 2)
    net = load_motion_complete_net(device=dev)
    fusion = DynamicFusion(seq, keyframe_config(), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.npz")
        keyframe_case_snapshot(case, path)
        fusion.load_state(path)
    torch.cuda.synchronize()
    t = time.perf_counter()
    n_new = fusion._grow(seq.load(frame))
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t
    n = fusion.node_count
    ref = {k[4:]: case[k] for k in case.files if k.startswith("out/")}
    out = {"phase": "keyframe_growth_case", "frame": frame,
           "grow_s": grow_s,
           "n_new_nodes": [n_new, int(ref["n_new_nodes"])],
           "n_new_bricks": [fusion.n_new_bricks, int(ref["n_new_bricks"])],
           "node_count": [n, int(ref["node_count"])]}
    same_table = (np.array_equal(fusion.brick_ids, ref["brick_ids"])
                  and n == int(ref["node_count"]))
    out["brick_ids_equal"] = bool(np.array_equal(fusion.brick_ids,
                                                 ref["brick_ids"]))
    if same_table:
        out["edges_equal"] = bool(np.array_equal(
            fusion.edges.cpu().numpy()[:n], ref["edges"][:n]))
        out["nodes_max_m"] = float(np.abs(
            fusion.nodes.cpu().numpy()[:n] - ref["nodes"][:n]).max())
        out["edge_weights_max"] = float(np.abs(
            fusion.edge_weights.cpu().numpy()[:n]
            - ref["edge_weights"][:n]).max())
        out["grown"] = node_gaps(
            (fusion.warp.rotations, fusion.warp.translations),
            (ref["grown_rotations"], ref["grown_translations"]), n)
    # the next frame on the rebuilt tables, from the carried history
    sc, state, tables = fusion.build_fused(net)
    state = state._replace(motion=fusion._resume_motion)
    nxt = seq.load(frame + 1)
    depths = torch.as_tensor(nxt.depth, device=dev)[None]
    colors = torch.as_tensor(nxt.color, device=dev)[None]
    graphs, steps = {}, []
    t = time.perf_counter()
    for _ in range(2):
        s, info = fused_register_chunk(
            sc, state, tables, net, depths, colors, fusion.intr,
            *fusion._perception(), graphs=graphs,
            lepard_on=lepard_gate(sc, [frame + 1]))
        steps.append(((s.rotations.clone(), s.translations.clone()),
                      info[0].cpu().numpy()))
        if len(steps) == 1:
            torch.cuda.synchronize()
            out["capture_and_step_s"] = time.perf_counter() - t
    s, info = fusion.register_frame_fused(sc, state, tables, nxt, net)
    eager = ((s.rotations, s.translations), info.cpu().numpy())
    (graph_rt, graph_info), (again_rt, _) = steps
    out["n_correspondences"] = [int(graph_info[1]), int(eager[1][1]),
                                int(ref["step_info"][1])]
    out["step"] = node_gaps(graph_rt, (ref["step_rotations"],
                                       ref["step_translations"]), n)
    out["step_graph_vs_graph"] = node_gaps(graph_rt, again_rt, n)
    out["step_graph_vs_eager"] = node_gaps(graph_rt, eager[0], n)
    del graphs, state, tables, fusion
    torch.cuda.empty_cache()
    emit(out)
    if not checks:
        return
    assert out["n_new_nodes"][0] == out["n_new_nodes"][1] > 0, out
    assert out["n_new_bricks"][0] == out["n_new_bricks"][1], out
    assert same_table and out["edges_equal"], out
    assert out["nodes_max_m"] <= KEYFRAME_CASE_NODE_TOL, out
    assert out["edge_weights_max"] <= KEYFRAME_CASE_NODE_TOL, out
    assert out["grown"]["max_dt_m"] <= KEYFRAME_CASE_NODE_TOL, out
    got, ref_corr = out["n_correspondences"][0], out["n_correspondences"][2]
    assert abs(got - ref_corr) <= NICP_CORRESPONDENCE_TOL * ref_corr, out
    spread = {k: max(out["step_graph_vs_graph"][k],
                     out["step_graph_vs_eager"][k])
              for k in ("median_dt_m", "p_dt_m", "p_dR")}
    lim = {"median_dt_m": STEP_MEDIAN_LIMIT,
           "p_dt_m": STEP_PERCENTILE_LIMITS["dt_m"],
           "p_dR": STEP_PERCENTILE_LIMITS["dR"]}
    assert all(out["step"][k] <= max(v, 3 * spread[k])
               for k, v in lim.items()), (out["step"], spread)


def phase_keyframe_stepwise(dev, checks=True):
    """keyframe_sequence through the stepwise loop (DynamicFusion.run over
    KEYFRAME_STEPWISE_FRAMES frames, keyframes every 2nd and growth every
    8th frame), the launch counts set to 0 just before and read just
    after, with a rigid KEYFRAME_DRIFT offset left-composed into the warp
    before the keyframe work of frame KEYFRAME_DRIFT_FRAME and a
    save_state at frame KEYFRAME_SAVE_FRAME; held to the JAX package's
    run (KEYFRAME_STEPWISE_REFERENCE): at least one loop closure, the
    drift's correction above 1e-3 and within 1e-3 of JAX's, the model's
    error after it below 0.35x the error before, and
    check_keyframe_reference's checks (exact up to frame
    KEYFRAME_STEPWISE_EXACT). Then the snapshot is loaded into two fresh
    objects, each of which runs on to frame KEYFRAME_RESUME_CHECK_FRAME:
    the fused step of that frame must get the uninterrupted run's
    arguments bit for bit (StepArgumentTap, tree_differences), and run
    again with torch's deterministic algorithms (deterministic_step) the
    uninterrupted run's step must repeat itself and equal the resumed
    one bit for bit, with no op lacking a deterministic version. The
    gaps of the runs as they ran are printed. Without ``checks`` the
    readings only."""
    import tempfile
    import types

    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion import warpfield as W
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = keyframe_sequence(KEYFRAME_STEPWISE_FRAMES + 1)
    net = load_motion_complete_net(device=dev)
    cfg = keyframe_config(stepwise=True)
    fusion = DynamicFusion(seq, cfg, device=dev)

    def centroid():
        pts = W.deform_points(fusion.warp, fusion.model_points,
                              fusion.point_table)
        valid = fusion.model_valid & fusion.point_table.valid
        return pts[valid].mean(0).cpu().numpy()

    drift, record = {}, fusion._record_keyframe

    def drifted(frame):
        if frame.index == KEYFRAME_DRIFT_FRAME:
            drift["true"] = centroid()
            fusion.warp = W.left_compose_rigid(
                fusion.warp, torch.eye(3, device=fusion.device),
                torch.tensor(KEYFRAME_DRIFT, device=fusion.device))
            drift["before"] = float(np.linalg.norm(centroid()
                                                   - drift["true"]))
        return record(frame)

    fusion._record_keyframe = drifted
    refreshes = label_growth(fusion, types.SimpleNamespace(label=""))
    tmp = tempfile.TemporaryDirectory()
    snapshot = os.path.join(tmp.name, "state.npz")
    times, register, uninterrupted = [], fusion.register_frame, []
    tap = StepArgumentTap()

    def timed(frame, motion_net=None):
        t = time.perf_counter()
        if frame.index == KEYFRAME_RESUME_CHECK_FRAME:
            with tap:
                info = register(frame, motion_net)
        else:
            info = register(frame, motion_net)
        times.append(time.perf_counter() - t)
        if frame.index == KEYFRAME_DRIFT_FRAME:
            drift["after"] = float(np.linalg.norm(centroid()
                                                  - drift.pop("true")))
            drift["pose_correction"] = info["pose_correction"]
        if frame.index == KEYFRAME_SAVE_FRAME:
            fusion.save_state(snapshot)
        if frame.index == KEYFRAME_RESUME_CHECK_FRAME:
            uninterrupted.append(fusion.warp)
        return info

    fusion.register_frame = timed
    torch.cuda.synchronize()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    infos = fusion.run(motion_net=net)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    ref = KEYFRAME_STEPWISE_REFERENCE
    growth = [{"frame": i["frame"], "n_new_nodes": i["n_new_nodes"],
               "n_new_bricks": r["n_new_bricks"]}
              for i, r in zip([i for i in infos if i["frame"]
                               % KEYFRAME_STEPWISE["growth_interval"] == 0],
                              refreshes)]
    out = {"phase": "keyframe_stepwise", "wall_s": wall,
           "frames": len(infos), "initialize_s": wall - sum(times),
           "frames_per_s": len(infos) / sum(times),
           "drift": drift, "reference_drift": ref["drift"],
           "growth": growth, **keyframe_outcome(fusion, infos, centers),
           "launches": counts}
    # the snapshot resumed twice, against the uninterrupted run
    resumed = []
    for _ in range(2):
        f = DynamicFusion(seq, cfg, device=dev)
        f.load_state(snapshot)
        with tap:
            for i in range(KEYFRAME_SAVE_FRAME + 1,
                           KEYFRAME_RESUME_CHECK_FRAME + 1):
                f.register_frame(seq.load(i), net)
        resumed.append(f)
    # the fused step's arguments at the checked frame: the uninterrupted
    # run's, then each resumed run's
    assert len(tap.calls) == 3, len(tap.calls)
    out["resume_arguments"] = [tree_differences(tap.calls[0], c)
                               for c in tap.calls[1:]]
    # the step once more on each recorded argument set (the uninterrupted
    # run's twice) with torch's deterministic algorithms
    det, caught = zip(*(deterministic_step(c)
                        for c in (tap.calls[0], tap.calls[0], tap.calls[1])))
    out["deterministic_nondeterministic_ops"] = sorted(set(sum(caught, [])))
    out["deterministic_repeat_max"] = [float((a - b).abs().max())
                                       for a, b in zip(det[0], det[1])]
    out["deterministic_resume_max"] = [float((a - b).abs().max())
                                       for a, b in zip(det[0], det[2])]
    del tap.calls[:], det
    # the gaps of the runs as they ran (the atomics' order; printed), on
    # the nodes of initialize, which the model points anchor, and on all
    n, n0 = resumed[0].node_count, fusion.node_count - sum(
        g["n_new_nodes"] for g in growth)
    out["resumed_nodes"] = [f.node_count for f in resumed]
    base, r0, r1 = ((w.rotations, w.translations) for w in (
        uninterrupted[0], resumed[0].warp, resumed[1].warp))
    out["resume_gap"] = node_gaps(r0, base, n0)
    out["resume_witness"] = node_gaps(r0, r1, n0)
    out["resume_gap_all_nodes"] = node_gaps(r0, base, n)
    if not checks:
        emit(out)
        tmp.cleanup()
        return counts
    try:
        check_keyframe_reference(out, infos, ref, KEYFRAME_STEPWISE_EXACT)
        assert not fusion.track_lost
        assert sum(k["loop_closures"] for k in out["keyframes"]) >= 1
        pc = drift["pose_correction"]
        assert pc > 1e-3 and abs(pc - ref["drift"]["pose_correction"]) <= (
            1e-3), (pc, ref["drift"])
        assert drift["after"] < 0.35 * drift["before"], drift
        assert out["resume_arguments"] == [[], []], out["resume_arguments"]
        assert not out["deterministic_nondeterministic_ops"], out
        assert out["deterministic_repeat_max"] == [0.0] * 3, out
        assert out["deterministic_resume_max"] == [0.0] * 3, out
        # K1: initialize, then each growth keyframe's refresh and growth
        # as in keyframe_path; K2 once a frame
        n_knn = 2 + sum(1 + (g["n_new_bricks"] > 0)
                        + 2 * (g["n_new_nodes"] > 0) for g in growth)
        assert counts == {"knn": n_knn, "lbs_warp": len(infos),
                          "point_term_blocks": 0,
                          "arap_term_blocks": 0}, counts
    finally:
        emit(out)
        tmp.cleanup()
    del fusion, resumed
    torch.cuda.empty_cache()
    return counts


def phase_nicp_solve(call):
    """One N-ICP solve (NICP_ITERS Adam iterations) on the stepwise N-ICP
    path's input at frame TAP_FRAME: ms eager (one call after another)
    and from a CUDA graph; device ops and device ms per Adam iteration
    from traces of 10- and 20-iteration solves (their difference over 10
    iterations; the fixed set-up and final cost cancel), and the top ops
    of the 10-iteration trace."""
    from occlusionfusion_tpu_torch.solvers import nicp as NI

    problem, config, R, t = call

    def solve(cfg):
        return lambda: NI.solve(problem, cfg, R, t)

    eager = cuda_ms(solve(config), 1, 2)
    graph = graph_ms(solve(config), 1, 5)
    traces = {it: traced_device(solve(config._replace(iters=it)), 1)
              for it in (10, 20)}
    ops = {it: sum(v[1] for v in tr.values()) for it, tr in traces.items()}
    ms = {it: sum(v[0] for v in tr.values()) / 1e3
          for it, tr in traces.items()}
    emit({"phase": "nicp_solve", "input": f"stepwise_frame_{TAP_FRAME}",
          "iters": config.iters, "eager_ms": eager[0],
          "eager_ms_min_max": eager[1:], "graph_ms": graph[0],
          "graph_ms_min_max": graph[1:],
          "device_ops_per_adam_iteration": (ops[20] - ops[10]) / 10,
          "device_ms_per_adam_iteration": (ms[20] - ms[10]) / 10,
          "solve_10_iterations_device_ops": ops[10],
          "solve_10_iterations_device_ms": ms[10],
          "top_10_iterations": [
              {"name": k[:80], "ms": us / 1e3, "calls": n}
              for k, (us, n) in sorted(traces[10].items(),
                                       key=lambda kv: -kv[1][0])[:12]]})


def traced_device(fn, reps):
    """torch.profiler over ``reps`` calls of ``fn``: {kernel name:
    (device us, count)} summed over the calls."""
    import torch
    from torch.autograd import DeviceType

    with profiled(True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0)
        us, n = by_kernel.get(ev.key, (0.0, 0))
        by_kernel[ev.key] = (us + dt, n + ev.count)
    return by_kernel


def gn_profile_tree(tree, dev="cuda", ptxas=False):
    """One tree's Gauss-Newton solve on the main path's input at frame
    TAP_FRAME (after ``initialize`` + ``build_fused``, timed as init_s):
    ms per call of ``_assemble_blocks`` and of ``solve_dense``
    back to back (CUDA events; paced by the host where it is slower than
    the device), the host ms to enqueue one solve, and a torch.profiler
    trace of 5 assemblies, 5 solves and 3 frames (device ms and device
    ops, that is kernels, fills and copies, per call; device ms by kernel
    per solve). Then K1 and K2 on the kernel phase's random input and on
    the main path's own (knn_row, lbs_row). Uses only what every tree of
    the port has, so it times a parent commit's tree as well."""
    import torch

    import occlusionfusion_tpu_torch as pkg
    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND

    if ptxas:
        print(D.build_kernels(verbose=True), flush=True)
    D.kernel_lib()
    seq, _ = sphere_sequence(TAP_FRAME + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                             DISTANCE)
    net = load_motion_complete_net(device=dev)
    with SolveTap(TAP_FRAME) as tap, KernelInputTap(TAP_FRAME) as ktap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fusion = DynamicFusion(seq, sphere_config(), device=dev)
        fusion.initialize(seq.load(0))
        sc, state, tables = fusion.build_fused(net)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        for i in range(1, len(seq)):
            state, _ = fusion.register_frame_fused(sc, state, tables,
                                                   seq.load(i), net)
    problem, config, R, t = tap.call
    asm = assembly_ms(tap.call, cuda_ms)
    solve = cuda_ms(lambda: GND.solve_dense(problem, config, R, t), 5)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        GND.solve_dense(problem, config, R, t)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out = {"phase": "gn_profile", "tree": tree, "package": pkg.__file__,
           "init_s": init_s, "iters": config.iters, "assembly_call_ms": asm[0],
           "assembly_call_ms_min_max": asm[1:], "solve_ms": solve[0],
           "solve_ms_min_max": solve[1:],
           "solve_host_enqueue_ms": sorted(host)[len(host) // 2]}
    reps = 5
    for what, fn in (
        ("assembly", lambda: GND._assemble_blocks(problem, config, R, t)),
        ("solve", lambda: GND.solve_dense(problem, config, R, t)),
    ):
        by_kernel = traced_device(fn, reps)
        out[f"{what}_device_ms_traced"] = sum(
            v[0] for v in by_kernel.values()) / 1e3 / reps
        out[f"{what}_device_ops"] = sum(
            v[1] for v in by_kernel.values()) / reps
        if what == "solve":
            out["solve_top"] = [
                {"name": k[:80], "ms": us / 1e3 / reps, "calls": n / reps}
                for k, (us, n) in sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1][0])[:15]]
    # three more steps on the last frame: the fused step's device ops
    frame = seq.load(TAP_FRAME)
    frame_ops = traced_device(lambda: fusion.register_frame_fused(
        sc, state, tables, frame, net), 3)
    out["frame_device_ms_traced"] = sum(
        v[0] for v in frame_ops.values()) / 1e3 / 3
    out["frame_device_ops"] = sum(v[1] for v in frame_ops.values()) / 3
    emit(out)
    del problem, config, R, t, tap, fusion, sc, state, tables, frame
    rows = k12_path_rows(ktap.knn, ktap.lbs)
    del ktap
    rows += k12_random_rows(dev)[0]
    torch.cuda.empty_cache()
    emit({"phase": "k12_profile", "tree": tree, "rows": rows})


def gn_compare(trees, ptxas=False):
    """gn_profile_tree for each tree in its own process, in the order
    given (parent, change, change, parent compares two commits on one
    card); ``ptxas`` also prints each tree's registers and spills."""
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--gn-profile-tree",
             tree] + (["--ptxas"] if ptxas else []),
            capture_output=True, text=True, timeout=600,
        )
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"gn profile of {tree} failed")


def keyframe_spread(runs, dev="cuda"):
    """The keyframe phases ``runs`` times each without their JAX checks
    and kernel rows: each run prints its readings (growth, counts, the
    main nodes' median, correspondences, the resume gap)."""
    for phase in (phase_keyframe_path, phase_keyframe_stepwise):
        for run in range(runs):
            t = time.perf_counter()
            phase(dev, checks=False)
            emit({"spread_run": run, "phase": phase.__name__,
                  "s": time.perf_counter() - t})


def main_path_projection():
    """(fx, fy, sf, sd) of the 2d_depth rows on the main path's camera
    (sphere_sequence: f = 2.3 w) at GN_2D_DEPTH's weights."""
    import numpy as np

    f = float(np.float32(2.3 * IMG_W))
    return (f, f, float(np.sqrt(np.float32(GN_2D_DEPTH["w_flow"]))),
            float(np.sqrt(np.float32(GN_2D_DEPTH["w_depth"]))))


def gn_case(dev, label, gn, ref, seq, centers, net, step_check=True):
    """One Gauss-Newton setting ``gn`` (GNConfig fields beside the main
    path's) on the main path's input through run_fused(chunk=16), with
    the launch counts set to 0 just before and read just after, held to
    the JAX package's result ``ref`` (check_against_reference: median
    node z within 1 mm, each frame's correspondences within 0.5%; no
    check where ``ref`` is None); then, with ``step_check``, from a fresh
    initialize, frame TAP_FRAME's captured step against its eager step
    (step_checks: the median node and the 90th percentile, F5), the GN
    input of that eager step tapped. Emits the case's row (frames/s of
    the run, initialize and capture in) and returns it with the launch
    counts and the tapped GN input (None without ``step_check``)."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.fused_step import (
        fused_register_chunk,
        fused_register_frame,
    )
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

    cfg = sphere_config(gn=GNConfig(iters=GN_ITERS, w_point=1.0, w_arap=2.0,
                                    w_motion=1.0, **gn))
    torch.cuda.synchronize()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    fusion = DynamicFusion(seq, cfg, device=dev)
    infos = fusion.run_fused(chunk=CHUNK, motion_net=net)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    n = fusion.node_count
    med = np.median(fusion.warp.translations[:n].cpu().numpy(), axis=0)
    out = {"phase": "gn_case", "case": label, **gn, "frames": len(infos),
           "nodes": n, "wall_s": wall,
           "frames_per_s_with_initialize": len(infos) / wall,
           "median_node_translation": med.tolist(),
           "tracking_error_z_m": float(med[2] - (centers[-1] - centers[0])[2]),
           "n_correspondences": [i["n_correspondences"] for i in infos],
           "final_loss": [i["final_loss"] for i in infos],
           "launches": counts}
    if ref is not None:
        out.update(reference_median_node_translation=ref[
            "median_node_translation"],
            reference_n_correspondences=ref["n_correspondences"])
    tapped = []
    if step_check:
        fusion.initialize(seq.load(0))
        sc, state0, tables = fusion.build_fused(net)
        depths, colors = frames_on(dev, seq, range(1, TAP_FRAME + 1))

        def eager(st, j):
            with SolveTap(1) as tap:
                out = fused_register_frame(sc, st, tables, net, depths[j],
                                           colors[j], fusion.intr, None,
                                           None, None)
            tapped.append(tap.call)
            return out

        def graph(st, j):
            return fused_register_chunk(
                sc, st, tables, net, depths[j:j + 1], colors[j:j + 1],
                fusion.intr, None, None, None, graphs=fusion.graphs)

        steps, check_steps = step_checks(eager, graph, state0, n, TAP_FRAME,
                                         (TAP_FRAME - 1,), False)
        out["step_check"] = steps
        del sc, state0, tables
    try:
        if ref is not None:
            check_against_reference(med[2], infos, ref[
                "median_node_translation"][2], ref["n_correspondences"])
        assert not fusion.track_lost
        if step_check:
            check_steps()
        steps_run = N_FRAMES + 1  # the frames and the warm-up step
        for k in ("point_term_blocks", "arap_term_blocks"):
            assert counts[k] == GN_ITERS * steps_run, (k, counts)
        assert counts["lbs_warp"] == steps_run, counts
    finally:
        emit(out)
    del fusion
    torch.cuda.empty_cache()
    # the first eager step at frame TAP_FRAME, from the state the steps
    # before it left
    return out, counts, tapped[0] if tapped else None


def solve_timings(call):
    """Device ms of one solve_dense (GN_ITERS iterations) from a CUDA
    graph per linear solver, on the tapped GN input ``call``, and the
    matrix-free GN-CG with the block-Jacobi preconditioner on it (32 CG
    iterations a step, as the JAX default) on it: each solver's node
    translations within GN_SOLVER_GAP_LIMITS of the dense Cholesky solve's
    at the 90th percentile over nodes (the largest gap printed), and
    every solve valid."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch.solvers import gauss_newton as GN
    from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND

    problem, config, R, t = call
    out = {"phase": "gn_solve_ms", "input": f"main_path_frame_{TAP_FRAME}",
           "iters": config.iters, "ms": {}, "ms_per_iteration": {}}
    results = {}
    for ls in ("cholesky",) + GN_LINEAR_SOLVERS:
        cfg = config._replace(linear_solver=ls)
        results[ls] = GND.solve_dense(problem, cfg, R, t)
        ms = graph_ms(lambda: GND.solve_dense(problem, cfg, R, t), 2)
        out["ms"][ls] = ms
        out["ms_per_iteration"][ls] = ms[0] / config.iters
    t0 = time.perf_counter()
    pcg = GN.solve(problem, config._replace(precondition=True), R, t)
    torch.cuda.synchronize()
    out["pcg_s"] = time.perf_counter() - t0
    nv = problem.node_valid.cpu().numpy()
    chol = results["cholesky"].translations.cpu().numpy()[nv]
    gaps = {ls: np.abs(r.translations.cpu().numpy()[nv] - chol).max(1)
            for ls, r in list(results.items())[1:]}
    gaps["pcg"] = np.abs(pcg.translations.cpu().numpy()[nv] - chol).max(1)
    out["gap_to_cholesky_m"] = {
        k: {"median": float(np.median(g)), "p90": float(np.quantile(g, 0.9)),
            "max": float(g.max())} for k, g in gaps.items()}
    try:
        assert all(bool(r.valid) for r in results.values()) and bool(
            pcg.valid)
        for k, g in out["gap_to_cholesky_m"].items():
            assert g["p90"] <= GN_SOLVER_GAP_LIMITS[k], (k, g)
    finally:
        emit(out)
    return out


def phase_gn_solvers(dev, call):
    """Phase `gn_solvers`: the main path's input (dense 128^3, 448x640,
    512-node cap, 8192 points, the motion GNN) with linear_solver "cg",
    "schur" and "ns" (gn_case, held to GN_SOLVERS_REFERENCE; ns with the
    step check) and with Cholesky for its rate; the solvers timed and
    PCG checked on the main path's frame-TAP_FRAME GN input ``call``
    (solve_timings)."""
    import torch

    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE)
    net = load_motion_complete_net(device=dev)
    rates = {}
    for ls in ("cholesky",) + GN_LINEAR_SOLVERS:
        # Cholesky for its rate (phase graph holds its captured steps);
        # the captured step against the eager one on ns, whose 24
        # products a step are the most work to capture (its run_fused,
        # like cg's and schur's, is held to JAX)
        out, _, _ = gn_case(dev, ls, {"linear_solver": ls},
                            GN_SOLVERS_REFERENCE.get(ls), seq, centers, net,
                            step_check=ls == "ns")
        rates[ls] = out["frames_per_s_with_initialize"]
    timings = solve_timings(call)
    emit({"phase": "gn_solvers", "frames_per_s_with_initialize": rates,
          "solve_ms_per_iteration": timings["ms_per_iteration"]})
    torch.cuda.empty_cache()


def phase_gn_2d_depth(dev):
    """Phase `gn_2d_depth`: the main path's input with the 2d_depth data
    term (GN_2D_DEPTH, scripts/run_fusion.py's weights; Cholesky) through
    gn_case, held to GN_2D_DEPTH_REFERENCE; then K3' with the 2d_depth
    rows (and K4') against their twins on this path's own GN input at
    frame TAP_FRAME, timed. Returns the launch counts and the kernel
    rows."""
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE)
    net = load_motion_complete_net(device=dev)
    _, counts, call = gn_case(dev, "2d_depth", GN_2D_DEPTH,
                              GN_2D_DEPTH_REFERENCE, seq, centers, net)
    point_args, arap_args, proj = gn_path_inputs(call)
    assert proj == main_path_projection(), proj
    rows = gn_kernel_rows(f"gn_2d_depth_frame_{TAP_FRAME}", point_args,
                          arap_args, proj)
    emit({"phase": "kernel", "input": f"gn_2d_depth_frame_{TAP_FRAME}",
          "rows": rows})
    return counts, rows[:1]


def rendered_case(dev):
    """The JAX package's frame-RENDERED_FRAME N-ICP problem of the
    stepwise loop (reference/solvers_rendered.npz: the problem, its warm
    start, the frame's depth map and intrinsics) as the port's
    NICPProblem on ``dev``, with the JAX package's loss, gradient [N, 6]
    (omega, t) and loss history under RENDERED_CONFIG."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch.solvers import nicp as NI

    z = np.load(RENDERED_NPZ)
    problem = NI.NICPProblem(**{
        k: torch.as_tensor(z[k], device=dev) for k in NI.NICPProblem._fields})
    problem = problem._replace(render_intrinsics=tuple(
        float(x) for x in z["render_intrinsics"]))
    R0, t0 = (torch.as_tensor(z[k], device=dev)
              for k in ("init_rotations", "init_translations"))
    return problem, R0, t0, {k: z[k] for k in (
        "loss", "grad", "loss_history", "chamfer_loss", "chamfer_grad")}


def phase_nicp_costs(dev):
    """Phase `nicp_costs`: the N-ICP path (nicp_config, the JAX defaults)
    with the chamfer cost at NICP_CHAMFER_WEIGHT on the JAX package's
    subsamples (reference/solvers_chamfer.npz) through run_fused(chunk=16),
    with the launch counts set to 0 just before and read just after, held
    to NICP_CHAMFER_REFERENCE (median node z within 1 mm, each frame's
    correspondences within 0.5%), its shift from the run without the
    chamfer printed beside JAX's; then one full-width nicp.solve with the
    rendered costs (RENDERED_CONFIG) on the JAX package's frame-
    RENDERED_FRAME problem: its loss and gradient at the warm start
    within RENDERED_TOL relative of JAX's, the whole solve printed; and
    on the same problem the chamfer objective at the warm start (the
    final loss's subsamples): its loss within RENDERED_TOL of JAX's, its
    gradient within CHAMFER_GRAD_TOL of the port's on the CPU (the same
    nearest neighbours, summed in another order) and, printed, its gap
    to JAX's (XLA's compiled distances round otherwise and flip ~1% of
    the near-tie neighbours, ~2e-3 of the gradient). Returns the launch
    counts."""
    import dataclasses

    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.geometry.so3 import so3_log
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.solvers import nicp as NI

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE)
    net = load_motion_complete_net(device=dev)
    cfg = nicp_config()
    cfg = dataclasses.replace(cfg, nicp=cfg.nicp._replace(
        w_chamfer=NICP_CHAMFER_WEIGHT))
    table = np.load(CHAMFER_NPZ)["table"].astype(np.int64)
    ref = NICP_CHAMFER_REFERENCE
    torch.cuda.synchronize()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    fusion = DynamicFusion(seq, cfg, device=dev, chamfer_table=table)
    infos = fusion.run_fused(chunk=CHUNK, motion_net=net)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(D.launch_counts)
    n = fusion.node_count
    med = np.median(fusion.warp.translations[:n].cpu().numpy(), axis=0)
    out = {"phase": "nicp_costs", "w_chamfer": NICP_CHAMFER_WEIGHT,
           "chamfer_table": list(table.shape), "wall_s": wall,
           "frames_per_s_with_initialize": len(infos) / wall, "nodes": n,
           "median_node_translation": med.tolist(),
           "reference_median_node_translation": ref[
               "median_node_translation"],
           "shift_from_no_chamfer_z_m": float(med[2] - NICP_REFERENCE_Z),
           "reference_shift_from_no_chamfer_z_m": ref[
               "median_node_translation"][2] - NICP_REFERENCE_Z,
           "n_correspondences": [i["n_correspondences"] for i in infos],
           "reference_n_correspondences": ref["n_correspondences"],
           "launches": counts}
    del fusion
    problem, R0, t0r, jref = rendered_case(dev)
    rcfg = NI.NICPConfig(**RENDERED_CONFIG)
    loss, g_omega, g_t = NI._grads(so3_log(R0), t0r, problem, rcfg, None)
    grad = torch.cat([g_omega, g_t], -1).cpu().numpy()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = NI.solve(problem, rcfg, R0, t0r)
    torch.cuda.synchronize()
    hist = res.loss_history.cpu().numpy()
    ccfg = NI.NICPConfig(iters=NICP_ITERS, w_chamfer=NICP_CHAMFER_WEIGHT)
    cgrad = {}
    for d in (dev, "cpu"):
        p, Rd, td, _ = rendered_case(d)
        closs, c_omega, c_t = NI._grads(so3_log(Rd), td, p, ccfg,
                                        torch.as_tensor(table[-1], device=d))
        cgrad[d] = (float(closs), torch.cat([c_omega, c_t], -1).cpu().numpy())
    closs, cg = cgrad[dev]
    out["rendered"] = {
        "frame": RENDERED_FRAME, "config": RENDERED_CONFIG,
        "loss": float(loss), "reference_loss": float(jref["loss"]),
        "loss_rel_err": abs(float(loss) - float(jref["loss"])) / abs(float(
            jref["loss"])),
        "grad_rel_err": float(np.abs(grad - jref["grad"]).max()
                              / np.abs(jref["grad"]).max()),
        "solve_s": time.perf_counter() - t1,
        "loss_history_first_last": [float(hist[0]), float(hist[-1])],
        "reference_loss_history_first_last": [
            float(jref["loss_history"][0]), float(jref["loss_history"][-1])],
        "final_loss": float(res.final_loss)}
    out["chamfer_start"] = {
        "loss": closs, "reference_loss": float(jref["chamfer_loss"]),
        "loss_rel_err": abs(closs - float(jref["chamfer_loss"]))
        / abs(float(jref["chamfer_loss"])),
        "grad_rel_err_to_cpu": float(np.abs(cg - cgrad["cpu"][1]).max()
                                     / np.abs(cgrad["cpu"][1]).max()),
        "grad_rel_err_to_jax": float(np.abs(cg - jref["chamfer_grad"]).max()
                                     / np.abs(jref["chamfer_grad"]).max())}
    try:
        check_against_reference(med[2], infos, ref[
            "median_node_translation"][2], ref["n_correspondences"])
        assert counts["lbs_warp"] >= N_FRAMES and counts["knn"] >= 2, counts
        r = out["rendered"]
        assert r["loss_rel_err"] <= RENDERED_TOL, r
        assert r["grad_rel_err"] <= RENDERED_TOL, r
        assert np.isfinite(hist).all() and np.isfinite(r["final_loss"])
        c = out["chamfer_start"]
        assert c["loss_rel_err"] <= RENDERED_TOL, c
        assert c["grad_rel_err_to_cpu"] <= CHAMFER_GRAD_TOL, c
    finally:
        emit(out)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase training: the four recipes of the port's trainers on JAX's batches


def tracking_gn():
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

    return GNConfig(iters=TRACKING_GN_ITERS, w_arap=1.0)


def load_training_batches(dev, path=TRAINING_NPZ):
    """The recipes' batches of reference/training_batches.npz on ``dev``:
    a FlowBatch, a stacked TrackingSample, eight MotionBatch samples and
    one Lepard pair (with neutral bridge fields). Float16 arrays come back
    as f32 (JAX's results are on those rounded values)."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch.models.flow_train import FlowBatch
    from occlusionfusion_tpu_torch.models.motion_complete import PyramidBatch
    from occlusionfusion_tpu_torch.models.motion_train import MotionBatch
    from occlusionfusion_tpu_torch.models.tracking_train import TrackingSample
    from occlusionfusion_tpu_torch.scripts.train_lepard import neutral_aux

    data = np.load(path)

    def t(key):
        a = data[key]
        if a.dtype == np.float16:
            a = a.astype(np.float32)
        return torch.from_numpy(a).to(dev)

    flow = FlowBatch(**{f: t(f"flow/{f}") for f in FlowBatch._fields})
    track = TrackingSample(**{f: t(f"tracking/{f}")
                              for f in TrackingSample._fields})
    pyr = {f: [t(f"motion/pyramid/{f}/{l}").long()
               for l in range(4 if f.startswith("edge") else 3)]
           for f in ("edge_src", "edge_dst", "edge_mask", "down_idx",
                     "up_idx")}
    pyr["edge_mask"] = [m.bool() for m in pyr["edge_mask"]]
    node_mask = t("motion/pyramid/node_mask")
    motion = []
    for i in range(node_mask.shape[0]):
        pyramid = PyramidBatch(
            **{f: tuple(x[i] for x in v) for f, v in pyr.items()},
            node_mask=node_mask[i])
        motion.append(MotionBatch(
            pos=t("motion/pos")[i], curr_motion=t("motion/curr_motion")[i],
            history=t("motion/history")[i],
            history_len=t("motion/history_len")[i].long(),
            gt_motion=t("motion/gt_motion")[i],
            node_mask=t("motion/node_mask")[i], pyramid=pyramid))
    lep = tuple(t(f"lepard/{k}") for k in
                ("src", "sm", "tgt", "tm", "cs", "ct", "cm"))
    lep += tuple(torch.from_numpy(a).to(dev)
                 for a in neutral_aux(lep[0].shape[0]))
    return flow, track, motion, lep


def training_recipes(dev):
    """{recipe: (loss_fn() -> (loss, terms), parameters, optimizer,
    nets)} for flow, tracking, motion and lepard on JAX's batches, from
    the recipes' starting checkpoints."""
    import torch

    from occlusionfusion_tpu_torch.models import checkpoint as C
    from occlusionfusion_tpu_torch.models.flow_train import flow_loss_fn
    from occlusionfusion_tpu_torch.models.motion_train import batched_loss
    from occlusionfusion_tpu_torch.models.optim import (
        Adam,
        warmup_cosine_decay_schedule,
    )
    from occlusionfusion_tpu_torch.models.tracking_train import batch_loss
    from occlusionfusion_tpu_torch.scripts.train_lepard import lepard_loss

    flow, track, motion, lep = load_training_batches(dev)
    out = {}
    pwc, mask = C.load_flow_nets(device=dev)
    params = [*pwc.parameters(), *mask.parameters()]
    out["flow"] = (lambda: (flow_loss_fn(pwc, mask, flow), {}), params,
                   Adam(params, 1e-4), (pwc, mask))
    tpwc, tmask = C.load_flow_nets(device=dev)
    tparams = [*tpwc.parameters(), *tmask.parameters()]
    out["tracking"] = (lambda: batch_loss(tpwc, tmask, track, tracking_gn()),
                       tparams, Adam(tparams, 1e-4), (tpwc, tmask))
    # train mode: cuDNN's LSTM backward runs in training mode only
    net = C.load_motion_complete_net(device=dev).train()
    out["motion"] = (lambda: (batched_loss(net, motion), {}),
                     list(net.parameters()),
                     Adam(net.parameters(), 1e-3), (net,))
    lnet, _ = C.load_lepard_checkpoint(
        os.path.join(HERE, "checkpoints", "lepard_bridge_r5e.npz"),
        device=dev)
    # train_lepard.py's defaults: 2000 steps, 100 of warm-up, lr 3e-4
    schedule = warmup_cosine_decay_schedule(0.0, 3e-4, 100, 2000,
                                            3e-4 * 0.02)
    out["lepard"] = (lambda: (lepard_loss(lnet, *lep), {}),
                     list(lnet.parameters()),
                     Adam(lnet.parameters(), schedule, weight_decay=1e-5,
                          clip_norm=1.0), (lnet,))
    return out, track


def run_recipe(loss_fn, params, opt, dev):
    """Step 0 (loss, terms, global gradient norm), then TRAINING_STEPS
    optimiser steps on the same batch (the losses they return, each at
    the parameters before its update) and the loss after the last; ms per
    step (host clock ending in a synchronize where on the card)."""
    import torch

    from occlusionfusion_tpu_torch.models.optim import global_norm

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    loss0, terms0 = loss_fn()
    loss0.backward()
    grads = [p.grad for p in params if p.grad is not None]
    out = {"loss0": loss0.item(), "terms0": {k: v.item() for k, v in
                                             terms0.items()},
           "grad_norm0": float(global_norm(grads))}
    losses, ms = [], []
    for _ in range(TRAINING_STEPS):
        sync()
        t = time.perf_counter()
        opt.zero_grad()
        loss, _ = loss_fn()
        loss.backward()
        opt.step()
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss.item())
    with torch.no_grad():
        out["final"] = float(loss_fn()[0])
    out.update(losses=losses, ms_per_step=ms)
    return out


def training_gaps(got, ref):
    """Relative gaps of a recipe's readings to JAX's: step-0 loss, each
    term, gradient norm, and the largest over the trajectory (the 5
    steps' losses and the final one)."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    traj = [rel(a, b) for a, b in zip(got["losses"] + [got["final"]],
                                      ref["losses"] + [ref["final"]])]
    return {"loss0": rel(got["loss0"], ref["loss0"]),
            "terms0": max([rel(got["terms0"][k], v)
                           for k, v in ref["terms0"].items()] or [0.0]),
            "grad_norm0": rel(got["grad_norm0"], ref["grad_norm0"]),
            "trajectory": max(traj)}


def twin_assembly():
    """Within the block the differentiable solve assembles with the plain
    twins under autograd (no kernel): the reference the Functions'
    gradients are held to."""
    import contextlib

    import torch

    from occlusionfusion_tpu_torch.ops import gn_assembly as GA
    from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND

    def twin(problem, terms, R, t):
        n = problem.nodes.shape[0]
        dev = problem.nodes.device
        M = torch.zeros((6 * n, 6 * n), device=dev)
        b = torch.zeros(6 * n, device=dev)
        sq = torch.zeros((), device=dev)
        GA.point_term_accumulate_torch(
            problem.source_points, problem.target_points,
            problem.point_valid, problem.point_anchors,
            problem.point_weights, problem.nodes, R, t, terms.sw, M, b, sq,
            proj=terms.proj)
        GA.arap_term_accumulate_torch(problem.nodes, R, t, terms.edges,
                                      terms.wa, terms.wm,
                                      problem.motion_targets, M, b, sq)
        return M, b, sq

    @contextlib.contextmanager
    def patched():
        orig = GND._assemble_differentiable
        GND._assemble_differentiable = twin
        try:
            yield
        finally:
            GND._assemble_differentiable = orig

    return patched()


def solve_gradients(call, twin: bool, iters=3, seed=0):
    """Gradients of a fixed random linear functional of a differentiable
    solve's warped points and node translations with respect to the
    targets and the point weights (what the trainer differentiates),
    through the autograd Functions (K3'/K4' forward) or, with ``twin``,
    through the plain twins' autograd."""
    import contextlib

    import torch

    from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
        solve_dense,
    )

    problem, config, R, t = call
    g = torch.Generator(device=problem.nodes.device).manual_seed(seed)
    tg = problem.target_points.clone().requires_grad_()
    pv = problem.point_valid.clone().requires_grad_()
    p = problem._replace(target_points=tg, point_valid=pv)
    with twin_assembly() if twin else contextlib.nullcontext():
        res = solve_dense(p, config._replace(iters=iters), R, t)
    wp = torch.randn(res.warped_points.shape, generator=g,
                     device=tg.device)
    wt = torch.randn(res.translations.shape, generator=g, device=tg.device)
    loss = torch.sum(res.warped_points * wp) + torch.sum(
        res.translations * wt)
    return torch.autograd.grad(loss, (tg, pv))


def functions_vs_twin(label, call):
    """The Functions' gradients through a 3-iteration solve against the
    twins' autograd: the largest relative gap (to each gradient's norm)."""
    got = solve_gradients(call, twin=False)
    ref = solve_gradients(call, twin=True)
    gaps = [float((a - b).norm() / b.norm()) for a, b in zip(got, ref)]
    emit({"phase": "training_gradcheck", "input": label,
          "rel_gaps": dict(zip(("targets", "point_valid"), gaps))})
    assert max(gaps) <= TRAINING_FUNCTION_TOL, (label, gaps)
    return max(gaps)


def tracking_card_checks(dev, track, main_call):
    """On the card: one sample built by the port's generator (K1 in its
    skinning) against JAX's first sample; the warp term's gradient on
    MaskNet (through the solve only) against JAX's; a finite difference
    of the solve's losses along a random MaskNet direction; the
    Functions' gradients against the twins' on the trainer's GN input and
    on the main path's frame-8 input; K3'/K4' rows at the trainer's size."""
    import numpy as np
    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.models import tracking_train as TT
    from occlusionfusion_tpu_torch.models.checkpoint import load_flow_nets
    from occlusionfusion_tpu_torch.models.deform_loss import DeformLossWeights
    from occlusionfusion_tpu_torch.models.optim import global_norm
    from occlusionfusion_tpu_torch.models.tracking_train import (
        synthetic_tracking_sample,
        tracking_loss,
        unstack,
    )

    tpwc, tmask = load_flow_nets(device=dev)  # the recipe's start

    D.reset_launch_counts()
    built = synthetic_tracking_sample(np.random.RandomState(0), n_nodes=32,
                                      n_matches=512, device=dev)
    torch.cuda.synchronize()
    k1 = D.launch_counts["knn"]
    assert k1 == 1, D.launch_counts
    first = unstack(track)[0]
    for f in ("anchors", "edges", "match_idx", "match_valid", "nodes",
              "source_points"):
        assert torch.equal(getattr(built, f), getattr(first, f)), f
    w_gap = float((built.skin_weights - first.skin_weights).abs().max())
    assert w_gap <= 1e-6, w_gap

    ref = TRAINING_REFERENCE["tracking"]
    gn = tracking_gn()
    warp = tracking_loss(tpwc, tmask, first, gn)[1]["warp"]
    grads = torch.autograd.grad(warp, list(tmask.parameters()))
    warp_norm = float(global_norm(grads))
    warp_gap = abs(warp_norm - ref["warp_mask_grad_norm"]) / ref[
        "warp_mask_grad_norm"]
    assert warp_norm > 0 and warp_gap <= TRAINING_TOLS["tracking"], (
        warp_norm, ref["warp_mask_grad_norm"])

    solve_only = DeformLossWeights(lambda_flow=0.0, lambda_graph=1.0,
                                   lambda_warp=1.0, lambda_mask=0.0)
    params = list(tmask.parameters())
    g = torch.Generator(device=dev).manual_seed(1)
    direction = [torch.randn(p.shape, generator=g, device=dev)
                 for p in params]
    scale = 1.0 / float(global_norm(direction))
    direction = [d * scale for d in direction]

    def loss_at(step):
        """The solve's losses with MaskNet moved by ``step`` along the
        direction (no gradient: the kernels' in-place path)."""
        with torch.no_grad():
            for p, d in zip(params, direction):
                p.add_(d, alpha=step)
            try:
                return float(tracking_loss(tpwc, tmask, first, gn,
                                           solve_only)[0])
            finally:
                for p, d in zip(params, direction):
                    p.sub_(d, alpha=step)

    loss = tracking_loss(tpwc, tmask, first, gn, solve_only)[0]
    ggrads = torch.autograd.grad(loss, params)
    analytic = float(sum(torch.sum(a * d) for a, d in zip(ggrads, direction)))
    fd = (loss_at(FD_STEP) - loss_at(-FD_STEP)) / (2 * FD_STEP)
    fd_gap = abs(analytic - fd) / max(abs(fd), 1e-12)
    emit({"phase": "training_fd", "analytic": analytic, "fd": fd,
          "rel_gap": fd_gap, "step": FD_STEP})
    assert analytic != 0.0 and fd_gap <= FD_TOL, (analytic, fd)

    with SolveTap(1, module=TT) as tap, torch.no_grad():
        tracking_loss(tpwc, tmask, first, gn)
    fn_gaps = {"tracking_sample_0": functions_vs_twin("tracking_sample_0",
                                                     tap.call)}
    fn_gaps[f"main_path_frame_{TAP_FRAME}"] = functions_vs_twin(
        f"main_path_frame_{TAP_FRAME}", main_call)
    rows = gn_kernel_rows("tracking_trainer_sample_0",
                          *gn_path_inputs(tap.call)[:2])
    return rows, {"k1_launches_building_a_sample": k1,
                  "skin_weight_gap": w_gap, "warp_mask_grad_norm": warp_norm,
                  "warp_mask_grad_gap": warp_gap, "fd_rel_gap": fd_gap,
                  "function_vs_twin_gaps": fn_gaps}


def phase_training(dev, main_call):
    """Each recipe on JAX's batch: step 0 held to JAX (loss, terms,
    gradient norm within TRAINING_TOLS), 5 optimiser steps (the loss
    falls; each step's loss within the band), ms per step and peak
    memory; the tracking recipe's K3'/K4' launches (TRACKING_GN_ITERS per
    sample per step in the forward, none in the backward) and its card
    checks; a trained flow checkpoint reloaded bit for bit; then each
    CLI 2 steps on the card. Returns (the tracking run's launches, the
    K3'/K4' rows at the trainer's size)."""
    import tempfile

    import torch

    from occlusionfusion_tpu_torch import device as D
    from occlusionfusion_tpu_torch.models import checkpoint as C
    from occlusionfusion_tpu_torch.scripts import (
        train_flow,
        train_lepard,
        train_motion,
    )
    from occlusionfusion_tpu_torch.utils.snapshot import save_pytree

    recipes, track = training_recipes(dev)
    counts = None
    n_samples = track.nodes.shape[0]
    for name, (loss_fn, params, opt, nets) in recipes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        if name == "tracking":
            D.reset_launch_counts()
            loss, _ = loss_fn()
            fwd = dict(D.launch_counts)
            loss.backward()
            torch.cuda.synchronize()
            assert D.launch_counts == fwd, (fwd, D.launch_counts)
            per = TRACKING_GN_ITERS * n_samples
            assert fwd["point_term_blocks"] == per, fwd
            assert fwd["arap_term_blocks"] == per, fwd
            for p in params:
                p.grad = None
            D.reset_launch_counts()
        got = run_recipe(loss_fn, params, opt, dev)
        if name == "tracking":
            counts = dict(D.launch_counts)
            # step 0, the steps and the final loss: one forward each
            assert counts["point_term_blocks"] == (
                per * (TRAINING_STEPS + 2)), counts
        ref = TRAINING_REFERENCE[name]
        gaps = training_gaps(got, ref)
        tol = TRAINING_TOLS[name]
        emit({"phase": "training_recipe", "recipe": name,
              "s": time.perf_counter() - t, **got, "reference": ref,
              "gaps": gaps, "tolerances": tol,
              "ms_per_step_median": sorted(got["ms_per_step"])[
                  TRAINING_STEPS // 2],
              "peak_mem_bytes": int(torch.cuda.max_memory_allocated())})
        for k, gap in gaps.items():
            assert gap <= tol, (name, k, gap, tol)
        assert got["final"] < got["loss0"], (name, got)
        if name == "flow":
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "flow.npz")
                save_pytree(path, train_flow.flow_checkpoint(*nets))
                pwc2, mask2 = C.load_flow_nets(path, device="cpu")
            for net, back in zip(nets, (pwc2, mask2)):
                sd = back.state_dict()
                for k, v in net.state_dict().items():
                    assert torch.equal(v.cpu(), sd[k]), k
        if name == "tracking":
            rows, checks = tracking_card_checks(dev, track, main_call)
            emit({"phase": "training_tracking_checks", **checks})
    del recipes

    with tempfile.TemporaryDirectory() as tmp:
        clis = (
            (train_flow, ["--with_mask", "--log_every", "1"]),
            (train_flow, ["--through_solver", "--batch", "2",
                          "--eval_pairs", "1", "--log_every", "1"]),
            (train_motion, ["--synthetic_clips", "2", "--eval_every", "1"]),
            (train_lepard, ["--eval_every", "1"]),
        )
        for i, (mod, extra) in enumerate(clis):
            t = time.perf_counter()
            out = os.path.join(tmp, f"cli_{i}.npz")
            mod.main(["--steps", "2", "--device", str(dev), "--out", out]
                     + extra)
            torch.cuda.synchronize()
            assert os.path.exists(out), out
            emit({"phase": "training_cli", "cli": mod.__name__,
                  "args": extra, "s": time.perf_counter() - t})
    return counts, rows


def main(argv) -> int:
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    tree = HERE
    if "--gn-profile-tree" in argv:
        tree = os.path.abspath(argv[argv.index("--gn-profile-tree") + 1])
    if not os.path.isdir(os.path.join(tree, "occlusionfusion_tpu_torch")):
        print(f"chip_smoke: occlusionfusion_tpu_torch/ not found in {tree}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    if "--gn-profile-tree" in argv:
        gn_profile_tree(tree, ptxas="--ptxas" in argv)
        return 0
    if "--gn-compare" in argv:
        print(nvidia_smi_line(), flush=True)
        gn_compare([a for a in argv[argv.index("--gn-compare") + 1:]
                    if not a.startswith("--")], ptxas="--ptxas" in argv)
        return 0
    if "--keyframe-spread" in argv:
        print(nvidia_smi_line(), flush=True)
        keyframe_spread(int(argv[argv.index("--keyframe-spread") + 1]))
        return 0
    from occlusionfusion_tpu_torch import device as D

    dev = "cuda"
    t = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "s": time.perf_counter() - t, "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t = time.perf_counter()
    if "--ptxas" in argv:
        print(D.build_kernels(verbose=True), flush=True)
    D.kernel_lib()
    emit({"phase": "build", "s": time.perf_counter() - t, **D.last_build})

    t = time.perf_counter()
    rows = phase_kernels(dev)
    emit({"phase": "kernels", "s": time.perf_counter() - t})

    profile = "--profile" in argv
    t = time.perf_counter()
    main_counts, call, k12_calls = phase_main_path(dev, profile)
    emit({"phase": "main_path_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    # the kernels line carries every kernel on the main path's own
    # inputs: K1 once for each of its calls there
    path_rows = k12_path_rows(*k12_calls)
    for r in path_rows:
        emit({"phase": "kernel", **r})
    del k12_calls
    emit({"phase": "k12_path_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    path_rows += phase_gn_path(call)
    assert {r["name"] for r in path_rows} == {r["name"] for r in rows}
    # each row's launches come from the run that gave its input
    for row in path_rows:
        row["launches"] = main_counts[row["name"]]
    rows = path_rows
    solver_call = call
    del call
    emit({"phase": "gn_path_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_envelope_flow(dev, profile)
    emit({"phase": "envelope_flow_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_graph(dev)
    emit({"phase": "graph_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    counts, head_rows = phase_headline(dev, profile)
    for row in head_rows:
        row["launches"] = counts[row["name"]]
        emit({"phase": "kernel", **row})
    assert {r["name"] for r in head_rows} == set(PATH_KERNELS)
    rows += head_rows
    emit({"phase": "headline_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_near(dev)
    emit({"phase": "near_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_parity(dev, ("main_path", "envelope_flow", "headline"))
    emit({"phase": "parity_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    counts, perc_rows = phase_perception(dev)
    for row in perc_rows:
        row["launches"] = counts[row["name"]]
        emit({"phase": "kernel", **row})
    assert {r["name"] for r in perc_rows} == set(PATH_KERNELS)
    rows += perc_rows
    emit({"phase": "perception_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_perception_stepwise(dev)
    emit({"phase": "perception_stepwise_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_perception_f32(dev)
    emit({"phase": "perception_f32_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_perception_matcher(dev)
    emit({"phase": "perception_matcher_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_parity(dev, ("perception", "perception_stepwise", "flow_no_mask",
                       "perception_bf16"))
    emit({"phase": "parity_perception_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    counts, nicp_rows = phase_nicp_path(dev, profile)
    for row in nicp_rows:
        row["launches"] = counts[row["name"]]
        emit({"phase": "kernel", **row})
    rows += nicp_rows
    emit({"phase": "nicp_path_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    _, solve_call = phase_stepwise(dev)
    emit({"phase": "stepwise_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_nicp_solve(solve_call)
    del solve_call
    emit({"phase": "nicp_solve_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_parity(dev, ("nicp",))
    emit({"phase": "parity_nicp_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    counts, kf_rows = phase_keyframe_path(dev)
    for row in kf_rows:
        row["launches"] = counts[row["name"]]
        emit({"phase": "kernel", **row})
    rows += kf_rows
    emit({"phase": "keyframe_path_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_keyframe_growth_case(dev)
    emit({"phase": "keyframe_growth_case_done",
          "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_keyframe_stepwise(dev)
    emit({"phase": "keyframe_stepwise_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_parity(dev, ("keyframe", "recovery", "cluster"))
    emit({"phase": "parity_keyframe_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    counts, train_rows = phase_training(dev, solver_call)
    for row in train_rows:
        row["launches"] = counts[row["name"]]
        emit({"phase": "kernel", **row})
    rows += train_rows
    emit({"phase": "training_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_gn_solvers(dev, solver_call)
    del solver_call
    emit({"phase": "gn_solvers_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    counts, rows_2d = phase_gn_2d_depth(dev)
    for row in rows_2d:
        row["launches"] = counts[row["name"]]
        emit({"phase": "kernel", **row})
    rows += rows_2d
    emit({"phase": "gn_2d_depth_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_nicp_costs(dev)
    emit({"phase": "nicp_costs_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_parity(dev, ("gn_solvers", "nicp_costs"))
    emit({"phase": "parity_solvers_done", "s": time.perf_counter() - t})

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "input")
    emit({"total_s": time.perf_counter() - t_all})
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
