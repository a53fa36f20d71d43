#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (occlusionfusion_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--ptxas] [--profile]
    python3 chip_smoke.py [--ptxas] --gn-compare TREE [TREE ...]

``--ptxas`` prints each kernel's registers and spills; ``--profile``
traces frames 2-16 of the paths `main_path` and `envelope_flow` with
torch.profiler and prints the device time by kernel name and the
device's busy share over each traced window. The frames/s of a
``--profile`` run include the profiler's start-up; read them from a run
without it.

Phases, each printing one JSON line with its wall seconds:
  1. device: the card, and `nvidia-smi --query-gpu=name,power.limit`;
  2. build: nvcc builds the port's kernels (csrc/*.cu) into one library;
  3. kernels: each hand-written kernel against its plain PyTorch twin on
     the card, at the shapes the main path gives it, with its time, the
     twin's time and the least time the card could take (bound); K3' and
     K4' add into the dense system (M, b, sq) and are held to their
     accumulating twins on random inputs here;
  4. main path: DynamicFusion.initialize + build_fused, then 16 frames of
     the fused loop (dense Gauss-Newton + motion GNN) on an analytic
     deforming sphere at 128^3 voxels (dense) / 448x640 / 512 nodes /
     8192 points, the sphere at 3 m; the sphere must be tracked and K1,
     K2, K3', K4' must have been launched by this phase, K3' and K4' four
     times per frame; the GN input of frame 8 is kept;
  5. gn_path: K3' and K4' against their twins again on that input, where
     the anchors share pairs as the real surface makes them, with their
     bounds for it, and `_assemble_blocks` timed on it (assembly_ms);
  6. envelope_flow: the same sphere, textured, through the reference
     envelope of bench.py: a bricked 128^3 volume (bricks of 8, 1024
     slots), PWC flow + MaskNet (checkpoints/flow.npz) filling points
     without a projective target, and the motion GNN; it must track,
     flow must fill points, and all four kernels must have been
     launched, K3' and K4' four times per frame;
  7. near: the main path's settings with the sphere at 1 m, at half the
     image, where the reference algorithm overshoots the motion; the card
     must reproduce the JAX package's result (NEAR_REFERENCE_Z);
  8. parity: both paths at a small size on the card (kernels) and on the
     CPU (twins) must agree.
Then one JSON line with the kernel table (K1 and K2 on the phase-3
inputs, K3' and K4' on the main path's; launches counted in
envelope_flow; both paths run all four kernels), the card's name and
power limit, and as the last line {"ok": true, "device": {...}}. Any
failed check raises and exits nonzero. Without a CUDA device, or without
the port's package beside this file, it exits nonzero and prints no
result. It imports nothing of JAX or of the JAX package.

``--gn-compare`` runs, for each TREE in the order given and each in its
own process, the main path to frame 8 with that tree's package and then
times and traces one Gauss-Newton solve on its input (gn_profile_tree):
the order parent, change, change, parent compares two commits on one
card.
"""

from __future__ import annotations

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


def sphere_sequence(n_frames, h, w, r, step, distance=1.0, textured=False):
    """Analytic deforming-sphere RGB-D sequence (a sphere receding along
    the optical axis, ray-cast in closed form), flat grey or with a smooth
    RGB texture fixed to its surface (a function of the surface normal)
    for optical flow to follow."""
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
        c = np.array([0.0, 0.0, distance]) + np.array([0.0, 0.0, step]) * i
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


def phase_kernels(dev):
    """Each kernel against its twin at the main path's shapes."""
    import torch

    from occlusionfusion_tpu_torch.fusion.warpfield import WarpFieldState
    from occlusionfusion_tpu_torch.geometry.so3 import so3_exp
    from occlusionfusion_tpu_torch.ops import knn, lbs

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    rows = []
    extent = VOL * VOXEL
    P_vox, N, K = VOL ** 3, MAX_NODES, 4
    n_valid = 300

    # K1: voxel centres against graph nodes (the keyframe voxel skinning)
    q = (rand(P_vox, 3) - 0.5) * extent + torch.tensor([0, 0, 1.0], device=dev)
    nodes = (rand(N, 3) - 0.5) * 0.3 + torch.tensor([0, 0, 1.0], device=dev)
    node_valid = torch.arange(N, device=dev) < n_valid
    d2_k, idx_k = knn.knn_cuda(q, nodes, K, node_valid)
    d2_t, idx_t = knn.knn_torch(q, nodes, K, node_valid)
    torch.cuda.synchronize()
    err_d2 = float((d2_k - d2_t).abs().max())
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
        assert tie_err <= 1e-5, f"K1 anchor sets differ beyond ties: {tie_err}"
    assert err_d2 <= 1e-5, f"K1 d2 error {err_d2}"
    assert bool(node_valid[idx_k.long()].all()), "K1 picked an invalid ref"
    ms, ms_lo, ms_hi = cuda_ms(lambda: knn.knn_cuda(q, nodes, K, node_valid),
                               10)
    plain = cuda_ms(lambda: knn.knn_torch(q, nodes, K, node_valid), 1, 3)[0]
    b, by = bound_ms(P_vox * 12 + N * 12 + N * 4 + P_vox * K * 8,
                     P_vox * N * 9)
    rows.append(dict(
        name="knn", route="cuda",
        source="occlusionfusion_tpu_torch/csrc/knn.cu",
        replaces="occlusionfusion_tpu/ops/knn.py:100",
        max_abs_err=err_d2, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape=f"P={P_vox} N={N} k={K}",
        anchor_set_rows_differing=n_set_diff,
    ))
    emit({"phase": "kernel", "name": "knn", "max_abs_err_d2": err_d2,
          "anchor_set_rows_differing": n_set_diff, "ms": ms,
          "ms_min": ms_lo, "ms_max": ms_hi,
          "plain_ms": plain, "bound_ms": b})

    # K2: the voxel LBS warp through those anchors
    sigma2 = 0.05 ** 2
    w = torch.exp(-d2_k / (2 * sigma2))
    w = w / (w.sum(-1, keepdim=True) + 1e-6)
    vox_valid = rand(P_vox) > 0.2
    R = so3_exp((rand(N, 3) - 0.5) * 0.4)
    t = (rand(N, 3) - 0.5) * 0.05
    warp = WarpFieldState(nodes, node_valid, R, t)
    y_k = lbs.lbs_warp_cuda(q, idx_k, w, vox_valid, warp)
    y_t = lbs.lbs_warp_torch(q, idx_k, w, vox_valid, warp)
    torch.cuda.synchronize()
    err = float((y_k - y_t).abs().max())
    assert err <= 2e-4, f"K2 error {err} m"
    ms, ms_lo, ms_hi = cuda_ms(
        lambda: lbs.lbs_warp_cuda(q, idx_k, w, vox_valid, warp), 50)
    plain = cuda_ms(
        lambda: lbs.lbs_warp_torch(q, idx_k, w, vox_valid, warp), 5)[0]
    b, by = bound_ms(P_vox * (12 + K * 4 + K * 4 + 1 + 12) + N * 48,
                     P_vox * (K * 24 + 18))
    rows.append(dict(
        name="lbs_warp", route="cuda",
        source="occlusionfusion_tpu_torch/csrc/lbs.cu",
        replaces="occlusionfusion_tpu/ops/lbs.py:89",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape=f"P={P_vox} N={N} K={K}",
    ))
    emit({"phase": "kernel", "name": "lbs_warp", "max_abs_err_m": err,
          "ms": ms, "ms_min": ms_lo, "ms_max": ms_hi, "plain_ms": plain,
          "bound_ms": b})

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
    del q, d2_k, d2_t, idx_k, idx_t, y_k, y_t
    torch.cuda.empty_cache()
    return rows


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def gn_kernel_rows(label, point_args, arap_args=None):
    """K3' (point term) and, given its arguments, K4' (ARAP term + motion
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
        kernel(*args, *got)
        twin(*args, *ref)
        torch.cuda.synchronize()
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
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
            # flops), then ~110 per anchor pair (block entries and adds)
            flops = live_pts * (180 + 16 * 110)
            extra = {"unique_pairs": work, "live_points": live_pts}
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
            rel_err_b=errs[1], rel_err_sq=errs[2], **extra,
        ))
    return rows


def profiled(enabled):
    import contextlib

    if not enabled:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def report_profile(prof, wall_s, path):
    """Device time by kernel name over the traced window, and the share of
    the window the device was busy (sum of kernel times / wall)."""
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


def near_sequence():
    """The sphere at 1 m (NEAR): 16 frames after the first."""
    return sphere_sequence(N_FRAMES + 1, NEAR["h"], NEAR["w"], RADIUS,
                           STEP_Z, NEAR["distance"])


def drive_path(path, dev, seq, cfg, net, profile, **nets):
    """initialize + build_fused, then every frame of ``seq`` through the
    fused step, with the launch counts set to 0 just before and read just
    after. Returns (fusion, state, tables, info [F, 6] numpy, timings,
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
        report_profile(prof, t_window, path)
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
              "n_flow_filled": int(row[5])})
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
    fused step's solve_dense (that is, of frame ``at``): (GNProblem,
    GNConfig, R, t)."""

    def __init__(self, at):
        self.at, self.calls, self.call = at, 0, None

    def __enter__(self):
        from occlusionfusion_tpu_torch.fusion import fused_step

        self.mod, self.orig = fused_step, fused_step.solve_dense

        def tap(problem, config, init_rotations, init_translations):
            self.calls += 1
            if self.calls == self.at:
                self.call = (problem, config, init_rotations.clone(),
                             init_translations.clone())
            return self.orig(problem, config, init_rotations,
                             init_translations)

        fused_step.solve_dense = tap
        return self

    def __exit__(self, *exc):
        self.mod.solve_dense = self.orig


def phase_main_path(dev, profile=False):
    """Returns the launch counts and the main path's Gauss-Newton input
    at frame TAP_FRAME."""
    import numpy as np

    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE)
    net = load_motion_complete_net(device=dev)
    with SolveTap(TAP_FRAME) as tap:
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
    return counts, tap.call


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
    return point_args, arap_args


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


def phase_parity(dev):
    """Both paths at a small size (tests/test_torch_fusion_slice.py's and
    tests/test_torch_flow_slice.py's: 48^3, 128x128, 4 frames) on the card
    (kernels) and on the CPU (twins): per-frame info and node transforms
    must agree."""
    import numpy as np

    from occlusionfusion_tpu_torch.fusion.pipeline import (
        DynamicFusion,
        FusionConfig,
    )
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_flow_nets,
        load_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

    small = dict(
        vol_dim=(48, 48, 48), voxel_size=0.008, node_coverage=0.04,
        max_nodes=256, max_points=2048, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=0.04, min_neighbors=2),
    )
    gn = dict(iters=6, w_point=1.0, w_arap=10.0, w_motion=1.0)
    cases = {
        "main_path": (sphere_sequence(5, 128, 128, 0.1, 0.004)[0],
                      FusionConfig(gn=GNConfig(**gn), **small), False),
        "envelope_flow": (
            sphere_sequence(5, 128, 128, 0.1, 0.004, textured=True)[0],
            FusionConfig(gn=GNConfig(**gn), brick_size=8, max_bricks=256,
                         use_flow=True, **small),
            True),
    }
    for path, (seq, cfg, flow) in cases.items():
        runs = {}
        for d in (dev, "cpu"):
            nets = {}
            if flow:
                nets = dict(zip(("flow_net", "mask_net"),
                                load_flow_nets(device=d)))
            f = DynamicFusion(seq, cfg, device=d, **nets)
            infos = f.run_fused(
                motion_net=load_motion_complete_net(device=d)
            )
            runs[d] = (f, infos)
        (fg, ig), (fc, ic) = runs[dev], runs["cpu"]
        n = fc.node_count
        assert fg.node_count == n
        dt = float(np.abs(fg.warp.translations[:n].cpu().numpy()
                          - fc.warp.translations[:n].numpy()).max())
        dR = float(np.abs(fg.warp.rotations[:n].cpu().numpy()
                          - fc.warp.rotations[:n].numpy()).max())
        dconf = max(abs(a["mean_confidence"] - b["mean_confidence"])
                    for a, b in zip(ig, ic))
        dcorr = max(abs(a["n_correspondences"] - b["n_correspondences"])
                    for a, b in zip(ig, ic))
        emit({"phase": "parity", "path": path, "nodes": n, "max_dt_m": dt,
              "max_dR": dR, "max_dconf": dconf, "max_dcorr": dcorr,
              "flow_filled_card": [i["n_flow_filled"] for i in ig],
              "flow_filled_cpu": [i["n_flow_filled"] for i in ic]})
        assert dt <= 1e-4 and dR <= 1e-3 and dconf <= 0.015 and dcorr <= 2, (
            path, dt, dR, dconf, dcorr)
        if flow:
            assert sum(i["n_flow_filled"] for i in ig) > 0, "no flow fill"


def gn_profile_tree(tree, dev="cuda", ptxas=False):
    """One tree's Gauss-Newton solve on the main path's input at frame
    TAP_FRAME: ms per call of ``_assemble_blocks`` and of ``solve_dense``
    back to back (CUDA events; paced by the host where it is slower than
    the device), the host ms to enqueue one solve, and a torch.profiler
    trace of 5 assemblies and 5 solves (device ms and device ops, that is
    kernels, fills and copies, per call; device ms by kernel per solve).
    Uses only what every tree of the port has, so it times a parent
    commit's tree as well."""
    import torch
    from torch.autograd import DeviceType

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
    with SolveTap(TAP_FRAME) as tap:
        fusion = DynamicFusion(seq, sphere_config(), device=dev)
        fusion.initialize(seq.load(0))
        sc, state, tables = fusion.build_fused(net)
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
           "iters": config.iters, "assembly_call_ms": asm[0],
           "assembly_call_ms_min_max": asm[1:], "solve_ms": solve[0],
           "solve_ms_min_max": solve[1:],
           "solve_host_enqueue_ms": sorted(host)[len(host) // 2]}
    reps = 5
    for what, fn in (
        ("assembly", lambda: GND._assemble_blocks(problem, config, R, t)),
        ("solve", lambda: GND.solve_dense(problem, config, R, t)),
    ):
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
        out[f"{what}_device_ms_traced"] = sum(
            v[0] for v in by_kernel.values()) / 1e3 / reps
        out[f"{what}_device_ops"] = sum(
            v[1] for v in by_kernel.values()) / reps
        if what == "solve":
            out["solve_top"] = [
                {"name": k[:80], "ms": us / 1e3 / reps, "calls": n / reps}
                for k, (us, n) in sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1][0])[:15]]
    emit(out)


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
    _, call = phase_main_path(dev, profile)
    emit({"phase": "main_path_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    # the kernels line carries K3' and K4' on the main path's own input
    by_name = {r["name"]: r for r in rows}
    by_name.update((r["name"], r) for r in phase_gn_path(call))
    rows = list(by_name.values())
    del call
    emit({"phase": "gn_path_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    counts = phase_envelope_flow(dev, profile)
    emit({"phase": "envelope_flow_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_near(dev)
    emit({"phase": "near_done", "s": time.perf_counter() - t})

    t = time.perf_counter()
    phase_parity(dev)
    emit({"phase": "parity_done", "s": time.perf_counter() - t})

    for row in rows:
        row["launches"] = counts[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"total_s": time.perf_counter() - t_all})
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
