#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (occlusionfusion_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--ptxas] [--profile]

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
     twin's time and the least time the card could take (bound);
  4. main path: DynamicFusion.initialize + build_fused, then 16 frames of
     the fused loop (dense Gauss-Newton + motion GNN) on an analytic
     deforming sphere at 128^3 voxels (dense) / 448x640 / 512 nodes /
     8192 points, the sphere at 3 m; the sphere must be tracked and K1-K4
     must have been launched by this phase, K4 four times per frame;
  5. envelope_flow: the same sphere, textured, through the reference
     envelope of bench.py: a bricked 128^3 volume (bricks of 8, 1024
     slots), PWC flow + MaskNet (checkpoints/flow.npz) filling points
     without a projective target, and the motion GNN; it must track,
     flow must fill points, and K1-K4 must have been launched, K4 four
     times per frame;
  6. near: the main path's settings with the sphere at 1 m, at half the
     image, where the reference algorithm overshoots the motion; the card
     must reproduce the JAX package's result (NEAR_REFERENCE_Z);
  7. parity: both paths at a small size on the card (kernels) and on the
     CPU (twins) must agree.
Then one JSON line with the kernel table (launches counted in
envelope_flow; both paths run all four kernels), the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failed
check raises and exits nonzero. Without a CUDA device, or without the
port's package beside this file, it exits nonzero and prints no result.
It imports nothing of JAX or of the JAX package.
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


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev):
    """Each kernel against its twin at the main path's shapes."""
    import torch

    from occlusionfusion_tpu_torch.fusion.warpfield import WarpFieldState
    from occlusionfusion_tpu_torch.geometry.so3 import so3_exp
    from occlusionfusion_tpu_torch.ops import gn_assembly, knn, lbs

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

    # K3: point-term GN blocks, FRACTIONAL point weights
    P = MAX_POINTS
    pts = q[:P].contiguous()
    a_p = idx_k[:P].contiguous()
    w_p = w[:P].contiguous()
    tgt = pts + (rand(P, 3) - 0.5) * 0.01
    pv = 0.3 + 0.7 * rand(P)
    sw = 1.0
    args = (pts, tgt, pv, a_p, w_p, nodes, R, t, sw)
    out_k = gn_assembly.point_term_blocks_cuda(*args)
    out_t = gn_assembly.point_term_blocks_torch(*args)

    def seg(out):
        blk, bv, rsq = out
        seg_ids = (a_p.long()[:, :, None] * N + a_p.long()[:, None, :]).reshape(-1)
        M = torch.zeros((N * N, 36), device=dev).index_add_(
            0, seg_ids, blk.reshape(-1, 36))
        bn = torch.zeros((N, 6), device=dev).index_add_(
            0, a_p.long().reshape(-1), bv.reshape(-1, 6))
        return M, bn, rsq.sum()

    (M1, b1, s1), (M2, b2, s2) = seg(out_k), seg(out_t)
    torch.cuda.synchronize()
    rel_M = float((M1 - M2).abs().max() / M2.abs().max())
    rel_b = float((b1 - b2).abs().max() / b2.abs().max())
    rel_s = float((s1 - s2).abs() / s2.abs())
    assert max(rel_M, rel_b, rel_s) <= 5e-5, (rel_M, rel_b, rel_s)
    ms, ms_lo, ms_hi = cuda_ms(
        lambda: gn_assembly.point_term_blocks_cuda(*args), 200)
    plain = cuda_ms(lambda: gn_assembly.point_term_blocks_torch(*args), 20)[0]
    b, by = bound_ms(P * (12 + 12 + 4 + 16 + 16) + N * 60 + P * 601 * 4,
                     P * 3180)
    rows.append(dict(
        name="point_term_blocks", route="cuda",
        source="occlusionfusion_tpu_torch/csrc/gn_assembly.cu",
        replaces="occlusionfusion_tpu/ops/gn_assembly.py:151",
        max_abs_err=float((out_k[0] - out_t[0]).abs().max()), ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        shape=f"P={P} N={N} K={K}",
        rel_err_M=rel_M, rel_err_b=rel_b, rel_err_sq=rel_s,
    ))
    emit({"phase": "kernel", "name": "point_term_blocks", "rel_err_M": rel_M,
          "rel_err_b": rel_b, "rel_err_sq": rel_s, "ms": ms,
          "ms_min": ms_lo, "ms_max": ms_hi,
          "plain_ms": plain, "bound_ms": b})

    # K4: ARAP-term GN blocks, 8 edge slots per node, a fifth of them
    # invalid (index -1 clamped to 0, weight 0)
    E = 8
    edges = torch.randint(0, N, (N, E), generator=gen, device=dev,
                          dtype=torch.int32)
    invalid = rand(N, E) < 0.2
    ew = rand(N, E)
    wa = torch.sqrt(2.0 * torch.where(invalid, torch.zeros_like(ew), ew))
    edges = torch.where(invalid, torch.zeros_like(edges), edges)
    args4 = (nodes, R, t, edges, wa)
    out_k = gn_assembly.arap_term_blocks_cuda(*args4)
    out_t = gn_assembly.arap_term_blocks_torch(*args4)

    def seg4(out):
        ii, ij, ji, jj, bi, bj, rsq = out
        e = edges.long()
        i = torch.arange(N, device=dev)[:, None].expand(N, E)
        segs = torch.cat([(i * N + e).reshape(-1), (e * N + i).reshape(-1),
                          (e * N + e).reshape(-1)])
        M = torch.zeros((N * N, 36), device=dev).index_add_(
            0, segs, torch.cat([x.reshape(-1, 36) for x in (ij, ji, jj)]))
        M.index_add_(0, torch.arange(N, device=dev) * (N + 1),
                     ii.reshape(-1, 36))
        bn = torch.zeros((N, 6), device=dev).index_add_(
            0, e.reshape(-1), bj.reshape(-1, 6)) + bi
        return M, bn, rsq.sum()

    (M1, b1, s1), (M2, b2, s2) = seg4(out_k), seg4(out_t)
    torch.cuda.synchronize()
    rel_M = float((M1 - M2).abs().max() / M2.abs().max())
    rel_b = float((b1 - b2).abs().max() / b2.abs().max())
    rel_s = float((s1 - s2).abs() / s2.abs())
    err4 = max(float((a - b).abs().max()) for a, b in zip(out_k, out_t))
    assert max(rel_M, rel_b, rel_s) <= 5e-5, (rel_M, rel_b, rel_s)
    ms, ms_lo, ms_hi = cuda_ms(
        lambda: gn_assembly.arap_term_blocks_cuda(*args4), 200)
    plain = cuda_ms(lambda: gn_assembly.arap_term_blocks_torch(*args4),
                    50)[0]
    # bytes: nodes, R, t, edges, wa in; ii, ij/ji/jj, b_i, b_j, rsq out;
    # ~330 flops per edge (rotation, residual, 6x6 accumulation)
    b, by = bound_ms(N * 60 + N * E * 8
                     + 4 * (N * 36 + 3 * N * E * 36 + N * 6 + N * E * 6 + N),
                     N * E * 330)
    rows.append(dict(
        name="arap_term_blocks", route="cuda",
        source="occlusionfusion_tpu_torch/csrc/arap_term.cu",
        replaces="occlusionfusion_tpu/ops/gn_assembly.py:317",
        max_abs_err=err4, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape=f"N={N} E={E}",
    ))
    emit({"phase": "kernel", "name": "arap_term_blocks", "rel_err_M": rel_M,
          "rel_err_b": rel_b, "rel_err_sq": rel_s, "max_abs_err": err4,
          "invalid_edge_slots": int(invalid.sum()), "ms": ms,
          "ms_min": ms_lo, "ms_max": ms_hi, "plain_ms": plain,
          "bound_ms": b})
    del q, d2_k, d2_t, idx_k, idx_t, y_k, y_t, out_k, out_t
    torch.cuda.empty_cache()
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
    """The checks every full-size path passes (K1-K4 launched, K4 once
    per GN iteration); returns the median node translation and the
    sphere's motion."""
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
    assert counts["arap_term_blocks"] == GN_ITERS * len(info_np), counts
    return med, motion, trans


def phase_main_path(dev, profile=False):
    import numpy as np

    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )

    seq, centers = sphere_sequence(N_FRAMES + 1, IMG_H, IMG_W, RADIUS, STEP_Z,
                                   DISTANCE)
    net = load_motion_complete_net(device=dev)
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
    return counts


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


def main(argv) -> int:
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "occlusionfusion_tpu_torch")):
        print("chip_smoke: occlusionfusion_tpu_torch/ not found beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
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
    phase_main_path(dev, profile)
    emit({"phase": "main_path_done", "s": time.perf_counter() - t})

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
