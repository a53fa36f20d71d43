"""The port's counterparts of ``__graft_entry__.py``'s entry points:
``entry()``, the motion-completion forward at demo scale, and
``dryrun_multichip(n_devices)``, the seven phases of the multi-device
dry run on ``n_devices`` ranks (``parallel/mesh.launch``), with the
JAX dry run's asserts and limits:

1. a data-parallel train step of the motion GNN (each rank one sample of
   the batch; ``models/motion_train.make_data_parallel_train_step``);
2. the x-slab integrate (``parallel/sequence.integrate_slab``);
3. the matrix-free distributed GN-CG (``solve_distributed``);
4. the node-sharded LSTM (``lstm_node_sharded``);
5. the distributed dense solve at 512 nodes / 8,192 points against the
   single-rank solve (within 1e-4 m);
6. the sharded fused engine (``parallel/engine.py``) at 64^3, 512 nodes,
   8,192 points, ``gn_dense``, against the single-rank
   ``fused_register_chunk`` (translations within 1e-4 m; tsdf within
   1e-3 of the single-rank integrate through the sharded run's own
   transforms, ``sharded_engine_case``; the voxels more than 1e-3 off
   the single-rank run by F5's rule against two single-rank runs);
7. the same at the production envelope: the bricked 128^3 volume (bricks
   of 8, 1,024 slots), the motion GNN, PWC + MaskNet and Lepard in the
   step, the 512-node cap.

The numpy inputs are the JAX dry run's draws. Where the JAX dry run
draws random net weights from JAX's PRNG, which the port cannot
reproduce, the port takes the repo's checkpoints: the motion GNN from
``checkpoints/motion_complete.npz`` (phases 1, 4 and 7), PWC + MaskNet
from ``checkpoints/flow.npz`` and Lepard from
``checkpoints/lepard_bridge_r5e.npz`` at the JAX dry run's pyramid
sizes (phase 7).

Ranks: gloo on the CPU; on the card, NCCL where every rank has a card of
its own, else gloo with CUDA tensors on the shared cards.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from occlusionfusion_tpu_torch.device import resolve_device

DEMO_CAPS = (512, 128, 32, 32)
DEMO_KS = (8, 6, 4, 3)
TRAIN_CAPS = (32, 16, 8, 8)
TRAIN_SIZES = (24, 10, 5, 3)
GN_LIMIT = 1e-4  # phases 5-7: translations (m)
TSDF_LIMIT = 1e-3  # phases 6-7
# phases 6-7: the voxels more than TSDF_LIMIT off the single-rank run,
# at most GAP_FACTOR times as many as between two single-rank runs, or
# GAP_FACTOR where those agree everywhere (F5's rule: the larger of a
# floor and 3x the run-to-run reading)
GAP_FACTOR = 3
CHECKPOINTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "checkpoints")
LEPARD = "lepard_bridge_r5e.npz"
LEPARD_LEVELS = (128, 48, 24, 12)


def _pyramid_draws(r, sizes, ks, caps):
    """A padded random pyramid (numpy PyramidBatch), drawn from ``r`` in
    the JAX dry run's order."""
    from occlusionfusion_tpu_torch.fusion.motion_runner import pad_pyramid

    nn = [r.randint(0, sizes[l], size=(sizes[l], ks[l])).astype(np.int16)
          for l in range(4)]
    down = [np.sort(r.choice(sizes[l], size=sizes[l + 1],
                             replace=False)).astype(np.int16)
            for l in range(3)]
    up = [r.randint(0, sizes[l + 1], size=sizes[l]).astype(np.int16)
          for l in range(3)]
    return pad_pyramid(nn, down, up, level_sizes=caps)


def demo_scale_inputs():
    """``__graft_entry__._demo_scale_inputs``: (pos [512, 3], curr
    [512, 4], hist [16, 512, 4], history length 4, the padded pyramid),
    numpy."""
    r = np.random.RandomState(0)
    sizes = [227, 55, 17, 6]
    pyramid = _pyramid_draws(r, sizes, DEMO_KS, DEMO_CAPS)
    n0 = DEMO_CAPS[0]
    pos = np.zeros((n0, 3), np.float32)
    pos[: sizes[0]] = r.randn(sizes[0], 3) * 0.2
    return (pos, np.zeros((n0, 4), np.float32),
            np.zeros((16, n0, 4), np.float32), 4, pyramid)


def entry(device=None):
    """The flagship model's forward step at demo scale: (fn, args) with
    ``fn(*args)`` the motion-completion forward [512, 4] of the shipped
    weights (``checkpoints/motion_complete.npz``) on the demo-scale
    inputs, on ``device`` (the card unless ``cpu``)."""
    from occlusionfusion_tpu_torch.fusion.motion_runner import (
        pyramid_to_torch,
    )
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.models.motion_complete import (
        motion_complete_forward,
    )

    dev = resolve_device(device)
    net = load_motion_complete_net(device=dev)
    pos, curr, hist, hist_len, pyramid = demo_scale_inputs()

    def t(a):
        return torch.from_numpy(a).to(dev)

    @torch.no_grad()
    def fn(net, pos, curr, hist, hist_len, pyramid):
        return motion_complete_forward(net, pos, curr, hist, hist_len,
                                       pyramid)

    return fn, (net, t(pos), t(curr), t(hist),
                torch.tensor(hist_len, device=dev),
                pyramid_to_torch(pyramid, dev))


def train_sample(seed: int):
    """Phase 1's sample ``seed`` (numpy MotionBatch), as the JAX dry
    run's ``one_sample``."""
    from occlusionfusion_tpu_torch.models.motion_train import MotionBatch

    r = np.random.RandomState(seed)
    pyr = _pyramid_draws(r, TRAIN_SIZES, DEMO_KS, TRAIN_CAPS)
    mask = np.zeros(TRAIN_CAPS[0], np.float32)
    mask[: TRAIN_SIZES[0]] = 1
    n0 = TRAIN_CAPS[0]
    return MotionBatch(
        pos=r.randn(n0, 3).astype(np.float32),
        curr_motion=r.randn(n0, 4).astype(np.float32),
        history=r.randn(4, n0, 4).astype(np.float32),
        history_len=np.int32(4),
        gt_motion=r.randn(n0, 3).astype(np.float32),
        node_mask=mask,
        pyramid=pyr,
    )


def sphere_frames():
    """Phases 6-7's input: 96x96 frames of a 0.1 m sphere at 0.6 m
    receding 3 mm a frame (3 frames), f = 220 px."""
    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    h = w = 96
    intr = Intrinsics(220.0, 220.0, w / 2, h / 2)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    dirs = np.stack([(u - np.float32(intr.cx)) / np.float32(intr.fx),
                     (v - np.float32(intr.cy)) / np.float32(intr.fy),
                     np.ones_like(u)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    depths, colors = [], []
    for i in range(3):
        c = np.asarray([0.0, 0.0, 0.6]) + np.asarray([0.0, 0.0, 0.003]) * i
        b = dirs @ c
        disc = b * b - (c @ c - 0.1 * 0.1)
        tt = b - np.sqrt(np.maximum(disc, 0))
        depths.append(np.where((disc > 0) & (tt > 0), tt * dirs[..., 2],
                               0.0).astype(np.float32))
        colors.append(np.full((h, w, 3), 128.0, np.float32))
    return ArraySequence(colors, depths, intr)


def fusion_config(envelope: bool = False):
    """Phase 6's FusionConfig (or phase 7's, ``envelope``), with the GN
    weights JAX derives from its N-ICP weights when ``gn`` is None."""
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
    from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig

    nicp = NICPConfig(iters=20, w_motion=0.0, lr=0.02)
    base = dict(
        vol_dim=(64, 64, 64), voxel_size=0.006, node_coverage=0.03,
        max_nodes=512, max_points=8192, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=0.03, min_neighbors=2), nicp=nicp,
        use_motion_model=False, solver="gn_dense",
        gn=GNConfig(iters=6, w_point=nicp.w_ldmk, w_arap=nicp.w_arap,
                    w_motion=nicp.w_motion / 100.0),
    )
    if envelope:
        base.update(vol_dim=(128, 128, 128), voxel_size=0.003,
                    use_motion_model=True, brick_size=8, max_bricks=1024,
                    use_flow=True, use_lepard=True,
                    lepard_max_target_points=256)
    return FusionConfig(**base)


def envelope_nets(dev):
    """Phase 7's nets from the repo's checkpoints: (motion GNN, PWC,
    MaskNet, Lepard at the dry run's pyramid sizes)."""
    from occlusionfusion_tpu_torch.models.checkpoint import (
        lepard_config_from_json,
        load_flow_nets,
        load_lepard_checkpoint,
        load_motion_complete_net,
    )

    path = os.path.join(CHECKPOINTS, LEPARD)
    with open(path + ".json") as fh:
        cfg = lepard_config_from_json(json.load(fh))
    pyr = cfg.kpfcn.pyramid._replace(level_sizes=LEPARD_LEVELS)
    cfg = cfg._replace(kpfcn=cfg.kpfcn._replace(pyramid=pyr))
    pwc, mask = load_flow_nets(device=dev)
    lepard = load_lepard_checkpoint(path, device=dev, config=cfg)[0]
    return load_motion_complete_net(device=dev), pwc, mask, lepard


def sharded_engine_case(mesh, dev, envelope: bool, frames: int):
    """Phases 6 (``envelope`` False) and 7: initialize + build_fused on
    this rank, the single-rank ``fused_register_chunk`` over ``frames``
    frames twice, then the same frames through the sharded engine.
    Returns this rank's (max translation gap, max tsdf gap of its shard
    to the single-rank integrate through the sharded run's own
    transforms, max info gap, max tsdf gap of its shard to the first
    single-rank run, its voxels off that run by more than TSDF_LIMIT,
    and its voxels where the two single-rank runs differ by more).

    The volume is held through the sharded run's own transforms because
    two solves that differ by rounding (1e-8 m: the sharded sums run in
    another order, and on the card the kernels' atomics differ from run
    to run) move a few voxels at the silhouette across a pixel's
    rounding edge, where they read another depth; two single-rank runs
    on the card differ there as much."""
    from occlusionfusion_tpu_torch.fusion import tsdf as T
    from occlusionfusion_tpu_torch.fusion.fused_step import (
        _map_state,
        fused_register_chunk,
        warp_voxels,
    )
    from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
    from occlusionfusion_tpu_torch.fusion.warpfield import WarpFieldState
    from occlusionfusion_tpu_torch.parallel.engine import (
        fused_register_chunk_sharded,
        shard_state,
        shard_tables,
    )
    from occlusionfusion_tpu_torch.parallel.mesh import shard_rows

    seq = sphere_frames()
    cfg = fusion_config(envelope)
    motion_net, nets = None, {}
    if envelope:
        motion_net, pwc, mask, lepard = envelope_nets(dev)
        nets = dict(flow_net=pwc, mask_net=mask, lepard_net=lepard)
    fusion = DynamicFusion(seq, cfg, device=dev, **nets)
    fusion.initialize(seq.load(0))
    sc, state, tables = fusion.build_fused(motion_net)
    depths = torch.stack([torch.from_numpy(seq.load(i).depth)
                          for i in range(1, frames + 1)]).to(dev)
    colors = torch.stack([torch.from_numpy(seq.load(i).color)
                          for i in range(1, frames + 1)]).to(dev)
    perception = (nets.get("flow_net"), nets.get("mask_net"),
                  nets.get("lepard_net"))
    graphs = {}
    (ref, ref_infos), (ref2, _) = (fused_register_chunk(
        sc, _map_state(torch.clone, state), tables, motion_net, depths,
        colors, fusion.intr, *perception, graphs=graphs) for _ in range(2))
    got, tsdf0 = shard_state(mesh, state), state.tsdf
    local = shard_tables(mesh, tables)
    infos = []
    for f in range(frames):
        got, info = fused_register_chunk_sharded(
            mesh, sc, got, local, motion_net, depths[f:f + 1],
            colors[f:f + 1], fusion.intr, *perception)
        infos.append(info)
        warp = WarpFieldState(tables.nodes, tables.node_valid, got.rotations,
                              got.translations)
        tsdf0 = T.integrate(sc.tsdf, tsdf0, warp_voxels(sc, tables, warp),
                            tables.vox_valid, depths[f], colors[f],
                            fusion.intr)
    t_err = float((got.translations - ref.translations).abs().max())
    tsdf_err = float((got.tsdf.tsdf - shard_rows(mesh, tsdf0.tsdf))
                     .abs().max())
    raw = (got.tsdf.tsdf - shard_rows(mesh, ref.tsdf.tsdf)).abs()
    runs = shard_rows(mesh, (ref2.tsdf.tsdf - ref.tsdf.tsdf).abs())
    return (t_err, tsdf_err,
            float((torch.cat(infos) - ref_infos).abs().max()),
            float(raw.max()), int((raw > TSDF_LIMIT).sum()),
            int((runs > TSDF_LIMIT).sum()))


def _phase5_problem(dev):
    """The JAX dry run's phase-5 problem (8,192 points on a 0.5 m
    sphere, 512 nodes), skinned and linked on ``dev``."""
    from occlusionfusion_tpu_torch.geometry.skinning import skinning_weights
    from occlusionfusion_tpu_torch.ops.knn import knn_torch
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNProblem

    r = np.random.RandomState(2)
    n_pts, n_nodes = 8192, 512
    pts = r.randn(n_pts, 3).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= 0.5
    gnodes = pts[r.choice(n_pts, n_nodes, replace=False)]
    P, G = torch.from_numpy(pts).to(dev), torch.from_numpy(gnodes).to(dev)
    anchors, weights, valid = skinning_weights(P, G, None, 0.15, k=4)
    d2, idx = knn_torch(G, G, k=9)
    ew = torch.exp(-d2[:, 1:] / (2 * 0.15**2))
    ew = ew / torch.sum(ew, dim=1, keepdim=True)
    shift = torch.tensor([0.01, -0.005, 0.02], device=dev)
    return GNProblem(
        source_points=P, point_anchors=anchors, point_weights=weights,
        target_points=P + shift, point_valid=valid.to(torch.float32),
        nodes=G, node_valid=torch.ones(n_nodes, dtype=torch.bool,
                                       device=dev),
        edges=idx[:, 1:].contiguous(), edge_weights=ew.contiguous(),
        motion_targets=torch.zeros((n_nodes, 3), device=dev),
        motion_confidence=torch.zeros(n_nodes, device=dev),
        solve_node_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
    )


def _phase3_problem(dev, n_devices: int):
    """The JAX dry run's phase-3 problem (32 points a rank on the unit
    sphere, 16 nodes)."""
    from occlusionfusion_tpu_torch.geometry.skinning import skinning_weights
    from occlusionfusion_tpu_torch.ops.knn import knn_torch
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNProblem

    r = np.random.RandomState(1)
    n_pts, n_nodes = 32 * n_devices, 16
    sphere = r.randn(n_pts, 3).astype(np.float32)
    sphere /= np.linalg.norm(sphere, axis=1, keepdims=True)
    gn_nodes = sphere[r.choice(n_pts, n_nodes, replace=False)]
    S, G = (torch.from_numpy(sphere).to(dev),
            torch.from_numpy(gn_nodes).to(dev))
    anchors, weights, valid = skinning_weights(S, G, None, 0.5, k=4)
    d2, idx = knn_torch(G, G, k=5)
    return GNProblem(
        source_points=S, point_anchors=anchors, point_weights=weights,
        target_points=S + torch.tensor([0.01, 0.0, 0.02], device=dev),
        point_valid=valid.to(torch.float32), nodes=G,
        node_valid=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        edges=idx[:, 1:].contiguous(),
        edge_weights=torch.ones_like(d2[:, 1:]) / 4.0,
        motion_targets=torch.zeros((n_nodes, 3), device=dev),
        motion_confidence=torch.zeros(n_nodes, device=dev),
        solve_node_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
    )


def dryrun_rank(rank: int, world: int, device):
    """One rank of the dry run's seven phases (every rank draws the same
    inputs). Returns this rank's readings; ``dryrun_checks`` holds
    them."""
    from occlusionfusion_tpu_torch.fusion import tsdf as T
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.models.motion_train import (
        make_data_parallel_train_step,
        sample_to_torch,
    )
    from occlusionfusion_tpu_torch.models.optim import Adam
    from occlusionfusion_tpu_torch.parallel.distributed_gn import (
        solve_dense_distributed,
        solve_distributed,
    )
    from occlusionfusion_tpu_torch.parallel.mesh import (
        gather_blocks,
        make_fusion_mesh,
    )
    from occlusionfusion_tpu_torch.parallel.sequence import (
        integrate_slab,
        lstm_node_sharded,
    )
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
    from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
        solve_dense,
    )

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_fusion_mesh(device=dev)
    out = {"rank": rank}

    # 1. data-parallel train step: rank r holds sample r of the batch
    net = load_motion_complete_net(device=dev).train()
    step = make_data_parallel_train_step(net, Adam(net.parameters(), 1e-3),
                                         mesh)
    out["train_loss"] = float(step([sample_to_torch(train_sample(rank),
                                                    dev)]))
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    out["param_gap"] = float((gather_blocks(mesh, flat[None])
                              - flat).abs().max())

    # 2. x-slab integrate
    cfg = T.TSDFConfig(vol_dim=(8 * max(1, world), 16, 16), voxel_size=0.02,
                       trunc_margin=0.08)
    state = T.create_volume(cfg, (-0.2, -0.2, 0.7), dev)
    pts = T.voxel_world_points(cfg, state.origin)
    slab = integrate_slab(
        mesh, cfg, state, pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                          device=dev),
        torch.full((64, 64), 1.0, device=dev),
        torch.zeros((64, 64, 3), device=dev),
        Intrinsics(50.0, 50.0, 32.0, 32.0))
    out["slab_weight"] = float(gather_blocks(mesh, slab.weight).sum())

    # 3. matrix-free distributed GN-CG
    res = solve_distributed(mesh, _phase3_problem(dev, world),
                            GNConfig(iters=2, cg_iters=8))
    out["cg_valid"] = bool(res.valid)

    # 4. node-sharded LSTM
    hist = torch.zeros((8, 8 * world, 4), device=dev)
    out["lstm_shape"] = tuple(gather_blocks(
        mesh, lstm_node_sharded(mesh, net.seq_encoder, hist), dim=1).shape)

    # 5. the distributed dense solve at 512 nodes / 8,192 points
    problem = _phase5_problem(dev)
    cfg5 = GNConfig(iters=4, w_arap=2.0, assembly="blocks")
    n = problem.nodes.shape[0]
    eye = torch.eye(3, device=dev).expand(n, 3, 3).contiguous()
    zero = torch.zeros((n, 3), device=dev)
    ref = solve_dense(problem, cfg5, eye, zero)
    got = solve_dense_distributed(mesh, problem, cfg5)
    out["dense_valid"] = bool(got.valid)
    out["dense_dt"] = float((got.translations - ref.translations)
                            .abs().max())

    # 6-7. the sharded fused engine, and at the envelope
    out["engine"] = sharded_engine_case(mesh, dev, False, 2)
    out["envelope"] = sharded_engine_case(mesh, dev, True, 1)
    return out


def dryrun_checks(outs, n_devices: int) -> str:
    """The JAX dry run's asserts on every rank's readings, and its
    summary line."""
    for o in outs:
        assert np.isfinite(o["train_loss"]), o["train_loss"]
        assert o["param_gap"] == 0.0, (
            f"rank {o['rank']}: parameters differ across ranks by "
            f"{o['param_gap']}")
        assert o["slab_weight"] > 0, "sharded integrate updated nothing"
        assert o["cg_valid"], "distributed GN produced non-finite step"
        assert o["lstm_shape"] == (8, 8 * n_devices, 32), o["lstm_shape"]
        assert o["dense_valid"] and o["dense_dt"] < GN_LIMIT, (
            f"distributed dense GN drifted {o['dense_dt']}")
        for key, what in (("engine", "fused"), ("envelope", "envelope")):
            t_err, tsdf_err = o[key][:2]
            assert t_err < GN_LIMIT and tsdf_err < TSDF_LIMIT, (
                f"sharded {what} engine drifted: t {t_err}, tsdf {tsdf_err}")
    for key in ("engine", "envelope"):
        over = sum(o[key][4] for o in outs)
        runs = sum(o[key][5] for o in outs)
        assert over <= GAP_FACTOR * max(runs, 1), (
            f"sharded {key}: {over} voxels over {TSDF_LIMIT:g} off the "
            f"single-rank run, {runs} between two single-rank runs")
    worst = {k: max(o[k][0] for o in outs) for k in ("engine", "envelope")}
    tsdf = {k: max(o[k][1] for o in outs) for k in ("engine", "envelope")}
    info = max(o["engine"][2] for o in outs)
    raw = {k: (max(o[k][3] for o in outs), sum(o[k][4] for o in outs),
               sum(o[k][5] for o in outs)) for k in ("engine", "envelope")}
    dt = max(o["dense_dt"] for o in outs)
    return (f"dryrun_multichip ok: {n_devices} devices, train loss "
            f"{outs[0]['train_loss']:.4f}, integrated weight "
            f"{outs[0]['slab_weight']:.0f}, dist-GN valid, seq-sharded LSTM "
            f"ok, dist-dense-GN(512n/8192p) dt_err {dt:.2e}, sharded fused "
            f"engine dt {worst['engine']:.2e} / tsdf {tsdf['engine']:.2e} / "
            f"info {info:.2e}, sharded ENVELOPE engine (bricked 128^3 + flow "
            f"+ lepard + GNN, cap 512) dt {worst['envelope']:.2e} / tsdf "
            f"{tsdf['envelope']:.2e} (volumes against the single-device "
            f"runs: {raw['engine'][0]:.2e} / {raw['envelope'][0]:.2e}, "
            f"{raw['engine'][1]} / {raw['envelope'][1]} voxels over "
            f"{TSDF_LIMIT:g}, {raw['engine'][2]} / {raw['envelope'][2]} "
            f"between two single-device runs)")


def dryrun_multichip(n_devices: int, device=None) -> list:
    """The seven phases on ``n_devices`` ranks, held to the JAX dry run's
    limits (an assert fails the run); prints its summary line and
    returns every rank's readings."""
    from occlusionfusion_tpu_torch.parallel.mesh import launch

    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and n_devices <= torch.cuda.device_count():
        backend = "nccl"
    outs = launch(dryrun_rank, n_devices, str(dev), device=dev,
                  backend=backend)
    print(dryrun_checks(outs, n_devices), flush=True)
    return outs
