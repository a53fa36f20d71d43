"""The fused per-frame fusion step (port of
``occlusionfusion_tpu/fusion/fused_step.py``).

One frame: deform the model, projective correspondences and node
visibility, optionally PWC flow correspondences weighted by MaskNet and
Lepard scene flow, per-node motion observations, motion completion, the
warp solve (N-ICP, the default, or dense Gauss-Newton), then the voxel
LBS warp (kernel K2 on CUDA) and the TSDF integrate. The graph-dependent
tables are device-resident constants between keyframes. Nothing in the
step reads a value back to the host, so frames queue on the card back to
back, and a CUDA graph can capture them.

``fused_register_chunk`` is the counterpart of the JAX ``lax.scan`` over
a chunk of F frames: on the CPU it runs the F steps in order; on the card
it replays a CUDA graph over static device buffers, captured once per
(step config, chunk shape): with dense Gauss-Newton one graph holds all F
steps; with N-ICP (100 Adam iterations, ~32k device ops a step) one
graph holds one step and is replayed F times, each frame copied into its
input buffer in stream order before its replay.

Ported: ``solver="nicp"`` and ``"gn_dense"`` with projective
correspondences, the motion GNN, PWC flow in fill, override or advect
mode, with MaskNet weights or without MaskNet (dense or sparse lift, the
nets at 1/N resolution; the sparse lift with optional bf16 nets and a
1/N-resolution MaskNet; patchwise NMS of the weights, which takes the
dense lift), and the Lepard matcher on a deterministic subsample of the
target depth, in the frames the host's cadence gate picks
(``lepard_every``: the step takes ``run_lepard``, and a chunk graph holds
the matcher in exactly the steps whose absolute frame index runs it),
and the freezing of match-starved graph components
(``min_cluster_matches``, with the tables' ``node_clusters``).
``FusionConfig`` (``fusion/pipeline.py``) rejects the settings of the
branches not ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from occlusionfusion_tpu_torch.fusion import tsdf as T
from occlusionfusion_tpu_torch.fusion import warpfield as W
from occlusionfusion_tpu_torch.fusion.correspondence import (
    cluster_match_filter,
    depth_association_at_pixels,
    node_motion_observations,
    projective_correspondences,
)
from occlusionfusion_tpu_torch.fusion.motion_runner import (
    LEVEL_SIZES,
    MotionRunnerState,
    _unpack_pyramid,
    motion_step,
)
from occlusionfusion_tpu_torch import device as D
from occlusionfusion_tpu_torch.fusion.flow_correspondence import (
    flow_correspondences,
    flow_targets_at_points,
    patchwise_max_weights,
    sample_weight_field,
)
from occlusionfusion_tpu_torch.geometry.camera import (
    Intrinsics,
    backproject_depth,
    bilinear_sample,
)
from occlusionfusion_tpu_torch.models.lepard import scene_flow
from occlusionfusion_tpu_torch.ops.lbs import lbs_warp
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig, GNProblem
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import solve_dense
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig, NICPProblem
from occlusionfusion_tpu_torch.solvers.nicp import solve as nicp_solve


class FusionTables(NamedTuple):
    """Device-resident per-graph constants (rebuilt at keyframes only)."""

    vox_points: torch.Tensor  # [V, 3]
    vox_anchors: torch.Tensor  # [V, K]
    vox_weights: torch.Tensor  # [V, K]
    vox_valid: torch.Tensor  # [V]
    model_points: torch.Tensor  # [P, 3]
    model_valid: torch.Tensor  # [P]
    point_anchors: torch.Tensor  # [P, K]
    point_weights: torch.Tensor  # [P, K]
    point_valid: torch.Tensor  # [P]
    nodes: torch.Tensor  # [N, 3]
    node_valid: torch.Tensor  # [N]
    edges: torch.Tensor  # [N, K_e]
    edge_weights: torch.Tensor  # [N, K_e]
    pyramid_ints: torch.Tensor  # packed pyramid (motion_runner layout)
    n_nodes: torch.Tensor  # 0-d int32
    # connected component of each node (-1 padded), for freezing
    # match-starved components; None unless min_cluster_matches
    node_clusters: torch.Tensor = None
    # N-ICP's chamfer subsamples [iters + 1, 2, S] (nicp.solve); None
    # unless nicp.w_chamfer
    chamfer_table: torch.Tensor = None


class FusionStepState(NamedTuple):
    tsdf: T.TSDFState
    rotations: torch.Tensor  # [N, 3, 3] canonical -> current
    translations: torch.Tensor  # [N, 3]
    motion: MotionRunnerState
    # the previous frame's RGB-XYZ image [6, H, W], the flow source (None
    # unless the step runs flow)
    prev_rgbxyz: torch.Tensor = None


class FusedStepConfig(NamedTuple):
    tsdf: T.TSDFConfig
    gn: GNConfig
    max_depth_diff: float = 0.1
    use_motion_model: bool = True
    # pyramid padding buckets; must equal level_sizes_for(node cap)
    motion_levels: tuple = LEVEL_SIZES
    # PWC flow correspondences, weighted by MaskNet where a mask_net is
    # given (a flow target then needs a sampled weight above
    # flow_mask_threshold), else by their validity
    use_flow: bool = False
    flow_mask_threshold: float = 0.35
    # "fill": flow targets only for points without a projective target;
    # "override": flow targets wherever the flow's gate passes;
    # "advect": each projection advected by the flow, the target the
    # along-ray depth association at the advected pixel, weighted
    # flow_advect_weight x the flow's weight, with a fill rescue where
    # that association fails (pipeline.FusionConfig has the knobs)
    flow_mode: str = "fill"
    flow_advect_min_px: float = 0.0
    flow_advect_weight: float = 1.0
    flow_advect_mask_threshold: float | None = None
    flow_advect_alpha: float = 1.0
    # patchwise non-max suppression of the MaskNet weights in PxP patches
    # (0 = off); it needs the pixel grid, so it takes the dense lift
    flow_mask_patch: int = 0
    # PWC + MaskNet at 1/N resolution
    flow_downscale: int = 1
    # "dense": lift every pixel, then sample at the model projections;
    # "sparse": lift at the projections only (flow_targets_at_points)
    flow_lift: str = "dense"
    # sparse lift only: PWC + MaskNet in bfloat16, MaskNet at 1/N
    flow_bf16: bool = False
    mask_downscale: int = 1
    # Lepard scene flow on a deterministic subsample of the target depth
    # ("topk" or "strided", lepard_max_target_points), in the frames whose
    # absolute index is a multiple of lepard_every (the host's gate,
    # lepard_gate, passed to the step as run_lepard)
    use_lepard: bool = False
    lepard_max_target_points: int = 2048
    lepard_every: int = 1
    lepard_subsample: str = "topk"
    # warp solver: "nicp" (Adam over ARAP + landmark + motion costs) or
    # "gn_dense" (the gn config above)
    solver: str = "nicp"
    nicp: NICPConfig = NICPConfig(iters=100)
    # freeze the graph components whose summed match weight is below
    # this (0 = off; tables.node_clusters required): their nodes leave
    # the dense solve and their matches drop out of either solve
    min_cluster_matches: float = 0.0


def _rgbxyz_image(depth, color, intr: Intrinsics):
    """[6, H, W]: RGB in 0..1, then the camera-space point image (the
    PWC/MaskNet input)."""
    xyz = backproject_depth(depth, intr)
    return torch.cat([color.permute(2, 0, 1) / 255.0, xyz.permute(2, 0, 1)])


def _deterministic_target_subsample(depth, intr: Intrinsics, cap: int,
                                    method: str = "topk"):
    """Static-cap subsample of the target depth cloud on the device ->
    (points [cap, 3], valid [cap]). Each valid pixel i has the key
    (i * 2654435761 mod 2^32) >> 1 (Knuth's hash), invalid ones -1.
    ``topk``: the ``cap`` largest keys (a stable sort: the lower index
    first among equal keys, as ``lax.top_k``). ``strided``: ``cap``
    contiguous flat blocks, each giving its largest key (the first among
    equal ones, as ``argmax``), with no sort."""
    pts = backproject_depth(depth, intr).reshape(-1, 3)
    n = pts.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=depth.device)
    key = ((idx * 2654435761) & 0xFFFFFFFF) >> 1
    key = torch.where(depth.reshape(-1) > 0, key, torch.full_like(key, -1))
    if method == "strided":
        m = -(-n // cap)
        blocks = F.pad(key, (0, cap * m - n), value=-1).reshape(cap, m)
        j = torch.argmax(blocks, dim=1)
        rows = torch.arange(cap, device=depth.device)
        flat_idx = torch.clamp(rows * m + j, max=n - 1)
        return pts[flat_idx], blocks[rows, j] >= 0
    top, order = torch.sort(key, descending=True, stable=True)
    return pts[order[:cap]], top[:cap] >= 0


def _flow_correspondences(config: FusedStepConfig, prev_rgbxyz, cur_rgbxyz,
                          deformed_pts, assoc_depth, intr: Intrinsics,
                          flow_net, mask_net, targets, corr_valid,
                          corr_weight):
    """PWC prev -> current lifted to 3-D targets at the deformed points'
    projections, gated by MaskNet's weight (where a mask_net is given) and
    combined with the projective targets by ``config.flow_mode``. Advect
    associates ``assoc_depth`` at the advected pixels. Returns (targets,
    corr_valid, corr_weight, flow_ok [P], the points flow set)."""
    z = torch.clamp(deformed_pts[:, 2], min=1e-6)
    u = deformed_pts[:, 0] / z * intr.fx + intr.cx
    v = deformed_pts[:, 1] / z * intr.fy + intr.cy
    h_im, w_im = assoc_depth.shape
    inb = (u >= 0) & (u <= w_im - 1) & (v >= 0) & (v <= h_im - 1)
    front = deformed_pts[:, 2] > 0
    uv = torch.stack([u, v], dim=-1)
    advect = config.flow_mode == "advect"
    wsamp = uv2 = None
    # patchwise NMS needs the pixel grid: it takes the dense lift
    if config.flow_lift == "sparse" and not config.flow_mask_patch:
        lifted = flow_targets_at_points(
            flow_net, prev_rgbxyz, cur_rgbxyz, uv, mask_net,
            bf16=config.flow_bf16, mask_downscale=config.mask_downscale,
            downscale=config.flow_downscale, return_uv2=advect,
        )
        sampled, pvalid, wsamp = lifted[:3]
        uv2 = lifted[3] if advect else None
        ok = inb & pvalid & front
    else:
        flow_full, flow_targets, flow_valid, flow_weights = (
            flow_correspondences(flow_net, prev_rgbxyz, cur_rgbxyz, mask_net,
                                 downscale=config.flow_downscale)
        )
        if advect:
            uv2 = uv + bilinear_sample(flow_full, uv)
        nms = mask_net is not None and config.flow_mask_patch > 0
        if nms:
            flow_weights = patchwise_max_weights(flow_weights,
                                                 config.flow_mask_patch)
        sampled = bilinear_sample(flow_targets, uv)
        vsamp = bilinear_sample(
            flow_valid[..., None].to(torch.float32), uv
        )[:, 0]
        ok = inb & (vsamp > 0.5) & front
        if mask_net is not None:
            wsamp = sample_weight_field(flow_weights, u, v, nms)
    if mask_net is not None:
        ok = ok & (wsamp > config.flow_mask_threshold)
        w_flow = torch.clamp(wsamp, 0.0, 1.0)
    else:
        w_flow = torch.ones_like(u)
    if advect:
        # the flow's tangential step with the along-ray depth at the
        # advected pixel; the lifted target rescues points where that
        # association fails and no projective target exists
        adv_t, adv_dvalid = depth_association_at_pixels(
            uv2[:, 0], uv2[:, 1], deformed_pts[:, 2], assoc_depth, intr,
            config.max_depth_diff,
        )
        gate = inb & front
        if mask_net is not None:
            thr = config.flow_advect_mask_threshold
            gate = gate & (wsamp > (config.flow_mask_threshold
                                    if thr is None else thr))
        if config.flow_advect_min_px > 0.0:
            gate = gate & (torch.linalg.vector_norm(uv2 - uv, dim=-1)
                           >= config.flow_advect_min_px)
        adv_ok = gate & adv_dvalid
        if config.flow_advect_alpha < 1.0:
            # alpha and 1 - alpha rounded in f32, as the JAX package does
            a = np.float32(config.flow_advect_alpha)
            adv_t = torch.where(corr_valid[:, None],
                                float(a) * adv_t + float(1 - a) * targets,
                                adv_t)
        fill_ok = ok & ~adv_ok & ~corr_valid
        targets = torch.where(
            adv_ok[:, None], adv_t,
            torch.where(fill_ok[:, None], sampled, targets),
        )
        corr_weight = torch.where(
            adv_ok, w_flow * config.flow_advect_weight, corr_weight)
        corr_weight = torch.where(fill_ok, w_flow, corr_weight)
        ok = adv_ok | fill_ok
    else:
        if config.flow_mode == "fill":
            ok = ok & ~corr_valid
        if mask_net is not None:
            corr_weight = torch.where(ok, w_flow, corr_weight)
        else:
            corr_weight = torch.maximum(corr_weight, ok.to(torch.float32))
        targets = torch.where(ok[:, None], sampled, targets)
    return targets, corr_valid | ok, corr_weight, ok


@torch.no_grad()
def fused_register_frame(
    config: FusedStepConfig,
    state: FusionStepState,
    tables: FusionTables,
    motion_net,
    depth: torch.Tensor,  # [H, W]
    color: torch.Tensor,  # [H, W, 3]
    intr: Intrinsics,
    flow_net=None,
    mask_net=None,
    lepard_net=None,
    corr_depth: torch.Tensor | None = None,  # [H, W]
    run_lepard: bool = True,
    init=None,
):
    """One frame. Returns (state, info [7] f32: final_loss,
    n_correspondences, n_visible_nodes, mean_conf, solve_valid,
    n_flow_filled, n_lepard_matches). With ``config.use_flow`` the PWC
    ``flow_net`` is required (``mask_net`` optional) and
    ``state.prev_rgbxyz`` holds the previous frame; with
    ``config.use_lepard`` the ``lepard_net``, which runs where the host's
    ``run_lepard`` says (the cadence gate on the absolute frame index; a
    skipped frame launches none of the matcher's ops and counts 0
    matches). ``corr_depth``, where given, is the depth the projective
    association and advect's association read (the stepwise loop's, with
    boundary pixels zeroed); everything else reads ``depth``. ``init``,
    where given, is the (rotations, translations) the solve starts from
    instead of the state's (the stepwise loop's first frame after a
    growth, as the JAX stepwise loop warm-starts it)."""
    warp = W.WarpFieldState(
        node_positions=tables.nodes,
        node_valid=tables.node_valid,
        rotations=state.rotations,
        translations=state.translations,
    )
    point_table = W.SkinTable(
        tables.point_anchors, tables.point_weights, tables.point_valid
    )
    assoc_depth = depth if corr_depth is None else corr_depth

    # 1. deform model + nodes
    deformed_pts = W.deform_points(warp, tables.model_points, point_table)
    deformed_nodes = warp.deformed_nodes

    # 2. correspondences + visibility
    targets, corr_valid = projective_correspondences(
        deformed_pts, tables.model_valid & tables.point_valid, assoc_depth,
        intr, max_depth_diff=config.max_depth_diff,
    )
    node_visible, _ = T.check_visibility(
        deformed_nodes, depth, intr, config.tsdf.trunc_margin
    )
    node_visible = node_visible & tables.node_valid
    corr_weight = corr_valid.to(torch.float32)

    # 2b. flow correspondences (fill, override or advect)
    cur_rgbxyz = state.prev_rgbxyz
    flow_ok = torch.zeros_like(corr_valid)
    if config.use_flow:
        cur_rgbxyz = _rgbxyz_image(depth, color, intr)
        targets, corr_valid, corr_weight, flow_ok = _flow_correspondences(
            config, state.prev_rgbxyz, cur_rgbxyz, deformed_pts, assoc_depth,
            intr, flow_net, mask_net, targets, corr_valid, corr_weight,
        )

    # 2c. Lepard scene flow on a deterministic subsample of the target
    # depth: matcher targets replace the others where the blend holds
    lmask = torch.zeros_like(corr_valid)
    if config.use_lepard and run_lepard:
        tgt_pcd, tgt_valid = _deterministic_target_subsample(
            depth, intr, config.lepard_max_target_points,
            config.lepard_subsample,
        )
        lflow, lmask, _ = scene_flow(
            lepard_net, deformed_pts, tables.model_valid & tables.point_valid,
            tgt_pcd, tgt_valid,
        )
        targets = torch.where(lmask[:, None], deformed_pts + lflow, targets)
        corr_valid = corr_valid | lmask
        corr_weight = torch.maximum(corr_weight, lmask.to(torch.float32))

    # 2d. freeze match-starved graph components: their nodes keep their
    # transforms in the dense solve and their matches drop out
    solve_mask = tables.node_valid
    if config.min_cluster_matches and tables.node_clusters is not None:
        solve_mask, corr_weight = cluster_match_filter(
            tables.point_anchors, tables.point_weights, corr_weight,
            tables.node_clusters, tables.node_valid,
            config.min_cluster_matches,
        )
        corr_valid = corr_valid & (corr_weight > 0)

    # 3. per-node motion observations
    node_motion, node_observed = node_motion_observations(
        deformed_pts, targets, corr_valid, tables.point_anchors,
        tables.point_weights, deformed_nodes, node_visible,
    )

    # 4. motion completion
    if config.use_motion_model and motion_net is not None:
        pyramid = _unpack_pyramid(tables.pyramid_ints, config.motion_levels)
        motion_state, (completed, conf) = motion_step(
            motion_net, state.motion, deformed_nodes, node_motion,
            node_observed, tables.n_nodes, pyramid,
            n0_cap=config.motion_levels[0],
        )
        motion_targets = deformed_nodes + completed
        motion_conf = conf[:, 0]
    else:
        motion_state = state.motion
        motion_targets = deformed_nodes + node_motion
        motion_conf = node_observed.to(torch.float32)

    # 5. warp solve, warm started at the current transforms
    init_R, init_t = ((state.rotations, state.translations) if init is None
                      else init)
    if config.solver == "nicp":
        idx = torch.arange(tables.model_points.shape[0],
                           device=tables.model_points.device)
        result = nicp_solve(NICPProblem(
            source_points=tables.model_points,
            point_anchors=tables.point_anchors,
            point_weights=tables.point_weights,
            point_valid=tables.model_valid & tables.point_valid,
            nodes=tables.nodes,
            node_valid=tables.node_valid,
            edges=tables.edges,
            edge_weights=tables.edge_weights,
            target_points=targets,
            landmark_src=idx,
            landmark_tgt=idx,
            landmark_valid=corr_weight,
            motion_targets=motion_targets,
            motion_confidence=motion_conf,
        ), config.nicp, init_rotations=init_R, init_translations=init_t,
            chamfer_table=tables.chamfer_table)
        final_loss = result.final_loss
        solve_valid = torch.isfinite(final_loss)
    else:
        result = solve_dense(GNProblem(
            source_points=tables.model_points,
            point_anchors=tables.point_anchors,
            point_weights=tables.point_weights,
            target_points=targets,
            point_valid=corr_weight,
            nodes=tables.nodes,
            node_valid=tables.node_valid,
            edges=tables.edges,
            edge_weights=tables.edge_weights,
            motion_targets=motion_targets,
            motion_confidence=motion_conf,
            solve_node_mask=solve_mask,
            intrinsics=(intr.fx, intr.fy, intr.cx, intr.cy),
        ), config.gn, init_rotations=init_R, init_translations=init_t)
        final_loss = result.residual_history[-1]
        solve_valid = result.valid

    # 6. integrate through the updated warp
    new_warp = warp._replace(
        rotations=result.rotations, translations=result.translations
    )
    # kernel K2 on CUDA tensors, its twin on CPU tensors (the JAX
    # lbs_impl="auto" choice, made here from the device)
    warped_vox = lbs_warp(
        tables.vox_points, tables.vox_anchors, tables.vox_weights,
        tables.vox_valid, new_warp,
    )
    new_tsdf = T.integrate(
        config.tsdf, state.tsdf, warped_vox, tables.vox_valid, depth, color,
        intr,
    )

    info = torch.stack([
        final_loss,
        torch.sum(corr_valid).to(torch.float32),
        torch.sum(node_visible).to(torch.float32),
        torch.sum(motion_conf) / torch.clamp(
            torch.sum(tables.node_valid), min=1
        ).to(torch.float32),
        solve_valid.to(torch.float32),
        torch.sum(flow_ok).to(torch.float32),
        torch.sum(lmask).to(torch.float32),
    ])
    new_state = FusionStepState(
        tsdf=new_tsdf,
        rotations=result.rotations,
        translations=result.translations,
        motion=motion_state,
        prev_rgbxyz=cur_rgbxyz,
    )
    return new_state, info


def _map_state(fn, x):
    """``fn`` over every tensor of a (nested) state; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    return type(x)(*(_map_state(fn, v) for v in x))


def _copy_state_(dst, src) -> None:
    """Copy every tensor of ``src`` into its slot of ``dst`` (in place)."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, s in zip(dst, src):
        _copy_state_(d, s)


def graph_steps(config: FusedStepConfig, frames: int) -> int:
    """Steps one captured graph holds for a chunk of ``frames``: all of
    them with dense Gauss-Newton, one with N-ICP (its 100 Adam iterations
    make a step ~32k device ops, which take 1-2 s to capture; the one
    step's graph is replayed once per frame)."""
    return 1 if config.solver == "nicp" else frames


class ChunkGraph:
    """``steps`` fused steps captured back to back in one CUDA graph.

    The steps read static device buffers (``steps`` depth and colour
    frames and the carried state: TSDF, node transforms, motion-runner
    state, the previous RGB-XYZ image) and each writes its new state back
    into them with ``copy_`` and its info row into a static [steps, 7]
    buffer. Step j runs the Lepard matcher iff ``lepard_on[j]`` (the
    cadence gate of its frame, fixed at capture: a graph per pattern). A
    run of F frames is F / ``steps`` replays, each after its frames are
    copied into the frame buffers in stream order, so the state stays in
    the graph's buffers from one replay to the next and the host never
    waits inside it. Before capture one step runs on a side stream, on a
    clone of the state (one for each gate value of the pattern, the first
    step's first), which loads the kernel library, makes the bf16 twins
    of the nets and creates the cuBLAS, cuSOLVER and cuDNN handles and
    workspaces, and runs autograd once (N-ICP); the real state does not
    advance."""

    def __init__(self, config: FusedStepConfig, state: FusionStepState,
                 tables: FusionTables, nets, depths, colors,
                 intr: Intrinsics, steps: int, lepard_on: tuple):
        dev = depths.device
        self.keep = (tables, nets)  # the graph reads their memory
        self.steps = steps
        self.lepard_on = lepard_on
        self.state = _map_state(torch.clone, state)
        self.depths = depths[:steps].clone()
        self.colors = colors[:steps].clone()
        self.infos = torch.zeros((steps, 7), dtype=torch.float32, device=dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # one warm-up step per gate value the capture holds, the first
            # step's own first
            for on in dict.fromkeys(lepard_on):
                fused_register_frame(config, _map_state(torch.clone, state),
                                     tables, nets[0], self.depths[0],
                                     self.colors[0], intr, *nets[1:],
                                     run_lepard=on)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with D.capturing() as counts, torch.cuda.graph(self.graph,
                                                       stream=stream):
            for j in range(steps):
                new, info = fused_register_frame(
                    config, self.state, tables, nets[0], self.depths[j],
                    self.colors[j], intr, *nets[1:],
                    run_lepard=lepard_on[j],
                )
                _copy_state_(self.state, new)
                self.infos[j].copy_(info)
        # host seconds of the capture; the kernel launches one replay makes
        self.capture_s = time.perf_counter() - t0
        self.counts = counts

    def replay(self, state, depths, colors):
        """Run the F frames of ``depths``/``colors`` (a multiple of
        ``steps``) from ``state``: returns (state, infos [F, 7]), copies
        the caller keeps (the next call overwrites the graph's
        buffers)."""
        n = depths.shape[0]
        if n % self.steps:
            raise ValueError(f"{n} frames for a graph of {self.steps} steps")
        infos = torch.empty((n, 7), dtype=torch.float32, device=depths.device)
        _copy_state_(self.state, state)
        for lo in range(0, n, self.steps):
            self.depths.copy_(depths[lo:lo + self.steps])
            self.colors.copy_(colors[lo:lo + self.steps])
            self.graph.replay()
            D.count_replay(self.counts)
            infos[lo:lo + self.steps].copy_(self.infos)
        return _map_state(torch.clone, self.state), infos


def lepard_gate(config: FusedStepConfig, frame_ids) -> tuple:
    """The Lepard cadence gate of each frame: True where the matcher runs
    (``config.use_lepard`` and the absolute frame index a multiple of
    ``config.lepard_every``, as the JAX stepwise loop's
    ``frame.index % lepard_every``)."""
    return tuple(bool(config.use_lepard) and i % config.lepard_every == 0
                 for i in frame_ids)


@torch.no_grad()
def fused_register_chunk(
    config: FusedStepConfig,
    state: FusionStepState,
    tables: FusionTables,
    motion_net,
    depths: torch.Tensor,  # [F, H, W]
    colors: torch.Tensor,  # [F, H, W, 3]
    intr: Intrinsics,
    flow_net=None,
    mask_net=None,
    lepard_net=None,
    *,
    graphs: dict,
    lepard_on=None,
):
    """F frames in order -> (state, infos [F, 7]), the counterpart of the
    JAX ``lax.scan`` chunk. ``lepard_on`` [F] says in which frames the
    matcher runs (``lepard_gate``; None: in every frame where
    ``config.use_lepard``). On CPU tensors the F eager steps; on CUDA
    tensors CUDA graph replays (``graph_steps``: one replay of F captured
    steps with dense Gauss-Newton, F replays of one captured step with
    N-ICP), a graph for each pattern of the gate over its steps, captured
    at the first call for this step config, step count, frame shape,
    tables, nets and pattern and kept in ``graphs``, a dict the caller
    owns (``DynamicFusion.graphs``). Consecutive blocks of steps with one
    pattern replay one graph. A capture that fails raises: there is no
    eager fallback on the card."""
    nets = (motion_net, flow_net, mask_net, lepard_net)
    n = depths.shape[0]
    if lepard_on is None:
        lepard_on = (bool(config.use_lepard),) * n
    lepard_on = tuple(bool(x) and config.use_lepard for x in lepard_on)
    if len(lepard_on) != n:
        raise ValueError(f"{len(lepard_on)} gate entries for {n} frames")
    if not depths.is_cuda:
        infos = []
        for j in range(n):
            state, info = fused_register_frame(
                config, state, tables, motion_net, depths[j], colors[j],
                intr, flow_net, mask_net, lepard_net,
                run_lepard=lepard_on[j],
            )
            infos.append(info)
        return state, torch.stack(infos)
    steps = graph_steps(config, n)
    base = (config, steps, tuple(depths.shape[1:]), tuple(colors.shape[1:]),
            tuple(intr), id(tables), *map(id, nets))
    outs, lo = [], 0
    while lo < n:
        pattern = lepard_on[lo:lo + steps]
        hi = lo + steps
        while hi < n and lepard_on[hi:hi + steps] == pattern:
            hi += steps
        key = base + (pattern,)
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = ChunkGraph(
                config, state, tables, nets, depths[lo:hi], colors[lo:hi],
                intr, steps, pattern)
        state, out = graph.replay(state, depths[lo:hi], colors[lo:hi])
        outs.append(out)
        lo = hi
    return state, torch.cat(outs)
