"""DynamicFusion orchestrator (port of
``occlusionfusion_tpu/fusion/pipeline.py``).

``initialize`` integrates the first frame into a dense or bricked
volume, extracts the mesh and builds the deformation graph on the host,
and skins the model points and every voxel (kernel K1 on CUDA).
``build_fused`` packs the device-resident tables and state;
``register_frame_fused`` runs one eager fused step; ``run_fused`` drives
a sequence through the chunked engine (``fused_register_chunk``: CUDA
graph replays on the card), reading the per-frame info back once per
chunk while the next chunk runs. ``register_frame`` and ``run`` are the
stepwise loop: one eager step a frame on the object's own state, with
depth-boundary pixels left out of the association and the flow lifted
densely at full resolution, as the JAX stepwise loop does; it reads each
frame's info back. ``get_deformed_mesh`` returns the canonical mesh
warped to the current frame (kernel K1 skins its vertices).

Ported: the dense and the bricked volume with ``solver="nicp"`` (the
default) or ``"gn_dense"``, projective correspondences, the motion GNN,
PWC flow in fill, override or advect mode, with MaskNet weights or
without MaskNet (dense or sparse lift, PWC at 1/N resolution; bf16 nets
and a 1/N MaskNet with the sparse lift; patchwise NMS of the weights,
which takes the dense lift), the Lepard matcher (topk or strided
target subsample) every ``lepard_every``-th absolute frame in both
engines, and the keyframe machinery in both engines: graph growth every
``growth_interval``-th frame (with the bricked volume's active-set
refresh, K1 re-skinning the voxel slots and the model points),
keyframes every ``keyframe_interval``-th frame with relocalization
(observation-grounded rigid re-anchoring, wide-baseline recovery from a
lost track, optionally seeded by the matcher) and loop closures over a
keyframe pose graph (``trajectory``), freezing of match-starved graph
components (``min_cluster_matches``), and ``save_state``/``load_state``
in the JAX package's snapshot layout. Every solver setting of the JAX
package runs: N-ICP with its chamfer cost (the subsample table
``nicp.default_chamfer_table``, or the caller's ``chamfer_table``), and
``"gn_dense"`` with each linear solver and either data term. N-ICP's
rendered costs do nothing on these paths, as in the JAX package, whose
problems carry no target depth (ROADMAP F14). ``lbs_impl`` chooses the
fused engine's voxel warp as in JAX: ``"dense"`` precomputes the voxels'
dense skinning matrix (``ops/lbs.DenseSkin``) in ``build_fused`` where it
fits ``dense_skin_max_bytes`` and warps by two matrix products a frame,
on either device (JAX's ``"auto"`` builds it on a TPU only, so the
port's ``"auto"`` never does); every other value warps by K2 on the card
and its twin on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from occlusionfusion_tpu_torch.device import resolve_device
from occlusionfusion_tpu_torch.fusion import bricks as BR
from occlusionfusion_tpu_torch.fusion import tsdf as T
from occlusionfusion_tpu_torch.fusion import warpfield as W
from occlusionfusion_tpu_torch.fusion.fused_step import (
    FusedStepConfig,
    FusionStepState,
    FusionTables,
    _deterministic_target_subsample,
    _rgbxyz_image,
    fused_register_chunk,
    LBS_IMPLS,
    fused_register_frame,
    lepard_gate,
)
from occlusionfusion_tpu_torch.fusion.frame_loader import Frame
from occlusionfusion_tpu_torch.fusion.graph_growth import grow_graph
from occlusionfusion_tpu_torch.fusion.loop_closure import (
    rigid_depth_alignment,
)
from occlusionfusion_tpu_torch.fusion.motion_runner import (
    MotionRunnerState,
    _packed_layout,
    init_state,
    level_sizes_for,
    pack_frame,
)
from occlusionfusion_tpu_torch.fusion.pose_graph import (
    PoseGraph,
    optimize_pose_graph,
)
from occlusionfusion_tpu_torch.geometry.kabsch import weighted_kabsch
from occlusionfusion_tpu_torch.graph import native
from occlusionfusion_tpu_torch.graph.edgraph import (
    GraphConfig,
    build_graph_from_mesh,
    build_pyramid_from_nodes,
)
from occlusionfusion_tpu_torch.models.lepard import scene_flow
from occlusionfusion_tpu_torch.ops.lbs import (
    dense_skin_bytes,
    precompute_dense_skin,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import (
    DATA_TERMS,
    LINEAR_SOLVERS,
    GNConfig,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
    check_assembly,
)
from occlusionfusion_tpu_torch.solvers.nicp import (
    NICPConfig,
    default_chamfer_table,
)
from occlusionfusion_tpu_torch.utils.snapshot import load_params, save_pytree


@dataclass
class FusionConfig:
    vol_dim: tuple = (128, 128, 128)
    voxel_size: float = 0.005
    trunc_margin_vox: float = 4.0
    node_coverage: float = 0.05
    max_nodes: int = 512
    max_points: int = 8192
    max_depth_diff: float = 0.1
    graph: GraphConfig = field(default_factory=GraphConfig)
    nicp: NICPConfig = field(default_factory=lambda: NICPConfig(iters=100))
    # the weights the JAX package derives for solver="gn_dense" when its
    # gn is None (fusion/fused_step.py:556-561): iters 6, w_point =
    # nicp.w_ldmk, w_arap = nicp.w_arap, w_motion = nicp.w_motion / 100
    # at the NICPConfig defaults
    gn: GNConfig = field(default_factory=lambda: GNConfig(
        iters=6, w_point=1.0, w_arap=10.0, w_motion=1.0))
    use_motion_model: bool = True
    # warp solver: "nicp" (Adam, the nicp config) or "gn_dense" (the gn
    # config)
    solver: str = "nicp"
    # the fused engine's voxel warp (FusedStepConfig.lbs_impl): "dense"
    # builds the dense skin in build_fused where dense_skin_bytes(voxels,
    # max_nodes) <= dense_skin_max_bytes; "auto", "pallas", "xla": K2
    lbs_impl: str = "auto"
    dense_skin_max_bytes: int = 1 << 30
    # 0 = dense grid; > 0 = brick edge in voxels; -1 (the JAX default) =
    # auto: bricks of 8 at >= 128^3 virtual voxels, dense below. Bricks
    # near the first frame's surface (bricks.active_bricks_from_depth)
    # are allocated in max_bricks static slots.
    brick_size: int = -1
    max_bricks: int = 2048
    # bricks of dilation around the observed truncation band, at
    # initialize and at each growth keyframe's active-set refresh
    brick_dilate: int = 1
    # PWC flow correspondences (flow_net given to DynamicFusion), with
    # MaskNet weights where a mask_net is given (a flow target then needs
    # a sampled weight above flow_mask_threshold) and weight 1 where the
    # flow is valid without one
    use_flow: bool = False
    flow_mask_threshold: float = 0.35
    # how flow combines with projective association: "fill" (flow only
    # for points without a projective target), "override" (flow wherever
    # its gate passes, the reference's behaviour) or "advect" (each
    # projection advected by the flow, the target the along-ray depth
    # association at the advected pixel; the lifted target rescues points
    # where that fails and no projective target exists)
    flow_mode: str = "fill"
    # advect only: the least flow (px) that advects (0 = any); the
    # solver weight of an advected target (x its MaskNet weight); the
    # MaskNet threshold of an advected target (None = flow_mask_threshold);
    # target = alpha * advected + (1 - alpha) * projective where both hold
    flow_advect_min_px: float = 0.0
    flow_advect_weight: float = 1.0
    flow_advect_mask_threshold: float | None = None
    flow_advect_alpha: float = 1.0
    # PWC + MaskNet at 1/N resolution (the lift stays at full resolution)
    flow_downscale: int = 1
    # patchwise non-max suppression of the MaskNet weights in PxP patches
    # (0 = off), sampled at the nearest pixel; it needs the pixel grid, so
    # the fused engine then lifts densely in f32 whatever flow_lift says
    flow_mask_patch: int = 0
    # "dense" lifts every pixel and samples at the model projections;
    # "sparse" lifts at the projections only
    flow_lift: str = "dense"
    # sparse lift only: PWC + MaskNet in bfloat16; MaskNet at 1/N (the
    # dense lift runs in f32 at full resolution and ignores both, as JAX)
    flow_bf16: bool = False
    mask_downscale: int = 1
    # Lepard scene flow (lepard_net given to DynamicFusion) on a
    # deterministic "topk" or "strided" subsample of the target depth, in
    # the frames whose absolute index is a multiple of lepard_every (both
    # engines; the chunked engine holds the matcher in exactly those
    # steps of its graphs)
    use_lepard: bool = False
    lepard_max_target_points: int = 4096
    lepard_every: int = 1
    lepard_subsample: str = "topk"
    # grow the graph onto newly observed surface every N-th frame (0 =
    # off); in the chunked engine once per chunk that holds such a frame,
    # at its last frame
    growth_interval: int = 0
    # record a keyframe every N-th frame (0 = off): relocalize against its
    # observation, then close loops against the keyframes at least
    # loop_min_separation (>= 2) keyframes older and within loop_radius
    # (m) whose rigid alignment (loop_align_iters rounds) keeps at least
    # loop_min_inliers of the points with a median residual under
    # loop_max_residual (m); the last max_keyframes are kept
    keyframe_interval: int = 0
    max_keyframes: int = 64
    loop_radius: float = 0.3
    loop_align_iters: int = 5
    loop_min_inliers: float = 0.3
    loop_min_separation: int = 5
    loop_max_residual: float = 0.01
    # freeze graph components whose summed match weight drops below this
    # (0 = off)
    min_cluster_matches: float = 0.0
    # relocalize only where the model is off the surface (median residual
    # above relocalize_threshold) and the rigid fix halves the residual;
    # after a lost track (fewer than 16 correspondences in a frame) only
    # with relocalize_recovery, at least relocalize_min_obs_px observed
    # pixels and relocalize_recover_inliers of the points on the surface
    # after it, the search seeded by the matcher's Kabsch pose where it
    # blends at least relocalize_feat_min_points (0 = never)
    relocalize_threshold: float = 0.02
    relocalize_min_obs_px: int = 400
    relocalize_recover_inliers: float = 0.5
    relocalize_recovery: bool = False
    relocalize_feat_min_points: int = 0
    # a correction (rotation angle rad + translation m) below this is
    # reported and not applied
    min_correction: float = 1e-4

    def __post_init__(self):
        """Rejects unknown choices."""
        if self.solver not in ("nicp", "gn_dense"):
            raise ValueError(
                f"solver must be 'nicp' or 'gn_dense', got {self.solver!r}")
        if self.gn.linear_solver not in LINEAR_SOLVERS:
            raise ValueError(f"gn.linear_solver must be one of "
                             f"{LINEAR_SOLVERS}, got "
                             f"{self.gn.linear_solver!r}")
        check_assembly(self.gn)
        if self.lbs_impl not in LBS_IMPLS:
            raise ValueError(f"lbs_impl must be one of {LBS_IMPLS}, got "
                             f"{self.lbs_impl!r}")
        if self.gn.data_term not in DATA_TERMS:
            raise ValueError(f"gn.data_term must be one of {DATA_TERMS}, "
                             f"got {self.gn.data_term!r}")
        if self.flow_mode not in ("fill", "override", "advect"):
            raise ValueError(f"flow_mode must be 'fill', 'override' or "
                             f"'advect', got {self.flow_mode!r}")
        if self.flow_downscale < 1 or self.flow_mask_patch < 0:
            raise ValueError("flow_downscale must be >= 1 and "
                             "flow_mask_patch >= 0")
        if self.flow_lift not in ("dense", "sparse"):
            raise ValueError(f"flow_lift must be 'dense' or 'sparse', got "
                             f"{self.flow_lift!r}")
        if self.lepard_subsample not in ("topk", "strided"):
            raise ValueError(f"lepard_subsample must be 'topk' or "
                             f"'strided', got {self.lepard_subsample!r}")
        if self.lepard_every < 1:
            raise ValueError(
                f"lepard_every must be >= 1, got {self.lepard_every}")


class DynamicFusion:
    def __init__(self, sequence, config: FusionConfig, device=None,
                 flow_net=None, mask_net=None, lepard_net=None,
                 chamfer_table=None):
        """``flow_net``/``mask_net``: PWC-Net and MaskNet
        (``models.checkpoint.load_flow_nets``); ``config.use_flow``
        requires the PWC-Net, and without a MaskNet the flow's weights
        are its validity; ``lepard_net``: the matcher
        (``models.checkpoint.load_lepard_checkpoint``), required by
        ``config.use_lepard`` and used by the feature-seeded recovery;
        ``chamfer_table``: N-ICP's chamfer subsamples [iters + 1, 2, S]
        for every frame (``nicp.solve``; default
        ``nicp.default_chamfer_table``)."""
        self.seq = sequence
        self.config = config
        self.intr = sequence.intrinsics
        self.device = resolve_device(device)
        if config.use_flow and flow_net is None:
            raise ValueError("use_flow requires flow_net")
        if config.use_lepard and lepard_net is None:
            raise ValueError("use_lepard requires lepard_net")
        self.flow_net = flow_net
        self.mask_net = mask_net
        self.lepard_net = lepard_net
        self.chamfer_table = chamfer_table
        self.track_lost = False
        self.frame_id = -1
        self.prev_frame = None
        self.keyframes = []
        self.reloc_feat_matches = -1
        # the chunk graphs of run_fused (fused_register_chunk's cache)
        self.graphs = {}
        # the stepwise loop's (step config, state, tables, motion net),
        # made by the first register_frame after initialize or load_state
        self._stepwise = None
        # the stepwise loop's next solve starts here instead of at its
        # state after a growth (JAX's stepwise warm start; see _grow)
        self._warm = None
        # the motion history load_state read, for the stepwise loop
        self._resume_motion = None
        # bricks the last growth's refresh activated
        self.n_new_bricks = 0
        # run_fused's growth keyframes: frame, new nodes and bricks, host
        # seconds of the growth and of the table rebuild, and the seconds
        # the next chunk took to capture its graphs
        self.growth_log = []

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def initialize(self, frame: Frame):
        """Integrate the first frame, extract the mesh, build the graph,
        skin the model points and the voxels; record the first keyframe
        where keyframes are on."""
        cfg = self.config
        trunc = cfg.trunc_margin_vox * cfg.voxel_size
        self.tsdf_config = T.TSDFConfig(
            vol_dim=tuple(cfg.vol_dim),
            voxel_size=cfg.voxel_size,
            trunc_margin=trunc,
        )
        origin = T.volume_bounds_from_frame(
            frame.depth, self.intr, cfg.vol_dim, cfg.voxel_size
        )
        self.brick_size = cfg.brick_size
        if self.brick_size < 0:
            self.brick_size = 8 if int(np.prod(cfg.vol_dim)) >= 128**3 else 0
        if self.brick_size:
            self.brick_grid = BR.BrickGrid(
                vol_dim=tuple(cfg.vol_dim), voxel_size=cfg.voxel_size,
                brick=self.brick_size, max_bricks=cfg.max_bricks,
            )
            ids = BR.active_bricks_from_depth(
                self.brick_grid, np.asarray(origin), frame.depth, self.intr,
                trunc, dilate=cfg.brick_dilate,
            )
            self.brick_ids = BR.pack_brick_ids(self.brick_grid, ids)
            self.tsdf = BR.create_brick_volume(self.brick_grid, origin,
                                               self.device)
            vox_np, bvalid = BR.brick_voxel_points(
                self.brick_grid, np.asarray(origin), self.brick_ids
            )
            self.vox_points = self._t(vox_np)
            self.brick_valid = self._t(bvalid, torch.bool)
        else:
            self.brick_grid = None
            self.tsdf = T.create_volume(self.tsdf_config, origin, self.device)
            self.vox_points = T.voxel_world_points(
                self.tsdf_config, self.tsdf.origin
            )
            self.brick_valid = torch.ones(
                self.vox_points.shape[0], dtype=torch.bool,
                device=self.device,
            )
        self.tsdf = T.integrate(
            self.tsdf_config, self.tsdf, self.vox_points, self.brick_valid,
            self._t(frame.depth), self._t(frame.color), self.intr,
        )

        verts, faces = self._extract_mesh_host()
        graph = build_graph_from_mesh(verts, faces, cfg.graph)
        self.graph = graph
        n = graph.nodes.shape[0]
        cap = cfg.max_nodes
        assert n <= cap, f"{n} nodes exceed cap {cap}"
        nodes_p = np.zeros((cap, 3), np.float32)
        nodes_p[:n] = graph.nodes
        node_valid = np.zeros(cap, bool)
        node_valid[:n] = True
        edges_p = -np.ones((cap, graph.edges.shape[1]), np.int32)
        edges_p[:n] = graph.edges
        ew_p = np.zeros((cap, graph.edges.shape[1]), np.float32)
        ew_p[:n] = graph.edge_weights
        clusters_p = -np.ones(cap, np.int32)
        clusters_p[:n] = graph.clusters
        self.node_count = n
        self.nodes = self._t(nodes_p)
        self.node_valid = self._t(node_valid, torch.bool)
        self.edges = self._t(edges_p, torch.int32)
        self.edge_weights = self._t(ew_p)
        self.node_clusters = self._t(clusters_p, torch.int32)
        self.warp = W.create_warpfield(self.nodes, self.node_valid)

        self._set_canonical_points(verts)
        self.vox_table = self._skin_vox()
        self.prev_frame = frame
        self.frame_id = frame.index
        self._stepwise = None
        self._warm = None
        self._resume_motion = None
        self.keyframes = []
        if cfg.keyframe_interval:
            self._record_keyframe(frame)

    def _skin_vox(self):
        """The voxel skin table (K1 on the card); free brick slots stay
        out of the warp and the integrate."""
        table = W.skin(self.warp, self.vox_points, self.config.node_coverage)
        return table._replace(valid=table.valid & self.brick_valid)

    def _extract_mesh_host(self):
        if self.brick_grid is not None:
            tsdf_np, w_np = BR.scatter_to_dense(
                self.brick_grid, self.brick_ids, self.tsdf.tsdf.cpu().numpy(),
                self.tsdf.weight.cpu().numpy(),
            )
            tsdf, weight = torch.from_numpy(tsdf_np), torch.from_numpy(w_np)
        else:
            tsdf, weight = self.tsdf.tsdf, self.tsdf.weight
            tsdf_np = tsdf.cpu().numpy()
        mask = T.truncated_region_mask(tsdf, weight).cpu().numpy().astype(
            np.uint8
        )
        verts_vox, faces = native.marching_cubes(tsdf_np, mask, iso=0.0)
        verts = (
            verts_vox * self.tsdf_config.voxel_size
            + self.tsdf.origin.cpu().numpy()[None, :]
        )
        return verts.astype(np.float32), faces

    def _set_canonical_points(self, verts: np.ndarray):
        cap = self.config.max_points
        n = verts.shape[0]
        if n > cap:
            sel = np.random.RandomState(0).choice(n, cap, replace=False)
            verts = verts[sel]
            n = cap
        pts = np.zeros((cap, 3), np.float32)
        pts[:n] = verts
        pvalid = np.zeros(cap, bool)
        pvalid[:n] = True
        self.model_point_count = n
        self.model_points = self._t(pts)
        self.model_valid = self._t(pvalid, torch.bool)
        self.point_table = W.skin(
            self.warp, self.model_points, self.config.node_coverage
        )

    def _chamfer_table(self):
        """N-ICP's chamfer subsample table for the fused step (the
        caller's ``chamfer_table``, else the default one; drawn here,
        outside any capture), None unless the step runs the chamfer
        cost."""
        cfg = self.config
        if cfg.solver != "nicp" or not cfg.nicp.w_chamfer:
            return None
        if self.chamfer_table is not None:
            return torch.as_tensor(self.chamfer_table, dtype=torch.int64,
                                   device=self.device)
        P = self.model_points.shape[0]
        return default_chamfer_table(cfg.nicp, P, P, self.device)

    # ------------------------------------------------------------------
    def build_fused(self, motion_net=None, dense_skin: bool = True):
        """Device-resident tables + state for the fused path. Call after
        ``initialize`` (or ``load_state``). With ``lbs_impl="dense"`` (and
        ``dense_skin``) the tables carry the voxels' dense skin where it
        fits ``dense_skin_max_bytes``; the compact-pair scatter plan stays
        None, as JAX's build_fused leaves it. Returns (step_config,
        state, tables)."""
        cfg = self.config
        cap = cfg.max_nodes
        motion_levels = level_sizes_for(cap)
        use_motion = motion_net is not None and cfg.use_motion_model
        if use_motion:
            pyd = self.graph.pyramid
            dummy = np.zeros((self.node_count, 3), np.float32)
            ints, _ = pack_frame(
                dummy, dummy, np.zeros(self.node_count, bool),
                [pyd[f"nn_index_l{l}"] for l in range(4)],
                [pyd[f"down_sample_idx{i}"] for i in (1, 2, 3)],
                [pyd[f"up_sample_idx{i}"] for i in (1, 2, 3)],
                level_sizes=motion_levels,
            )
        else:
            _, pack_len = _packed_layout(motion_levels)
            ints = np.zeros((pack_len,), np.int32)
        tables = FusionTables(
            vox_points=self.vox_points,
            vox_anchors=self.vox_table.anchors,
            vox_weights=self.vox_table.weights,
            vox_valid=self.vox_table.valid,
            model_points=self.model_points,
            model_valid=self.model_valid,
            point_anchors=self.point_table.anchors,
            point_weights=self.point_table.weights,
            point_valid=self.point_table.valid,
            nodes=self.nodes,
            node_valid=self.node_valid,
            edges=self.edges,
            edge_weights=self.edge_weights,
            pyramid_ints=self._t(ints, torch.int32),
            n_nodes=self._t(self.node_count, torch.int32),
            node_clusters=(self.node_clusters if cfg.min_cluster_matches
                           else None),
            chamfer_table=self._chamfer_table(),
        )
        if dense_skin and cfg.lbs_impl == "dense" and dense_skin_bytes(
                self.vox_points.shape[0], cap) <= cfg.dense_skin_max_bytes:
            skin = precompute_dense_skin(
                self.vox_table.anchors, self.vox_table.weights,
                self.vox_table.valid, cap)
            tables = tables._replace(vox_dense_hi=skin.s_hi,
                                     vox_dense_lo=skin.s_lo)
        # the flow source: the previous frame's RGB-XYZ image (none after
        # load_state, where the stepwise loop's first frame runs no flow)
        prev_rgbxyz = None
        if cfg.use_flow and self.prev_frame is not None:
            prev_rgbxyz = _rgbxyz_image(
                self._t(self.prev_frame.depth), self._t(self.prev_frame.color),
                self.intr,
            )
        state = FusionStepState(
            tsdf=T.TSDFState(*(x.clone() for x in self.tsdf)),
            rotations=self.warp.rotations.clone(),
            translations=self.warp.translations.clone(),
            motion=init_state(cap, self.device),
            prev_rgbxyz=prev_rgbxyz,
        )
        step_config = FusedStepConfig(
            tsdf=self.tsdf_config,
            gn=cfg.gn,
            max_depth_diff=cfg.max_depth_diff,
            use_motion_model=use_motion,
            motion_levels=motion_levels,
            use_flow=cfg.use_flow,
            flow_mask_threshold=cfg.flow_mask_threshold,
            flow_mode=cfg.flow_mode,
            flow_advect_min_px=cfg.flow_advect_min_px,
            flow_advect_weight=cfg.flow_advect_weight,
            flow_advect_mask_threshold=cfg.flow_advect_mask_threshold,
            flow_advect_alpha=cfg.flow_advect_alpha,
            flow_mask_patch=cfg.flow_mask_patch,
            flow_downscale=cfg.flow_downscale,
            flow_lift=cfg.flow_lift,
            flow_bf16=cfg.flow_bf16,
            mask_downscale=cfg.mask_downscale,
            use_lepard=cfg.use_lepard,
            lepard_max_target_points=cfg.lepard_max_target_points,
            lepard_every=cfg.lepard_every,
            lepard_subsample=cfg.lepard_subsample,
            solver=cfg.solver,
            nicp=cfg.nicp,
            min_cluster_matches=cfg.min_cluster_matches,
            lbs_impl=cfg.lbs_impl,
        )
        return step_config, state, tables

    def _perception(self):
        return self.flow_net, self.mask_net, self.lepard_net

    def register_frame_fused(self, step_config, state, tables, frame: Frame,
                             motion_net=None):
        """One eager fused step; the caller owns the state. The Lepard
        gate reads ``frame.index``, so it fires on the same absolute
        frames whatever state or tables the caller passes."""
        if step_config.use_flow and state.prev_rgbxyz is None:
            raise ValueError("the fused step's flow needs the previous "
                             "frame (prev_frame is None after load_state)")
        return fused_register_frame(
            step_config, state, tables, motion_net, self._t(frame.depth),
            self._t(frame.color), self.intr, *self._perception(),
            run_lepard=lepard_gate(step_config, [frame.index])[0],
        )

    def _stepwise_tables(self, motion_net):
        """(step config, state, tables) of the stepwise loop from the
        object's fields: the JAX stepwise loop's flow, the dense lift in
        f32, and the gather warp of the voxels (K2), as the JAX stepwise
        loop warps them whatever ``lbs_impl`` says."""
        sc, state, tables = self.build_fused(motion_net, dense_skin=False)
        sc = sc._replace(flow_lift="dense", flow_bf16=False, mask_downscale=1,
                         lbs_impl="xla")
        return sc, state, tables

    def register_frame(self, frame: Frame, motion_net=None):
        """One stepwise frame: the eager fused step on the object's own
        state, the projective association (and advect's) reading the
        depth with the frame's boundary pixels zeroed, flow (if on) lifted
        densely in f32 with PWC at 1/``flow_downscale`` (none in the first
        frame after ``load_state``, which has no previous frame), Lepard
        (if on) in the frames whose index is a multiple of
        ``lepard_every``; then growth and the keyframe work where their
        intervals divide ``frame.index``. ``motion_net`` is taken at the
        first frame after ``initialize`` or ``load_state``. Sets
        ``track_lost`` below 16 correspondences, ``frame_id`` and
        ``prev_frame``. Returns the frame's info dict."""
        cfg = self.config
        if self._stepwise is None:
            sc, state, tables = self._stepwise_tables(motion_net)
            if self._resume_motion is not None:
                state = state._replace(motion=self._resume_motion)
                self._resume_motion = None
            self._stepwise = (sc, state, tables, motion_net)
        sc, state, tables, net = self._stepwise
        depth = self._t(frame.depth)
        color = self._t(frame.color)
        corr_depth = None
        if frame.boundary is not None:
            corr_depth = torch.where(self._t(frame.boundary, torch.bool),
                                     torch.zeros_like(depth), depth)
        no_source = sc.use_flow and state.prev_rgbxyz is None
        state, info = fused_register_frame(
            sc._replace(use_flow=False) if no_source else sc, state, tables,
            net, depth, color, self.intr, *self._perception(),
            corr_depth=corr_depth,
            run_lepard=lepard_gate(sc, [frame.index])[0], init=self._warm,
        )
        self._warm = None
        if no_source:
            state = state._replace(
                prev_rgbxyz=_rgbxyz_image(depth, color, self.intr))
        self._stepwise = (sc, state, tables, net)
        self.adopt_fused_state(state)
        self.frame_id = frame.index
        self.prev_frame = frame
        (row,) = self._read_infos([frame.index], (info[None].cpu(), None))
        info = {**row, "n_new_nodes": 0}
        if cfg.growth_interval and frame.index % cfg.growth_interval == 0:
            info["n_new_nodes"] = self._grow(frame)
            if info["n_new_nodes"] or self.n_new_bricks:
                _, fresh, tables = self._stepwise_tables(net)
                if info["n_new_nodes"]:
                    # the JAX stepwise loop starts the next solve from the
                    # last solve's transforms: the new nodes at identity
                    self._warm = (state.rotations, state.translations)
                state = fresh._replace(motion=state.motion,
                                       prev_rgbxyz=state.prev_rgbxyz)
                self._stepwise = (sc, state, tables, net)
        if cfg.keyframe_interval and frame.index % cfg.keyframe_interval == 0:
            info.update(self._keyframe(frame))
            self._stepwise = (sc, state._replace(
                rotations=self.warp.rotations.clone(),
                translations=self.warp.translations.clone()), tables, net)
        return info

    def run(self, start: int = 0, end: int | None = None, skip: int = 1,
            motion_net=None):
        """The stepwise loop: frame ``start`` initializes, then each of
        ``range(start + skip, end, skip)`` goes through ``register_frame``.
        Returns a list of per-frame info dicts."""
        end = len(self.seq) if end is None else end
        self.initialize(self.seq.load(start))
        return [self.register_frame(self.seq.load(i), motion_net)
                for i in range(start + skip, end, skip)]

    def run_fused(self, start: int = 0, end: int | None = None,
                  skip: int = 1, chunk: int = 16, motion_net=None,
                  keyframe_cb=None):
        """Drive the sequence through the chunked engine: frame ``start``
        initializes, frames ``range(start + skip, end, skip)`` are
        registered ``chunk`` at a time (one CUDA graph replay per chunk
        on the card, a graph for each chunk length). Frames are staged
        in pinned host buffers and uploaded without blocking; the info of
        a chunk is read back while the next one runs. Between chunks, the
        host work: in a chunk that holds a frame whose index the growth
        interval divides, growth at the chunk's last frame (the tables
        rebuilt where it added nodes or bricks, so the next chunk takes a
        new graph, with the motion history and the flow source carried);
        in one that holds a keyframe index, the keyframe work at its last
        frame (relocalization writes the corrected transforms back into
        the resident state); then ``keyframe_cb(self, last frame)``. Both
        read their chunk's info first. Sets ``track_lost`` when a frame
        has fewer than 16 correspondences, ``frame_id`` and
        ``prev_frame``. Returns a list of per-frame info dicts."""
        cfg = self.config
        end = len(self.seq) if end is None else end
        self.initialize(self.seq.load(start))
        sc, state, tables = self.build_fused(motion_net)
        self.growth_log = []
        ids = list(range(start + skip, end, skip))
        stager = _FrameStager(self.device)
        pending, infos = [], []
        gint, kint = cfg.growth_interval, cfg.keyframe_interval
        for lo in range(0, len(ids), chunk):
            chunk_ids = ids[lo : lo + chunk]
            frames = [self.seq.load(i) for i in chunk_ids]
            depths, colors = stager.upload(frames)
            known = set(self.graphs)
            state, out = fused_register_chunk(
                sc, state, tables, motion_net, depths, colors, self.intr,
                *self._perception(), graphs=self.graphs,
                lepard_on=lepard_gate(sc, chunk_ids),
            )
            if self.growth_log and self.growth_log[-1]["capture_s"] is None:
                self.growth_log[-1]["capture_s"] = sum(
                    g.capture_s for k, g in self.graphs.items()
                    if k not in known)
            pending.append((chunk_ids, stager.download(out)))
            self.frame_id = chunk_ids[-1]
            self.prev_frame = frames[-1]
            grow = bool(gint) and any(i % gint == 0 for i in chunk_ids)
            keyframe = bool(kint) and any(i % kint == 0 for i in chunk_ids)
            if grow or keyframe:
                # this chunk's rows first: track_lost comes from them
                for p in pending:
                    infos += self._read_infos(*p)
                pending = []
            elif len(pending) > 1:
                infos += self._read_infos(*pending.pop(0))
            if grow:
                t0 = time.perf_counter()
                self.adopt_fused_state(state)
                n_new = self._grow(frames[-1])
                infos[-1]["n_new_nodes"] = n_new
                t1 = time.perf_counter()
                rebuilt = bool(n_new or self.n_new_bricks)
                if rebuilt:
                    old = tables
                    sc, fresh, tables = self.build_fused(motion_net)
                    state = fresh._replace(motion=state.motion,
                                           prev_rgbxyz=state.prev_rgbxyz)
                    # the old tables' graphs are dead: free their memory
                    self.graphs = {k: g for k, g in self.graphs.items()
                                   if g.keep[0] is not old}
                self.growth_log.append({
                    "frame": chunk_ids[-1], "n_new_nodes": n_new,
                    "n_new_bricks": self.n_new_bricks,
                    "grow_s": t1 - t0,
                    "rebuild_s": time.perf_counter() - t1,
                    # the next chunk's graph captures (none left to run,
                    # or no rebuild: 0)
                    "capture_s": None if rebuilt and lo + chunk < len(ids)
                    else 0.0,
                })
            if keyframe:
                self.adopt_fused_state(state)
                infos[-1].update(self._keyframe(frames[-1]))
                state = state._replace(
                    rotations=self.warp.rotations.clone(),
                    translations=self.warp.translations.clone(),
                )
            if keyframe_cb is not None:
                keyframe_cb(self, frames[-1])
        for p in pending:
            infos += self._read_infos(*p)
        self.adopt_fused_state(state)
        return infos

    def _read_infos(self, chunk_ids, download):
        """A chunk's info rows, once their copy has landed -> per-frame
        dicts."""
        out, done = download
        if done is not None:
            done.synchronize()
        out_np = out.numpy()
        if (out_np[:, 1] < 16).any():
            self.track_lost = True
        return [{
            "frame": i,
            "final_loss": float(row[0]),
            "n_correspondences": int(row[1]),
            "n_visible_nodes": int(row[2]),
            "mean_confidence": float(row[3]),
            "solve_valid": bool(row[4] > 0.5),
            "n_flow_filled": int(row[5]),
            "n_lepard_matches": int(row[6]),
        } for i, row in zip(chunk_ids, out_np)]

    def adopt_fused_state(self, state: FusionStepState):
        """Copy a fused-path state back into the object-style fields."""
        self.tsdf = state.tsdf
        self.warp = W.update_transforms(
            self.warp, state.rotations, state.translations
        )

    # ------------------------------------------------------------------
    # keyframes: pose graph, loop closures, relocalization

    def _keyframe(self, frame: Frame) -> dict:
        """Record a keyframe at ``frame``, relocalize against it, close
        loops; returns the info fields the JAX package reports."""
        self._record_keyframe(frame)
        correction = self._relocalize(self.keyframes[-1])
        return {"pose_correction": correction,
                "reloc_feat_matches": self.reloc_feat_matches,
                "loop_closures": self._pose_graph_update()}

    def _record_keyframe(self, frame: Frame):
        """Store the model's global rigid pose (Kabsch canonical ->
        deformed over the valid nodes) with the observation: the depth
        image and up to ``max_points`` of its backprojected points, drawn
        with ``RandomState(frame.index)``."""
        w = self.node_valid.to(torch.float32)
        R, t = weighted_kabsch(self.warp.node_positions,
                               self.warp.deformed_nodes, weights=w)
        depth = np.asarray(frame.depth)
        v, u = np.nonzero(depth > 0)
        d = depth[v, u]
        fx, fy = float(self.intr.fx), float(self.intr.fy)
        cx, cy = float(self.intr.cx), float(self.intr.cy)
        obs = np.stack(
            [(u - cx) / fx * d, (v - cy) / fy * d, d], axis=-1
        ).astype(np.float32)
        cap = self.config.max_points
        sel = np.random.RandomState(frame.index).permutation(len(obs))[:cap]
        pts = np.zeros((cap, 3), np.float32)
        pts[: len(sel)] = obs[sel]
        pvalid = np.zeros(cap, bool)
        pvalid[: len(sel)] = True
        self.keyframes.append({
            "frame": frame.index,
            "R": R.cpu().numpy(),
            "t": t.cpu().numpy(),
            "depth": depth,
            "points": pts,
            "pvalid": pvalid,
        })
        if len(self.keyframes) > self.config.max_keyframes:
            self.keyframes = self.keyframes[-self.config.max_keyframes:]

    def _pose_graph_update(self) -> int:
        """Loop closures of the newest keyframe (its observed points
        aligned to earlier keyframes' depth), then the keyframe trajectory
        optimized over the odometry chain and the loops. Returns the
        number of accepted loop closures."""
        cfg = self.config
        k = len(self.keyframes) - 1
        if k < 2:
            return 0
        kf = self.keyframes[k]
        obs_k = self._t(kf["points"])
        obs_k_valid = self._t(kf["pvalid"], torch.bool)
        loops = []
        for i in range(k - max(cfg.loop_min_separation, 2) + 1):
            kf_i = self.keyframes[i]
            if np.linalg.norm(kf_i["t"] - kf["t"]) > cfg.loop_radius:
                continue
            # T_align maps keyframe k's observed surface onto keyframe
            # i's observation: T_i T_k^-1, from the observations alone
            align = rigid_depth_alignment(
                obs_k, obs_k_valid, self._t(kf_i["depth"]), self.intr,
                iters=cfg.loop_align_iters, max_depth_diff=cfg.max_depth_diff,
            )
            if (float(align.inlier_fraction) < cfg.loop_min_inliers
                    or float(align.residual) > cfg.loop_max_residual):
                continue
            loops.append((i, align.rotation.cpu().numpy(),
                          align.translation.cpu().numpy(),
                          float(align.inlier_fraction)))
        if not loops:
            return 0

        K, E = cfg.max_keyframes, 2 * cfg.max_keyframes
        poses_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        poses_t = np.zeros((K, 3), np.float32)
        pose_valid = np.zeros(K, bool)
        for a, f in enumerate(self.keyframes):
            poses_R[a], poses_t[a], pose_valid[a] = f["R"], f["t"], True
        edge_i = np.zeros(E, np.int32)
        edge_j = np.zeros(E, np.int32)
        edge_R = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        edge_t = np.zeros((E, 3), np.float32)
        edge_valid = np.zeros(E, bool)
        edge_w = np.zeros(E, np.float32)
        e = 0
        for a in range(k):  # the odometry backbone: T_a^-1 T_(a+1)
            fa, fb = self.keyframes[a], self.keyframes[a + 1]
            edge_i[e], edge_j[e] = a, a + 1
            edge_R[e] = fa["R"].T @ fb["R"]
            edge_t[e] = fa["R"].T @ (fb["t"] - fa["t"])
            edge_valid[e], edge_w[e] = True, 1.0
            e += 1
        for i, Rm, tm, frac in loops:
            # T_i^-1 T_k = T_i^-1 T_align^-1 T_i, conjugated by the stored
            # estimate of T_i
            Ri, ti = self.keyframes[i]["R"], self.keyframes[i]["t"]
            Rmi, tmi = Rm.T, -Rm.T @ tm
            edge_i[e], edge_j[e] = i, k
            edge_R[e] = Ri.T @ Rmi @ Ri
            edge_t[e] = Ri.T @ (Rmi @ ti + tmi - ti)
            edge_valid[e], edge_w[e] = True, 2.0 * frac
            e += 1
        graph = PoseGraph(
            poses_R=self._t(poses_R), poses_t=self._t(poses_t),
            pose_valid=self._t(pose_valid, torch.bool),
            edge_i=self._t(edge_i, torch.int32),
            edge_j=self._t(edge_j, torch.int32),
            edge_R=self._t(edge_R), edge_t=self._t(edge_t),
            edge_valid=self._t(edge_valid, torch.bool),
            edge_weight=self._t(edge_w),
        )
        opt_R, opt_t, _ = optimize_pose_graph(graph)
        opt_R, opt_t = opt_R.cpu().numpy(), opt_t.cpu().numpy()
        for a in range(len(self.keyframes)):
            self.keyframes[a]["R"] = opt_R[a]
            self.keyframes[a]["t"] = opt_t[a]
        return len(loops)

    def _relocalize(self, kf: dict) -> float:
        """Observation-grounded re-anchoring: align the deformed model to
        the keyframe's observation and left-compose the rigid fix into the
        warp where the model is off the surface and the fix halves the
        residual; after a lost track only with ``relocalize_recovery``
        (wide-baseline search, seeded by the matcher's Kabsch pose where
        ``relocalize_feat_min_points`` > 0 and a matcher is given), which
        then clears ``track_lost``. Returns the correction's magnitude
        (rotation angle + translation norm), 0 where none was found."""
        cfg = self.config
        deformed_pts = W.deform_points(self.warp, self.model_points,
                                       self.point_table)
        pvalid = self.model_valid & self.point_table.valid
        recovering = bool(self.track_lost)
        if recovering and not cfg.relocalize_recovery:
            return 0.0
        if recovering:
            n_obs = int(np.count_nonzero(np.asarray(kf["depth"]) > 0))
            if n_obs < cfg.relocalize_min_obs_px:
                return 0.0
        depth = self._t(kf["depth"])
        feat_init = None
        self.reloc_feat_matches = -1  # -1: the feature seed did not run
        if (recovering and self.lepard_net is not None
                and cfg.relocalize_feat_min_points > 0):
            tgt_pcd, tgt_valid = _deterministic_target_subsample(
                depth, self.intr, cfg.lepard_max_target_points,
                cfg.lepard_subsample)
            flow, fmask, _ = scene_flow(self.lepard_net, deformed_pts, pvalid,
                                        tgt_pcd, tgt_valid)
            n_feat = int(fmask.sum())
            self.reloc_feat_matches = n_feat
            if n_feat >= cfg.relocalize_feat_min_points:
                feat_init = weighted_kabsch(
                    deformed_pts, deformed_pts + flow,
                    weights=fmask.to(torch.float32))
        align = rigid_depth_alignment(
            deformed_pts, pvalid, depth, self.intr,
            iters=cfg.loop_align_iters, max_depth_diff=cfg.max_depth_diff,
            coarse_init=recovering, feat_init=feat_init,
        )
        min_final = (max(cfg.loop_min_inliers, cfg.relocalize_recover_inliers)
                     if recovering else cfg.loop_min_inliers)
        if float(align.inlier_fraction) < min_final:
            return 0.0
        if not recovering and (
                float(align.initial_residual) < cfg.relocalize_threshold
                or float(align.residual)
                >= 0.5 * float(align.initial_residual)):
            return 0.0
        if recovering:
            self.track_lost = False
        dR = align.rotation.cpu().numpy()
        dt = align.translation.cpu().numpy()
        angle = float(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0,
                                        -1.0, 1.0)))
        magnitude = angle + float(np.linalg.norm(dt))
        if magnitude < cfg.min_correction:
            return magnitude
        self.warp = W.left_compose_rigid(self.warp, align.rotation,
                                         align.translation)
        # the next solve starts from the corrected transforms
        self._warm = None
        return magnitude

    def trajectory(self):
        """The optimized keyframe trajectory: (frame ids [K], R [K, 3, 3],
        t [K, 3])."""
        if not self.keyframes:
            return (np.zeros(0, np.int32), np.zeros((0, 3, 3)),
                    np.zeros((0, 3)))
        ids = np.asarray([f["frame"] for f in self.keyframes], np.int32)
        R = np.stack([f["R"] for f in self.keyframes])
        t = np.stack([f["t"] for f in self.keyframes])
        return ids, R, t

    # ------------------------------------------------------------------
    # graph growth and the bricked volume's refresh

    def _refresh_bricks(self, frame: Frame) -> int:
        """The bricked volume's active-set refresh: keep every active
        brick and activate the canonical bricks whose warped centres land
        in the truncation band of the current observation (K1 skins the
        centres), carrying the data into the new slot layout with one
        device gather and re-skinning the voxel slots (K1). Returns the
        number of newly activated bricks."""
        cfg = self.config
        grid = self.brick_grid
        origin = self.tsdf.origin.cpu().numpy()
        trunc = self.tsdf_config.trunc_margin
        obs_pts = BR._backproject_valid(frame.depth, self.intr)
        occ_ids = BR.active_bricks_from_points(grid, origin, obs_pts, trunc,
                                               dilate=cfg.brick_dilate)
        occ = np.zeros(int(np.prod(grid.grid_dim)), bool)
        occ[occ_ids] = True
        # canonical brick centres warped to the current frame (centres out
        # of node coverage pass through unwarped)
        GX, GY, GZ = grid.grid_dim
        bs = grid.brick * grid.voxel_size
        cx, cy, cz = np.meshgrid(np.arange(GX), np.arange(GY), np.arange(GZ),
                                 indexing="ij")
        centers = ((np.stack([cx, cy, cz], -1).reshape(-1, 3) + 0.5) * bs
                   + origin)
        centers_t = self._t(centers.astype(np.float32))
        ctable = W.skin(self.warp, centers_t, cfg.node_coverage)
        warped = W.deform_points(self.warp, centers_t, ctable).cpu().numpy()
        q = np.floor((warped - origin) / bs).astype(np.int64)
        inb = ((q >= 0).all(1) & (q[:, 0] < GX) & (q[:, 1] < GY)
               & (q[:, 2] < GZ))
        lin = q[:, 0] * GY * GZ + q[:, 1] * GZ + q[:, 2]
        wanted = np.zeros(len(centers), bool)
        wanted[inb] = occ[lin[inb]]
        old = np.asarray(self.brick_ids)
        keep = old[old >= 0]
        new_ids = np.union1d(keep, np.flatnonzero(wanted).astype(np.int32))
        if len(new_ids) > grid.max_bricks:
            # existing bricks win; the newly wanted ones are dropped from
            # the far end
            extra = np.setdiff1d(new_ids, keep)
            new_ids = np.union1d(keep, extra[:grid.max_bricks - len(keep)])
        n_new = len(new_ids) - len(keep)
        if n_new == 0:
            return 0
        packed = BR.pack_brick_ids(grid, new_ids)
        self.tsdf = BR.apply_remap(self.tsdf, BR.remap_slots(old, packed))
        self.brick_ids = packed
        vox_np, bvalid = BR.brick_voxel_points(grid, origin, packed)
        self.vox_points = self._t(vox_np)
        self.brick_valid = self._t(bvalid, torch.bool)
        self.vox_table = self._skin_vox()
        return n_new

    def _grow(self, frame: Frame) -> int:
        """Extend the graph onto canonical surface no node covers
        (``fusion/graph_growth.py``): refresh the bricks first (bricked
        volume; ``n_new_bricks``), draw up to 20,000 vertices of the
        canonical mesh with ``RandomState(frame.index)``, grow; where nodes
        were added, new nodes join their nearest old node's component,
        the voxel slots and the model points are re-skinned (K1) and the
        motion pyramid is rebuilt over the grown node set. Returns the
        number of new nodes."""
        cfg = self.config
        self.n_new_bricks = 0
        if self.brick_grid is not None:
            self.n_new_bricks = self._refresh_bricks(frame)
        verts, _ = self._extract_mesh_host()
        sel = np.random.RandomState(frame.index).permutation(len(verts))[
            :20000]
        res = grow_graph(self.warp, self.node_count, self.edges,
                         self.edge_weights, verts[sel],
                         np.ones(len(sel), bool), cfg.node_coverage)
        if res.n_new:
            old_count = self.node_count
            self.warp = res.warp
            self.node_count = res.node_count
            self.edges = res.edges
            self.edge_weights = res.edge_weights
            self.nodes = res.warp.node_positions
            self.node_valid = res.warp.node_valid
            clusters = self.node_clusters.cpu().numpy().copy()
            nodes_np = self.nodes.cpu().numpy()
            new_ids = np.arange(old_count, self.node_count)
            d = np.linalg.norm(
                nodes_np[new_ids, None] - nodes_np[None, :old_count], axis=-1)
            clusters[new_ids] = clusters[np.argmin(d, axis=1)]
            self.node_clusters = self._t(clusters, torch.int32)
            self.vox_table = self._skin_vox()
            self.point_table = W.skin(self.warp, self.model_points,
                                      cfg.node_coverage)
            self._rebuild_pyramid()
        return res.n_new

    def _rebuild_pyramid(self):
        """The motion GNN's pyramid over the live node set (euclidean
        coarse levels; ``edgraph.build_pyramid_from_nodes``)."""
        n = self.node_count
        pyramid = build_pyramid_from_nodes(
            self.nodes[:n].cpu().numpy(), self.config.graph.node_coverage,
            edges=self.edges[:n].cpu().numpy())
        if self.graph is None:
            self.graph = SimpleNamespace()
        self.graph.pyramid = pyramid

    # ------------------------------------------------------------------
    # snapshots

    def save_state(self, path: str):
        """Save the resumable state as one flat npz in the JAX package's
        layout (``utils/snapshot.py``): the canonical volume (with the
        brick table), the graph, the warp's transforms, the model points,
        the frame id and, after the stepwise loop with a motion net, the
        motion history it carries, and a growth's pending warm start
        (ROADMAP F11). The chunked engine's history is not saved: the JAX
        package's fused engine never advances the history it saves
        (ROADMAP F10), and a fused resume starts afresh in both."""
        cfg = self.config
        tree = {
            "tsdf": dict(self.tsdf._asdict()),
            "rotations": self.warp.rotations,
            "translations": self.warp.translations,
            "nodes": self.nodes,
            "node_valid": self.node_valid,
            "edges": self.edges,
            "edge_weights": self.edge_weights,
            "node_clusters": self.node_clusters,
            "node_count": np.asarray(self.node_count, np.int32),
            "model_points": self.model_points,
            "model_valid": self.model_valid,
            "frame_id": np.asarray(self.frame_id, np.int32),
            "vol_dim": np.asarray(cfg.vol_dim, np.int32),
            "voxel_size": np.asarray(cfg.voxel_size, np.float32),
        }
        if self.brick_grid is not None:
            tree["brick_ids"] = np.asarray(self.brick_ids)
        motion = self._resume_motion
        stepwise_net = self._stepwise[3] if self._stepwise else None
        if stepwise_net is not None and cfg.use_motion_model:
            motion = self._stepwise[1].motion
        if motion is not None:
            tree["motion_state"] = dict(motion._asdict())
        if self._warm is not None:
            # a growth's pending warm start (F11), so that the resumed
            # loop's next solve starts where the uninterrupted one's does;
            # the JAX package's loader ignores these keys
            tree["warm_rotations"], tree["warm_translations"] = self._warm
        save_pytree(path, tree)

    def load_state(self, path: str):
        """Resume from a ``save_state`` snapshot (of either package):
        rebuild the device state and every derived table (the voxel
        points, both skin tables by K1, the motion pyramid) under the
        current config, whose volume geometry must match the snapshot's.
        The stepwise loop resumes with the saved motion history (a fresh
        one where none was saved); ``build_fused`` starts afresh. The
        keyframes start empty; ``prev_frame`` is kept."""
        cfg = self.config
        tree = load_params(path)
        assert tuple(int(x) for x in tree["vol_dim"]) == tuple(
            cfg.vol_dim), "snapshot volume dims do not match the config"
        trunc = cfg.trunc_margin_vox * cfg.voxel_size
        self.tsdf_config = T.TSDFConfig(vol_dim=tuple(cfg.vol_dim),
                                        voxel_size=cfg.voxel_size,
                                        trunc_margin=trunc)
        td = tree["tsdf"]
        self.tsdf = T.TSDFState(tsdf=self._t(td["tsdf"]),
                                weight=self._t(td["weight"]),
                                color=self._t(td["color"]),
                                origin=self._t(td["origin"]))
        if "brick_ids" in tree:
            assert cfg.brick_size != 0, (
                "snapshot is bricked but config.brick_size == 0")
            # the brick edge is the stored [MB, B, B, B] volume's
            self.brick_size = int(td["tsdf"].shape[1])
            self.brick_grid = BR.BrickGrid(
                vol_dim=tuple(cfg.vol_dim), voxel_size=cfg.voxel_size,
                brick=self.brick_size, max_bricks=cfg.max_bricks)
            self.brick_ids = np.asarray(tree["brick_ids"], np.int32)
            vox_np, bvalid = BR.brick_voxel_points(
                self.brick_grid, np.asarray(td["origin"]), self.brick_ids)
            self.vox_points = self._t(vox_np)
            self.brick_valid = self._t(bvalid, torch.bool)
        else:
            self.brick_size = 0
            self.brick_grid = None
            self.vox_points = T.voxel_world_points(self.tsdf_config,
                                                   self.tsdf.origin)
            self.brick_valid = torch.ones(self.vox_points.shape[0],
                                          dtype=torch.bool,
                                          device=self.device)
        self.nodes = self._t(tree["nodes"])
        self.node_valid = self._t(tree["node_valid"], torch.bool)
        self.edges = self._t(tree["edges"], torch.int32)
        self.edge_weights = self._t(tree["edge_weights"])
        if "node_clusters" in tree:
            self.node_clusters = self._t(tree["node_clusters"], torch.int32)
        else:  # a snapshot without clusters: one component
            self.node_clusters = self._t(
                np.where(tree["node_valid"], 0, -1), torch.int32)
        self.node_count = int(tree["node_count"])
        self.warp = W.WarpFieldState(
            node_positions=self.nodes, node_valid=self.node_valid,
            rotations=self._t(tree["rotations"]),
            translations=self._t(tree["translations"]))
        self.model_points = self._t(tree["model_points"])
        self.model_valid = self._t(tree["model_valid"], torch.bool)
        self.model_point_count = int(tree["model_valid"].sum())
        self.point_table = W.skin(self.warp, self.model_points,
                                  cfg.node_coverage)
        self.vox_table = self._skin_vox()
        self.frame_id = int(tree["frame_id"])
        self.graph = None
        self._rebuild_pyramid()
        self._resume_motion = None
        if "motion_state" in tree:
            self._resume_motion = MotionRunnerState(**{
                k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in tree["motion_state"].items()})
        self._stepwise = None
        self._warm = None
        if "warm_rotations" in tree:
            self._warm = (self._t(tree["warm_rotations"]),
                          self._t(tree["warm_translations"]))
        self.graphs = {}
        self.keyframes = []

    def get_deformed_mesh(self):
        """Marching cubes on the canonical TSDF, the vertices skinned at
        ``node_coverage`` (K1 on the card) and warped to the current
        frame. Returns (verts [V, 3] numpy, faces [F, 3] numpy)."""
        verts, faces = self._extract_mesh_host()
        v = self._t(verts)
        table = W.skin(self.warp, v, self.config.node_coverage)
        return W.deform_points(self.warp, v, table).cpu().numpy(), faces


class _FrameStager:
    """Depth and colour chunks through two pinned host buffers, uploaded
    with ``non_blocking=True``. A buffer is refilled only after the event
    recorded behind its last upload has passed, so a copy in flight is
    never overwritten. Info rows come back the same way, into pinned
    memory with an event (``download``). On the CPU: plain tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs, self.events, self.turn = None, [None, None], 0

    def upload(self, frames):
        depth = np.stack([f.depth for f in frames]).astype(np.float32)
        color = np.stack([f.color for f in frames]).astype(np.float32)
        if self.device.type != "cuda":
            return torch.from_numpy(depth), torch.from_numpy(color)
        n = len(frames)
        if self.bufs is None or self.bufs[0][0].shape[0] < n:
            self.bufs = [tuple(torch.empty(a.shape, dtype=torch.float32,
                                           pin_memory=True)
                               for a in (depth, color)) for _ in range(2)]
        b = self.turn
        self.turn = 1 - b
        if self.events[b] is not None:
            self.events[b].synchronize()
        out = []
        for pinned, a in zip(self.bufs[b], (depth, color)):
            pinned[:n].numpy()[...] = a
            out.append(pinned[:n].to(self.device, non_blocking=True))
        self.events[b] = torch.cuda.Event()
        self.events[b].record()
        return tuple(out)

    def download(self, x):
        """(host copy of ``x``, event to wait on before reading it, or
        None on the CPU)."""
        if self.device.type != "cuda":
            return x, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
