"""DynamicFusion orchestrator, fused path (port of
``occlusionfusion_tpu/fusion/pipeline.py``).

``initialize`` integrates the first frame into a dense or bricked
volume, extracts the mesh and builds the deformation graph on the host,
and skins the model points and every voxel (kernel K1 on CUDA).
``build_fused`` packs the device-resident tables and state;
``register_frame_fused`` runs one fused step; ``run_fused`` drives a
whole sequence, reading the per-frame info back once at its end.

Ported: the dense and the bricked volume with ``solver="gn_dense"``,
projective correspondences, the motion GNN, and PWC flow with MaskNet
weights in the JAX defaults' mode (fill, dense lift, full resolution).
Graph growth (and with it brick refresh), keyframes, the stepwise N-ICP
loop, Lepard and the other flow modes raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
    _rgbxyz_image,
    fused_register_frame,
)
from occlusionfusion_tpu_torch.fusion.frame_loader import Frame
from occlusionfusion_tpu_torch.fusion.motion_runner import (
    _packed_layout,
    init_state,
    level_sizes_for,
    pack_frame,
)
from occlusionfusion_tpu_torch.graph import native
from occlusionfusion_tpu_torch.graph.edgraph import (
    GraphConfig,
    build_graph_from_mesh,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

# settings of the JAX FusionConfig that must stay off: not ported
UNPORTED = ("growth_interval", "keyframe_interval", "use_lepard",
            "min_cluster_matches")


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
    # the weights the JAX package derives for solver="gn_dense" when its
    # gn is None (fusion/fused_step.py:556-561): iters 6, w_point =
    # nicp.w_ldmk, w_arap = nicp.w_arap, w_motion = nicp.w_motion / 100
    # at the NICPConfig defaults
    gn: GNConfig = field(default_factory=lambda: GNConfig(
        iters=6, w_point=1.0, w_arap=10.0, w_motion=1.0))
    use_motion_model: bool = True
    solver: str = "gn_dense"
    # 0 = dense grid; > 0 = brick edge in voxels; -1 (the JAX default) =
    # auto: bricks of 8 at >= 128^3 virtual voxels, dense below. Bricks
    # near the first frame's surface (bricks.active_bricks_from_depth)
    # are allocated in max_bricks static slots.
    brick_size: int = -1
    max_bricks: int = 2048
    # PWC flow + MaskNet correspondences (flow_net and mask_net given to
    # DynamicFusion) fill points without a projective target: the JAX
    # defaults (flow_mode "fill", dense lift, full resolution, f32)
    use_flow: bool = False
    growth_interval: int = 0
    keyframe_interval: int = 0
    use_lepard: bool = False
    min_cluster_matches: float = 0.0

    def __post_init__(self):
        """The one place that rejects the settings this port lacks."""
        if self.solver != "gn_dense":
            raise NotImplementedError(
                f"solver={self.solver!r} is not ported (gn_dense only)"
            )
        for name in UNPORTED:
            if getattr(self, name):
                raise NotImplementedError(f"{name}={getattr(self, name)!r} "
                                          "is not ported")


class DynamicFusion:
    def __init__(self, sequence, config: FusionConfig, device=None,
                 flow_net=None, mask_net=None):
        """``flow_net``/``mask_net``: PWC-Net and MaskNet
        (``models.checkpoint.load_flow_nets``), required by
        ``config.use_flow``."""
        self.seq = sequence
        self.config = config
        self.intr = sequence.intrinsics
        self.device = resolve_device(device)
        if config.use_flow and (flow_net is None or mask_net is None):
            raise ValueError("use_flow requires flow_net and mask_net")
        self.flow_net = flow_net
        self.mask_net = mask_net

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def initialize(self, frame: Frame):
        """Integrate the first frame, extract the mesh, build the graph,
        skin the model points and the voxels."""
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
                trunc,
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
        self.node_count = n
        self.nodes = self._t(nodes_p)
        self.node_valid = self._t(node_valid, torch.bool)
        self.edges = self._t(edges_p, torch.int32)
        self.edge_weights = self._t(ew_p)
        self.warp = W.create_warpfield(self.nodes, self.node_valid)

        self._set_canonical_points(verts)
        table = W.skin(self.warp, self.vox_points, cfg.node_coverage)
        # free brick slots stay out of the warp and the integrate
        self.vox_table = table._replace(valid=table.valid & self.brick_valid)
        self.prev_frame = frame

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

    # ------------------------------------------------------------------
    def build_fused(self, motion_net=None):
        """Device-resident tables + state for the fused path. Call after
        ``initialize``. Returns (step_config, state, tables)."""
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
        )
        prev_rgbxyz = None
        if cfg.use_flow:
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
        )
        return step_config, state, tables

    def register_frame_fused(self, step_config, state, tables, frame: Frame,
                             motion_net=None):
        """One fused step; the caller owns the state."""
        return fused_register_frame(
            step_config, state, tables, motion_net, self._t(frame.depth),
            self._t(frame.color), self.intr, self.flow_net, self.mask_net,
        )

    def run_fused(self, motion_net=None):
        """Drive the whole sequence through the fused step: frame 0
        initializes, frames 1.. are registered. The per-frame info is read
        back once, after the last frame. Returns a list of per-frame info
        dicts."""
        self.initialize(self.seq.load(0))
        sc, state, tables = self.build_fused(motion_net)
        outs = []
        with torch.no_grad():
            for i in range(1, len(self.seq)):
                state, info = self.register_frame_fused(
                    sc, state, tables, self.seq.load(i), motion_net
                )
                outs.append(info)
        out_np = torch.stack(outs).cpu().numpy()
        infos = [{
            "frame": i,
            "final_loss": float(row[0]),
            "n_correspondences": int(row[1]),
            "n_visible_nodes": int(row[2]),
            "mean_confidence": float(row[3]),
            "solve_valid": bool(row[4] > 0.5),
            "n_flow_filled": int(row[5]),
        } for i, row in enumerate(out_np, start=1)]
        self.adopt_fused_state(state)
        return infos

    def adopt_fused_state(self, state: FusionStepState):
        """Copy a fused-path state back into the object-style fields."""
        self.tsdf = state.tsdf
        self.warp = W.update_transforms(
            self.warp, state.rotations, state.translations
        )
