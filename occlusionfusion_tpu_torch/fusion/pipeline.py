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
which takes the dense lift), and the Lepard matcher (topk or strided
target subsample) every ``lepard_every``-th absolute frame in both
engines. Graph growth (and with it brick refresh), keyframes and
relocalization, cluster freezing and the chamfer, silhouette and depth
costs of N-ICP raise ``NotImplementedError`` (``UNPORTED``,
``nicp.check_config``).
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
    fused_register_chunk,
    fused_register_frame,
    lepard_gate,
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
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig, check_config

# settings of the JAX FusionConfig that are not ported, each with the
# one value the port takes (the JAX default)
UNPORTED = {
    "growth_interval": 0,
    "keyframe_interval": 0,
    "min_cluster_matches": 0.0,
}


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
    # 0 = dense grid; > 0 = brick edge in voxels; -1 (the JAX default) =
    # auto: bricks of 8 at >= 128^3 virtual voxels, dense below. Bricks
    # near the first frame's surface (bricks.active_bricks_from_depth)
    # are allocated in max_bricks static slots.
    brick_size: int = -1
    max_bricks: int = 2048
    # PWC flow correspondences (flow_net given to DynamicFusion), with
    # MaskNet weights where a mask_net is given (a flow target then needs
    # a sampled weight above 0.35, the JAX default flow_mask_threshold)
    # and weight 1 where the flow is valid without one
    use_flow: bool = False
    # how flow combines with projective association: "fill" (flow only
    # for points without a projective target), "override" (flow wherever
    # its gate passes, the reference's behaviour) or "advect" (each
    # projection advected by the flow, the target the along-ray depth
    # association at the advected pixel; the lifted target rescues points
    # where that fails and no projective target exists)
    flow_mode: str = "fill"
    # advect only: the least flow (px) that advects (0 = any); the
    # solver weight of an advected target (x its MaskNet weight); the
    # MaskNet threshold of an advected target (None = 0.35, a fill's);
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
    # sparse lift only: PWC + MaskNet in bfloat16; MaskNet at 1/N
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
    # not ported: each must keep its value in UNPORTED
    growth_interval: int = 0
    keyframe_interval: int = 0
    min_cluster_matches: float = 0.0

    def __post_init__(self):
        """The one place that rejects the settings this port lacks."""
        if self.solver not in ("nicp", "gn_dense"):
            raise ValueError(
                f"solver must be 'nicp' or 'gn_dense', got {self.solver!r}")
        check_config(self.nicp)
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
        if self.flow_lift == "dense" and (self.flow_bf16
                                          or self.mask_downscale != 1):
            raise ValueError("flow_bf16 and mask_downscale take "
                             "flow_lift='sparse'")
        for name, value in UNPORTED.items():
            if getattr(self, name) != value:
                raise NotImplementedError(f"{name}={getattr(self, name)!r} "
                                          "is not ported")


class DynamicFusion:
    def __init__(self, sequence, config: FusionConfig, device=None,
                 flow_net=None, mask_net=None, lepard_net=None):
        """``flow_net``/``mask_net``: PWC-Net and MaskNet
        (``models.checkpoint.load_flow_nets``); ``config.use_flow``
        requires the PWC-Net, and without a MaskNet the flow's weights
        are its validity; ``lepard_net``: the matcher
        (``models.checkpoint.load_lepard_checkpoint``), required by
        ``config.use_lepard``."""
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
        self.track_lost = False
        self.frame_id = -1
        # the chunk graphs of run_fused (fused_register_chunk's cache)
        self.graphs = {}
        # the stepwise loop's (step config, state, tables), made by the
        # first register_frame after initialize
        self._stepwise = None

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
        self.frame_id = frame.index
        self._stepwise = None

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
        )
        return step_config, state, tables

    def _perception(self):
        return self.flow_net, self.mask_net, self.lepard_net

    def register_frame_fused(self, step_config, state, tables, frame: Frame,
                             motion_net=None):
        """One eager fused step; the caller owns the state. The Lepard
        gate reads ``frame.index``, so it fires on the same absolute
        frames whatever state or tables the caller passes."""
        return fused_register_frame(
            step_config, state, tables, motion_net, self._t(frame.depth),
            self._t(frame.color), self.intr, *self._perception(),
            run_lepard=lepard_gate(step_config, [frame.index])[0],
        )

    def register_frame(self, frame: Frame, motion_net=None):
        """One stepwise frame: the eager fused step on the object's own
        state, the projective association (and advect's) reading the
        depth with the frame's boundary pixels zeroed, flow (if on) lifted
        densely in f32 with PWC at 1/``flow_downscale``, Lepard (if on) in
        the frames whose index is a multiple of ``lepard_every``.
        ``motion_net`` is taken at the first frame after ``initialize``.
        Sets ``track_lost`` below 16 correspondences, ``frame_id`` and
        ``prev_frame``. Returns the frame's info dict."""
        if self._stepwise is None:
            sc, state, tables = self.build_fused(motion_net)
            # the JAX stepwise loop's flow: the dense lift in f32
            sc = sc._replace(flow_lift="dense", flow_bf16=False,
                             mask_downscale=1)
            self._stepwise = (sc, state, tables, motion_net)
        sc, state, tables, net = self._stepwise
        depth = self._t(frame.depth)
        corr_depth = None
        if frame.boundary is not None:
            corr_depth = torch.where(self._t(frame.boundary, torch.bool),
                                     torch.zeros_like(depth), depth)
        state, info = fused_register_frame(
            sc, state, tables, net, depth, self._t(frame.color), self.intr,
            *self._perception(), corr_depth=corr_depth,
            run_lepard=lepard_gate(sc, [frame.index])[0],
        )
        self._stepwise = (sc, state, tables, net)
        self.adopt_fused_state(state)
        self.frame_id = frame.index
        self.prev_frame = frame
        (row,) = self._read_infos([frame.index], (info[None].cpu(), None))
        return {**row, "n_new_nodes": 0}

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
                  skip: int = 1, chunk: int = 16, motion_net=None):
        """Drive the sequence through the chunked engine: frame ``start``
        initializes, frames ``range(start + skip, end, skip)`` are
        registered ``chunk`` at a time (one CUDA graph replay per chunk
        on the card, a graph for each chunk length). Frames are staged
        in pinned host buffers and uploaded without blocking; the info of
        a chunk is read back while the next one runs. Sets ``track_lost``
        when a frame has fewer than 16 correspondences, ``frame_id`` and
        ``prev_frame``. Returns a list of per-frame info dicts."""
        end = len(self.seq) if end is None else end
        self.initialize(self.seq.load(start))
        sc, state, tables = self.build_fused(motion_net)
        ids = list(range(start + skip, end, skip))
        stager = _FrameStager(self.device)
        pending, infos = [], []
        for lo in range(0, len(ids), chunk):
            chunk_ids = ids[lo : lo + chunk]
            frames = [self.seq.load(i) for i in chunk_ids]
            depths, colors = stager.upload(frames)
            state, out = fused_register_chunk(
                sc, state, tables, motion_net, depths, colors, self.intr,
                *self._perception(), graphs=self.graphs,
                lepard_on=lepard_gate(sc, chunk_ids),
            )
            pending.append((chunk_ids, stager.download(out)))
            if len(pending) > 1:
                infos += self._read_infos(*pending.pop(0))
            self.frame_id = chunk_ids[-1]
            self.prev_frame = frames[-1]
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
