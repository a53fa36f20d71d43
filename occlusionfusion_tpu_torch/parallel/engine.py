"""The fused per-frame engine with its voxel and point tables and its
volume sharded over the ranks of a mesh axis: the counterpart of what
GSPMD makes of ``fused_register_chunk`` in ``__graft_entry__.py``'s dry
run (phases 6-7), where the JAX package puts the voxel rows, the model
points with their skin and the TSDF volume on ``P("data")`` and leaves
every node- and image-sized array replicated.

Each rank holds its block of rows (``shard_tables``, ``shard_state``:
the voxel rows of the x-major dense volume are its x-slab, those of the
bricked volume its block of slots) and runs ``fused_register_frame``'s
stages on them, with ``RankShard`` where the work crosses ranks:

* the node motion observations and the cluster filter: their per-node
  sums are summed over the ranks (one ``all_reduce`` each);
* Lepard: the deformed points and their validity are gathered once per
  frame it runs; the matcher runs replicated on the whole cloud and each
  rank keeps its rows of the flow and the mask;
* flow: PWC + MaskNet run replicated on the replicated images; the lift
  and the gates are per point, so each rank lifts its own points;
* the solve: ``gn_dense`` through ``_solve_dense_shard`` (the loop of
  ``solve_dense_distributed`` with the step's own GN config) on the
  rank's point shard (K3' on it, K4' on the rescaled graph, one
  ``all_reduce`` of [M | b | sq] per GN iteration); N-ICP gathers the
  per-point tables, targets and weights once per frame and solves
  replicated, which is the single-rank solve with every sum in its
  order;
* the integrate: K2 (or the dense-skin products on the rank's rows of
  the skin) warps the rank's voxel rows, and the rank integrates its
  slab or its slots;
* the info counts are summed over the ranks.

The engine runs eagerly. Capturing the sharded step in a CUDA graph
needs collectives inside the capture, which NCCL gives with one card per
rank; several ranks on one card run gloo, whose collectives stage
through the host and cannot be captured.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from occlusionfusion_tpu_torch.fusion.fused_step import (
    FusedStepConfig,
    FusionStepState,
    FusionTables,
    fused_register_frame,
)
from occlusionfusion_tpu_torch.parallel.distributed_gn import (
    _solve_dense_shard,
)
from occlusionfusion_tpu_torch.parallel.mesh import (
    all_gather_rows,
    gather_blocks,
    shard_rows,
)

# the tables' fields that __graft_entry__.py shards over "data" (the
# dense skin's halves too: they are voxel rows)
ROW_FIELDS = ("vox_points", "vox_anchors", "vox_weights", "vox_valid",
              "model_points", "model_valid", "point_anchors",
              "point_weights", "point_valid", "vox_dense_hi",
              "vox_dense_lo")
VOLUME_FIELDS = ("tsdf", "weight", "color")


class RankShard:
    """What one rank's ``fused_register_frame(shard=)`` needs to cross
    ranks on a mesh axis: its process ``group``, ``gather`` (every rank's
    rows of several tensors, one all_gather), ``rows`` (this rank's rows
    of a whole array), ``sum`` (an in-place all_reduce) and
    ``solve_dense`` (the distributed dense solve on the rank's shard)."""

    def __init__(self, mesh, axis: str = "data"):
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)

    def gather(self, *tensors):
        return all_gather_rows(self.mesh, tensors, self.axis)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return shard_rows(self.mesh, x, self.axis)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.group)
        return x

    def solve_dense(self, problem, config, init_rotations,
                    init_translations):
        return _solve_dense_shard(self.mesh, problem, config, self.axis,
                                  init_rotations, init_translations)


def shard_tables(mesh, tables: FusionTables,
                 axis: str = "data") -> FusionTables:
    """This rank's tables: its block of the voxel rows, of the model
    points and of their skin (``ROW_FIELDS``); everything node-sized
    stays whole. The compact-pair scatter plan indexes the whole point
    table's rows and is dropped: it orders only the CPU twins' sum, so
    the system is the same without it. Rows that do not divide by the
    axis size raise ``ValueError``."""
    return tables._replace(gn_scatter_plan=None, **{
        f: shard_rows(mesh, getattr(tables, f), axis)
        for f in ROW_FIELDS if getattr(tables, f) is not None})


def shard_state(mesh, state: FusionStepState,
                axis: str = "data") -> FusionStepState:
    """This rank's state: its block of the volume's leading axis (the
    dense volume's x-slab, the bricked volume's slots), copied; the node
    transforms, the motion runner's state and the flow source stay
    whole."""
    tsdf = state.tsdf._replace(**{
        f: shard_rows(mesh, getattr(state.tsdf, f), axis).clone()
        for f in VOLUME_FIELDS})
    return state._replace(tsdf=tsdf)


def gather_state(mesh, state: FusionStepState, tables: FusionTables,
                 axis: str = "data"):
    """(state, tables) whole on every rank, from every rank's shards (the
    inverse of ``shard_state`` and ``shard_tables``): what
    ``DynamicFusion.adopt_fused_state`` and ``get_deformed_mesh`` take
    (marching cubes reads the whole volume on the host anyway)."""
    tsdf = state.tsdf._replace(**{
        f: gather_blocks(mesh, getattr(state.tsdf, f), axis)
        for f in VOLUME_FIELDS})
    whole = tables._replace(**{
        f: gather_blocks(mesh, getattr(tables, f), axis)
        for f in ROW_FIELDS if getattr(tables, f) is not None})
    return state._replace(tsdf=tsdf), whole


@torch.no_grad()
def fused_register_frame_sharded(mesh, config: FusedStepConfig,
                                 state: FusionStepState,
                                 tables: FusionTables, motion_net, depth,
                                 color, intr, flow_net=None, mask_net=None,
                                 lepard_net=None, run_lepard: bool = True,
                                 axis: str = "data"):
    """One frame of this rank's shard (``shard_tables``/``shard_state``
    made it): ``fused_register_frame`` with the rank's ``RankShard``.
    Returns (state, info [7]); the info is the whole run's on every
    rank."""
    return fused_register_frame(
        config, state, tables, motion_net, depth, color, intr, flow_net,
        mask_net, lepard_net, run_lepard=run_lepard,
        shard=RankShard(mesh, axis))


@torch.no_grad()
def fused_register_chunk_sharded(mesh, config: FusedStepConfig,
                                 state: FusionStepState,
                                 tables: FusionTables, motion_net,
                                 depths: torch.Tensor, colors: torch.Tensor,
                                 intr, flow_net=None, mask_net=None,
                                 lepard_net=None, *, lepard_on=None,
                                 axis: str = "data"):
    """F frames in order through the sharded step, eagerly (no CUDA
    graph: see the module's note) -> (state, infos [F, 7]).
    ``lepard_on`` as ``fused_register_chunk`` (None: every frame where
    ``config.use_lepard``)."""
    n = depths.shape[0]
    if lepard_on is None:
        lepard_on = (bool(config.use_lepard),) * n
    if len(lepard_on) != n:
        raise ValueError(f"{len(lepard_on)} gate entries for {n} frames")
    infos = []
    for j in range(n):
        state, info = fused_register_frame_sharded(
            mesh, config, state, tables, motion_net, depths[j], colors[j],
            intr, flow_net, mask_net, lepard_net,
            run_lepard=bool(lepard_on[j]) and config.use_lepard, axis=axis)
        infos.append(info)
    return state, torch.stack(infos)

