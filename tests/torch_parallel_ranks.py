"""Rank functions of tests/test_torch_parallel.py. The launcher's spawned
ranks import this module to find them, so it imports torch and the port
only (no JAX: each rank would pay for its import)."""

import numpy as np
import torch


def _problem(arrays):
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNProblem

    return GNProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def every_case(rank, world_size, gn_arrays, motion_arrays, lstm_state,
               history, volume):
    """Each distributed function of the port on this world, on the numpy
    inputs of the JAX references; the sharded outputs gathered."""
    from occlusionfusion_tpu_torch.fusion import tsdf as T
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
    from occlusionfusion_tpu_torch.parallel.distributed_gn import (
        solve_dense_distributed,
        solve_distributed,
    )
    from occlusionfusion_tpu_torch.parallel.mesh import (
        gather_blocks,
        make_fusion_mesh,
        shard_rows,
    )
    from occlusionfusion_tpu_torch.parallel.sequence import (
        integrate_slab,
        lstm_node_sharded,
        lstm_time_ring,
    )
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

    torch.set_num_threads(1)
    mesh = make_fusion_mesh(device="cpu")
    out = {}
    problem = _problem(gn_arrays)
    dense = solve_dense_distributed(mesh, problem, GNConfig(iters=5))
    out["dense"] = dense._replace(
        warped_points=gather_blocks(mesh, dense.warped_points))
    out["motion"] = solve_dense_distributed(
        mesh, _problem(motion_arrays), GNConfig(iters=4, w_motion=2.0))
    out["cg"] = solve_distributed(mesh, problem,
                                  GNConfig(iters=6, cg_iters=30))

    lstm = torch.nn.LSTM(4, lstm_state["weight_hh_l0"].shape[1],
                         num_layers=2)
    lstm.load_state_dict({k: torch.from_numpy(v)
                          for k, v in lstm_state.items()})
    hist = torch.from_numpy(history)
    out["node"] = gather_blocks(mesh, lstm_node_sharded(mesh, lstm, hist),
                                dim=1)
    out["ring"] = gather_blocks(mesh, lstm_time_ring(mesh, lstm, hist))

    cfg = T.TSDFConfig(**volume["config"])
    intr = Intrinsics(*volume["intrinsics"])
    state = T.create_volume(cfg, volume["origin"])
    pts = T.voxel_world_points(cfg, state.origin)
    valid = torch.ones(pts.shape[0], dtype=torch.bool)
    args = (pts, valid, torch.from_numpy(volume["depth"]),
            torch.from_numpy(volume["color"]), intr)
    slab = integrate_slab(mesh, cfg, state, *args)
    whole = T.integrate(cfg, state, *args)
    out["slab"] = [
        torch.equal(gather_blocks(mesh, getattr(slab, f)),
                    getattr(whole, f))
        for f in ("tsdf", "weight", "color")
    ]
    out["slab_voxels"] = int((whole.weight > 0).sum())
    try:
        shard_rows(mesh, torch.zeros(world_size * 80 + 1, 3))
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True
    return out


def _fusion_case(rank_mesh, case, frames):
    """One sharded-engine case on this rank: initialize + build_fused,
    the single-rank chunk (the eager steps on the CPU) and the sharded
    chunk over the same frames, the sharded state gathered."""
    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.fusion.fused_step import (
        _map_state,
        fused_register_chunk,
    )
    from occlusionfusion_tpu_torch.fusion.pipeline import (
        DynamicFusion,
        FusionConfig,
    )
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
    from occlusionfusion_tpu_torch.models.checkpoint import (
        load_motion_complete_net,
    )
    from occlusionfusion_tpu_torch.parallel.dryrun import envelope_nets
    from occlusionfusion_tpu_torch.parallel.engine import (
        fused_register_chunk_sharded,
        gather_state,
        shard_state,
        shard_tables,
    )
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
    from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig

    seq = ArraySequence(frames["colors"], frames["depths"],
                        Intrinsics(*frames["intrinsics"]))
    cfg = dict(case["config"])
    graph = GraphConfig(**cfg.pop("graph"))
    gn = GNConfig(**cfg.pop("gn"))
    nicp = NICPConfig(**cfg.pop("nicp"))
    nets, net = {}, load_motion_complete_net(device="cpu")
    if case.get("perception"):
        net, pwc, mask, lepard = envelope_nets("cpu")
        nets = dict(flow_net=pwc, mask_net=mask, lepard_net=lepard)
    fusion = DynamicFusion(seq, FusionConfig(graph=graph, gn=gn, nicp=nicp,
                                             **cfg), device="cpu", **nets)
    fusion.initialize(seq.load(0))
    sc, state, tables = fusion.build_fused(net)
    n = len(seq) - 1
    depths = torch.stack([torch.from_numpy(seq.load(i).depth)
                          for i in range(1, n + 1)])
    colors = torch.stack([torch.from_numpy(seq.load(i).color)
                          for i in range(1, n + 1)])
    perception = tuple(nets.get(k) for k in ("flow_net", "mask_net",
                                             "lepard_net"))
    ref, ref_infos = fused_register_chunk(
        sc, _map_state(torch.clone, state), tables, net, depths, colors,
        fusion.intr, *perception, graphs={})
    got, infos = fused_register_chunk_sharded(
        rank_mesh, sc, shard_state(rank_mesh, state),
        shard_tables(rank_mesh, tables), net, depths, colors, fusion.intr,
        *perception)
    whole, _ = gather_state(rank_mesh, got, shard_tables(rank_mesh, tables))
    return dict(nodes=fusion.node_count, points=fusion.model_point_count,
                ref_t=ref.translations, ref_R=ref.rotations,
                ref_tsdf=ref.tsdf.tsdf, ref_infos=ref_infos,
                t=got.translations, R=got.rotations, tsdf=whole.tsdf.tsdf,
                weight=whole.tsdf.weight, infos=infos)


def sharded_cases(rank, world_size, frames, cases, train_seeds):
    """The sharded engine's cases on this world (each against the
    single-rank port on this rank), the data-parallel motion train step
    on this rank's samples, and the voxel table's row order."""
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
    from occlusionfusion_tpu_torch.parallel.dryrun import train_sample
    from occlusionfusion_tpu_torch.parallel.mesh import (
        make_fusion_mesh,
        shard_rows,
    )

    torch.set_num_threads(1)
    mesh = make_fusion_mesh(device="cpu")
    out = {name: _fusion_case(mesh, case, frames)
           for name, case in cases.items()}

    net = load_motion_complete_net(device="cpu").train()
    step = make_data_parallel_train_step(net, Adam(net.parameters(), 1e-3),
                                         mesh)
    mine = [sample_to_torch(train_sample(s)) for s in
            train_seeds[rank::world_size]]
    out["train_loss"] = float(step(mine))
    out["train_state"] = {k: v.detach().clone()
                          for k, v in net.state_dict().items()}
    out["train_grads"] = {k: p.grad.clone()
                          for k, p in net.named_parameters()}
    try:
        step(mine[:1] if rank == 0 else mine[:2])
        out["unequal_raises"] = False
    except ValueError:
        out["unequal_raises"] = True

    # the distributed solvers on a problem this rank already holds its
    # shard of, and the slot-sharded integrate, equal the unsharded calls
    from occlusionfusion_tpu_torch.parallel.distributed_gn import (
        shard_problem,
        solve_dense_distributed,
        solve_distributed,
    )
    from occlusionfusion_tpu_torch.parallel.dryrun import _phase3_problem
    from occlusionfusion_tpu_torch.parallel.sequence import integrate_slab
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

    problem = _phase3_problem("cpu", world_size)
    local = shard_problem(mesh, problem)
    same = []
    for solve, cfg in ((solve_distributed, GNConfig(iters=2, cg_iters=8)),
                       (solve_dense_distributed, GNConfig(iters=2))):
        a, b = solve(mesh, problem, cfg), solve(mesh, local, cfg,
                                                 sharded=True)
        same.append(torch.equal(a.translations, b.translations))
    out["presharded_equal"] = same
    # as in JAX, the dense solve assembles by "blocks" and solves by
    # Cholesky whatever its config names
    odd = solve_dense_distributed(
        mesh, problem, GNConfig(iters=2, linear_solver="ns",
                                assembly="dense_j"))
    out["dense_forces_cholesky"] = torch.equal(odd.translations,
                                               a.translations)
    state = T.TSDFState(torch.ones(4 * world_size, 2, 2, 2),
                        torch.zeros(4 * world_size, 2, 2, 2),
                        torch.zeros(4 * world_size, 2, 2, 2, 3),
                        torch.zeros(3))
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(32 * world_size, 3, generator=g) * 0.2 + torch.tensor(
        [-0.1, -0.1, 0.5])
    args = (pts, torch.ones(pts.shape[0], dtype=torch.bool),
            torch.full((16, 16), 0.52), torch.full((16, 16, 3), 90.0),
            Intrinsics(20.0, 20.0, 8.0, 8.0))
    cfg_t = T.TSDFConfig((8, 8, 8), 0.025, 0.1)
    slots = integrate_slab(mesh, cfg_t, state, *args)
    whole = T.integrate(cfg_t, state, *args)
    out["slots_equal"] = all(
        torch.equal(getattr(slots, f), shard_rows(mesh, getattr(whole, f)))
        for f in ("tsdf", "weight", "color"))
    out["slots_updated"] = int((whole.weight > 0).sum())

    # a rank's block of the voxel rows is the voxel grid of its x-slab
    cfg = T.TSDFConfig((4 * world_size, 3, 5), 0.125, 0.3)
    pts = T.voxel_world_points(cfg, torch.zeros(3))
    slab = T.voxel_world_points(T.TSDFConfig((4, 3, 5), 0.125, 0.3),
                                torch.tensor([0.5 * rank, 0.0, 0.0]))
    out["x_slab_rows"] = torch.equal(shard_rows(mesh, pts), slab)
    return out
