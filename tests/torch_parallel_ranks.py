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
