"""The port's parallel/ (torch.distributed, gloo on the CPU) against the
JAX package's on the same numpy inputs: one launch per world size (2 and
4 ranks) computes every case; JAX runs on a 4-device mesh of the
conftest's 8 CPU devices, with JAX's own tolerances
(tests/test_distributed_gn.py, tests/test_parallel.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from occlusionfusion_tpu.models.checkpoint import load_motion_complete_params
from occlusionfusion_tpu.models.motion_complete import lstm_forward
from occlusionfusion_tpu.parallel.distributed_gn import (
    solve_dense_distributed,
)
from occlusionfusion_tpu.parallel.mesh import make_fusion_mesh
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig, solve
from occlusionfusion_tpu.solvers.gauss_newton_dense import solve_dense

from occlusionfusion_tpu_torch.parallel.mesh import launch

from test_gauss_newton import build_problem
from torch_parallel_ranks import every_case
from torch_port_impl import jax_run_once

WORLD_SIZES = (2, 4)
VOL = 16  # divides by every world size


def _numpy(problem):
    out = {}
    for name, v in problem._asdict().items():
        if v is None:
            continue
        a = np.array(v)
        out[name] = a.astype(np.int32) if a.dtype == np.int64 else a
    return out


@pytest.fixture(scope="module")
def jax_refs():
    mesh = make_fusion_mesh(4)
    problem, _, target_nodes = build_problem(n_pts=320, n_nodes=24)
    motion = problem._replace(motion_targets=target_nodes,
                              motion_confidence=jnp.ones(24))
    cfg = GNConfig(iters=5, assembly="blocks")
    cfg_m = GNConfig(iters=4, w_motion=2.0, assembly="blocks")
    # the repo's motion GNN's LSTM (tests/test_parallel.py draws random
    # weights: the whole net's initialiser takes seconds to compile)
    params = load_motion_complete_params()["seq_encoder"]
    hist = np.random.RandomState(1).randn(16, 64, 4).astype(np.float32)
    cfg_cg = GNConfig(iters=6, cg_iters=30)
    return dict(
        problem=_numpy(problem), motion=_numpy(motion),
        dense=jax_run_once(lambda p: solve_dense(p, cfg), problem),
        dense_dist=jax_run_once(
            lambda p: solve_dense_distributed(mesh, p, cfg), problem),
        motion_dense=jax_run_once(lambda p: solve_dense(p, cfg_m), motion),
        cg=jax_run_once(lambda p: solve(p, cfg_cg), problem),
        lstm_state={k: np.asarray(v) for k, v in params.items()},
        history=np.asarray(hist),
        lstm=np.asarray(jax_run_once(lstm_forward, params,
                                     jnp.asarray(hist))),
    )


def _volume():
    """A wall at 0.5 m seen by a 32x32 camera, a 16^3 volume in front."""
    depth = np.full((32, 32), 0.5, np.float32)
    depth[:, :8] = 0.0
    u, v = np.meshgrid(np.arange(32) * 7.0, np.arange(32) * 5.0,
                       indexing="ij")
    color = np.stack([u, v, np.full((32, 32), 90.0)], -1).astype(np.float32)
    return dict(config=dict(vol_dim=(VOL,) * 3, voxel_size=0.02,
                            trunc_margin=0.06),
                origin=np.asarray([-0.16, -0.16, 0.3], np.float32),
                intrinsics=(40.0, 40.0, 16.0, 16.0), depth=depth,
                color=color)


@pytest.fixture(scope="module", params=WORLD_SIZES)
def ranks(request, jax_refs):
    r = jax_refs
    return launch(every_case, request.param, r["problem"], r["motion"],
                  r["lstm_state"], r["history"], _volume(), device="cpu",
                  timeout=300)


def test_every_rank_agrees(ranks):
    for out in ranks[1:]:
        for key in ("dense", "motion", "cg"):
            np.testing.assert_array_equal(out[key].translations.numpy(),
                                          ranks[0][key].translations.numpy())


def test_dense_distributed_matches_jax(ranks, jax_refs):
    got = ranks[0]["dense"]
    assert bool(got.valid)
    for ref in (jax_refs["dense"], jax_refs["dense_dist"]):
        np.testing.assert_allclose(got.translations.numpy(),
                                   np.asarray(ref.translations), atol=1e-5)
        np.testing.assert_allclose(got.rotations.numpy(),
                                   np.asarray(ref.rotations), atol=1e-5)
        hist = np.asarray(ref.residual_history)
        np.testing.assert_allclose(got.residual_history.numpy(), hist,
                                   rtol=1e-4, atol=1e-9 * hist[0])
    np.testing.assert_allclose(got.warped_points.numpy(),
                               np.asarray(jax_refs["dense"].warped_points),
                               atol=1e-5)


def test_motion_term_exact_under_sharding(ranks, jax_refs):
    np.testing.assert_allclose(
        ranks[0]["motion"].translations.numpy(),
        np.asarray(jax_refs["motion_dense"].translations), atol=1e-5)


def test_matrix_free_distributed_matches_jax_solve(ranks, jax_refs):
    got, ref = ranks[0]["cg"], jax_refs["cg"]
    assert bool(got.valid)
    np.testing.assert_allclose(got.translations.numpy(),
                               np.asarray(ref.translations), atol=1e-4)
    np.testing.assert_allclose(got.rotations.numpy(),
                               np.asarray(ref.rotations), atol=1e-4)


@pytest.mark.parametrize("mode", ["node", "ring"])
def test_lstm_sharding_matches_jax(ranks, jax_refs, mode):
    for out in ranks:
        np.testing.assert_allclose(out[mode].numpy(), jax_refs["lstm"],
                                   atol=1e-5)


def test_slab_integrate_equals_whole_volume(ranks):
    for out in ranks:
        assert out["slab"] == [True, True, True]
        assert out["slab_voxels"] > 0


def test_indivisible_points_raise(ranks):
    assert all(out["indivisible_raises"] for out in ranks)
