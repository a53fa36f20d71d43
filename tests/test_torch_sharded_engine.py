"""The sharded engine of the port (``parallel/engine.py``, the
data-parallel motion train step, ``parallel/dryrun.entry``) on the CPU:
one launch of 2 gloo ranks computes every case
(``torch_parallel_ranks.sharded_cases``). The sharded fused step over 2
frames (dense 32^3, 64x64, a 64-node cap, 1,024 points, the motion GNN;
gn_dense and N-ICP) is held to the port's single-rank run on the same
rank within ``__graft_entry__.py``'s limits (1e-4 m, tsdf 1e-3), and
so is a bricked case with PWC + MaskNet and Lepard (the one case whose
flow and Lepard steps cross ranks); each case is held to the JAX
package's unsharded ``run_fused`` on the same numpy inputs and the same
checkpoints within the whole-path tolerance of
``tests/test_torch_fusion_slice.py`` (node transforms and tsdf 1e-4,
the counts equal, Lepard's matches too); the data-parallel step to
JAX's ``make_train_step`` on the whole batch."""

import contextlib

import numpy as np
import pytest
import torch

from occlusionfusion_tpu_torch.parallel.mesh import launch
from torch_parallel_ranks import sharded_cases
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    jax_lepard_match_counts,
    jax_run_once,
    one_torch_thread,
)

H = W = 64
INTR = (150.0, 150.0, 32.0, 32.0)
TRAIN_SEEDS = (0, 1, 2, 3)  # the whole batch; rank r holds r::2
BASE = dict(vol_dim=(32, 32, 32), voxel_size=0.01, node_coverage=0.03,
            max_nodes=64, max_points=1024, max_depth_diff=0.05,
            solver="gn_dense", use_motion_model=True)
GRAPH = dict(node_coverage=0.03, min_neighbors=2)
GN = dict(iters=2, w_point=1.0, w_arap=2.0, w_motion=1.0)
NICP = dict(iters=10)
CASES = {
    "gn_dense": dict(config=dict(BASE, graph=GRAPH, gn=GN, nicp=NICP)),
    "nicp": dict(config=dict(BASE, graph=GRAPH, gn=GN, nicp=NICP,
                             solver="nicp")),
    "bricked_perception": dict(
        config=dict(BASE, graph=GRAPH, gn=GN, nicp=NICP, brick_size=8,
                    max_bricks=64, use_flow=True, use_lepard=True,
                    lepard_max_target_points=256),
        perception=True),
}


def frames(n=3):
    """A textured sphere (r 0.1 m) at 0.6 m receding 4 mm a frame."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    d = np.stack([(u - INTR[2]) / INTR[0], (v - INTR[3]) / INTR[1],
                  np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depths = []
    for i in range(n):
        c = np.array([0.0, 0.0, 0.6 + 0.004 * i])
        b = d @ c
        disc = b * b - (c @ c - 0.1 * 0.1)
        t = b - np.sqrt(np.maximum(disc, 0))
        depths.append(np.where((disc > 0) & (t > 0), t * d[..., 2],
                               0.0).astype(np.float32))
    rng = np.random.RandomState(0)
    colors = [rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
              for _ in range(n)]
    return dict(depths=depths, colors=colors, intrinsics=INTR)


@pytest.fixture(scope="module")
def ranks():
    return launch(sharded_cases, 2, frames(), CASES, TRAIN_SEEDS,
                  device="cpu", timeout=300)


def jax_perception():
    """The bricked case's nets for JAX's DynamicFusion, from the
    checkpoints the port's ``dryrun.envelope_nets`` loads: PWC + MaskNet
    (checkpoints/flow.npz) and Lepard (lepard_bridge_r5e.npz at the dry
    run's pyramid sizes)."""
    import os

    from occlusionfusion_tpu.models.checkpoint import (
        load_lepard_checkpoint,
        normalize_indexed,
    )
    from occlusionfusion_tpu.utils.snapshot import load_params
    from occlusionfusion_tpu_torch.models.checkpoint import FLOW_NPZ
    from occlusionfusion_tpu_torch.parallel import dryrun

    ck = normalize_indexed(load_params(FLOW_NPZ))
    lep, cfg = load_lepard_checkpoint(os.path.join(dryrun.CHECKPOINTS,
                                                   dryrun.LEPARD))
    pyr = cfg.kpfcn.pyramid._replace(level_sizes=dryrun.LEPARD_LEVELS)
    return dict(flow_params=ck["pwc"], mask_params=ck["mask"],
                lepard_params=lep, lepard_config=cfg._replace(
                    kpfcn=cfg.kpfcn._replace(pyramid=pyr)))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's unsharded run_fused of every case."""
    import jax.numpy as jnp

    from occlusionfusion_tpu.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu.fusion.pipeline import (
        DynamicFusion,
        FusionConfig,
    )
    from occlusionfusion_tpu.geometry.camera import Intrinsics
    from occlusionfusion_tpu.graph.edgraph import GraphConfig
    from occlusionfusion_tpu.models.checkpoint import (
        load_motion_complete_params,
    )
    from occlusionfusion_tpu.solvers.gauss_newton import GNConfig
    from occlusionfusion_tpu.solvers.nicp import NICPConfig

    fr = frames()
    params = load_motion_complete_params()
    out = {}
    for name in CASES:
        cfg = dict(CASES[name]["config"])
        cfg.update(graph=GraphConfig(**cfg["graph"]), nicp=NICPConfig(
            **cfg["nicp"]), gn=GNConfig(linear_solver="cholesky",
                                        assembly="blocks", **cfg["gn"]))
        seq = ArraySequence(fr["colors"], fr["depths"],
                            Intrinsics(*(jnp.float32(x) for x in INTR)))
        nets = jax_perception() if CASES[name].get("perception") else {}
        fj = DynamicFusion(seq, FusionConfig(**cfg), **nets)
        with (jax_lepard_match_counts() if nets
              else contextlib.nullcontext([])) as matches:
            infos = fj.run_fused(motion_params=params)
        n = fj.node_count
        out[name] = dict(t=np.asarray(fj.warp.translations)[:n],
                         R=np.asarray(fj.warp.rotations)[:n],
                         tsdf=np.asarray(fj.tsdf.tsdf),
                         weight=np.asarray(fj.tsdf.weight), infos=infos,
                         nodes=n, lepard=list(matches))
    return out


def test_every_rank_holds_the_same_result(ranks):
    for name in CASES:
        a, b = ranks[0][name], ranks[1][name]
        assert torch.equal(a["t"], b["t"]) and torch.equal(a["R"], b["R"])
        assert torch.equal(a["tsdf"], b["tsdf"])
        assert torch.equal(a["infos"], b["infos"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_single_rank(ranks, name):
    c = ranks[0][name]
    assert 10 <= c["nodes"] <= 64 and c["points"] == 1024
    assert float((c["t"] - c["ref_t"]).abs().max()) < 1e-4
    assert float((c["tsdf"] - c["ref_tsdf"]).abs().max()) < 1e-3
    # counts equal; the loss and the confidence to rounding
    np.testing.assert_array_equal(c["infos"][:, [1, 2, 4, 5, 6]].numpy(),
                                  c["ref_infos"][:, [1, 2, 4, 5, 6]].numpy())
    np.testing.assert_allclose(c["infos"].numpy(), c["ref_infos"].numpy(),
                               rtol=1e-4, atol=1e-5)
    if name == "bricked_perception":
        assert c["infos"][:, 6].min() > 0 and c["infos"][1:, 5].sum() > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_jax(ranks, jax_runs, name):
    c, j = ranks[0][name], jax_runs[name]
    n = j["nodes"]
    assert c["nodes"] == n
    np.testing.assert_allclose(c["t"][:n].numpy(), j["t"], atol=1e-4)
    np.testing.assert_allclose(c["R"][:n].numpy(), j["R"], atol=1e-4)
    np.testing.assert_array_equal(c["weight"].numpy(), j["weight"])
    np.testing.assert_allclose(c["tsdf"].numpy(), j["tsdf"], atol=1e-4)
    for row, info in zip(c["infos"].numpy(), j["infos"]):
        assert row[1] == info["n_correspondences"]
        assert row[2] == info["n_visible_nodes"]
        assert abs(row[0] - info["final_loss"]) <= 1e-3 * info["final_loss"]
    if j["lepard"]:
        assert c["infos"][:, 6].tolist() == j["lepard"]


def test_data_parallel_train_step_matches_jax(ranks):
    """Each rank's two samples against JAX's step on the four: the loss
    and the updated parameters within 1e-5 relative."""
    import jax
    import jax.numpy as jnp
    import optax

    from occlusionfusion_tpu.models.checkpoint import load_params
    from occlusionfusion_tpu.models.motion_complete import PyramidBatch
    from occlusionfusion_tpu.models.motion_train import (
        MotionBatch,
        make_train_step,
    )
    from occlusionfusion_tpu_torch.models import checkpoint as C
    from occlusionfusion_tpu_torch.parallel.dryrun import train_sample

    def to_jax(s):
        pyr = PyramidBatch(*(tuple(jnp.asarray(x) for x in f)
                             if isinstance(f, tuple) else jnp.asarray(f)
                             for f in s.pyramid))
        return MotionBatch(*(jnp.asarray(x) for x in s[:-1]), pyramid=pyr)

    batch = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[to_jax(train_sample(s)) for s in TRAIN_SEEDS])
    params = jax.tree.map(jnp.asarray, load_params(C.MOTION_COMPLETE_NPZ))
    opt = optax.adam(1e-3)
    new, _, loss = jax_run_once(make_train_step(opt), params,
                                opt.init(params), batch)
    for r in ranks:
        np.testing.assert_allclose(r["train_loss"], float(loss), rtol=1e-5)
    ref = C.params_from_jax(jax.tree.map(np.asarray, new))
    old = C.params_from_jax(jax.tree.map(np.asarray, params))
    grads = ranks[0]["train_grads"]
    total = float(torch.sqrt(sum(torch.sum(g**2) for g in grads.values())))
    for k, v in ranks[0]["train_state"].items():
        assert torch.equal(v, ranks[1]["train_state"][k]), k
        if float(grads[k].norm()) < 1e-5 * total:
            # a gradient zero up to rounding (the attention keys' biases,
            # which a softmax cancels): Adam's first step moves each entry
            # by at most the learning rate, on either side
            for p in (v, ref[k]):
                assert float((p - old[k]).abs().max()) <= 1e-3 * (1 + 1e-5)
            continue
        gap = float((v - ref[k]).norm()) / max(float(ref[k].norm()), 1e-12)
        assert gap <= 1e-5, (k, gap)


def test_unequal_sample_counts_raise_on_every_rank(ranks):
    assert all(r["unequal_raises"] for r in ranks)


def test_voxel_rows_of_a_rank_are_its_x_slab(ranks):
    assert all(r["x_slab_rows"] for r in ranks)


def test_presharded_problems_solve_as_whole_ones(ranks):
    """solve_distributed and solve_dense_distributed with ``sharded=True``
    on this rank's block equal the calls that shard the whole problem."""
    assert all(all(r["presharded_equal"]) for r in ranks)


def test_dense_distributed_solve_forces_cholesky_on_blocks(ranks):
    """A config naming ns and dense_j solves as the default one does
    (JAX's solve_dense_distributed forces both)."""
    assert all(r["dense_forces_cholesky"] for r in ranks)


def test_slot_sharded_integrate_equals_whole_volume(ranks):
    assert all(r["slots_equal"] for r in ranks)
    assert ranks[0]["slots_updated"] > 0


def test_entry_matches_jax_entry():
    import jax

    import __graft_entry__ as G
    from occlusionfusion_tpu_torch.parallel import dryrun

    fn_j, args_j = G.entry()
    ref = np.asarray(jax.jit(fn_j)(*args_j))
    fn, args = dryrun.entry(device="cpu")
    got = fn(*args).numpy()
    assert got.shape == ref.shape == (512, 4)
    np.testing.assert_allclose(got, ref, atol=1e-4)

