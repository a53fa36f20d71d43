"""Graph growth with the bricked volume's refresh in both engines of the
port against the JAX package on the CPU.

The input: tests/test_fusion_e2e.py's sphere (1 m, receding 4 mm a
frame, 128x128) with a second sphere (r 4 cm) sliding into view from the
right by 2 cm a frame, so that new surface appears; 48^3 at 8 mm in
bricks of 4 (1024 slots), the motion GNN (the JAX side built as
scripts/run_fusion.py builds it, with the motion checkpoint given to the
constructor, so that its growth rebuilds the motion pyramid), growth
every 2nd frame, initialize + 4 frames through the stepwise ``run``
with dense Gauss-Newton and through ``run_fused(chunk=2)`` with N-ICP
(20 Adam iterations).

Held equal: the new nodes per growth frame, the node count, the brick
table after the refreshes, the edges, the clusters and the rebuilt motion
pyramid; the correspondences within 0.5%; the median node translation
within 1e-4 m; the node positions within 1e-5 m. New nodes are
marching-cubes vertices of the canonical TSDF, whose values agree to
7.5e-6 here, and a vertex interpolates along an 8 mm voxel edge, which
makes that ~1e-6 m (1.7e-6 read after the N-ICP run's second growth).
Readings of the Gauss-Newton stepwise run: nodes 6e-8 m, translations
1.2e-7 m. The stepwise loop runs Gauss-Newton because N-ICP's first solve
after growth starts the new nodes at identity (ROADMAP F11), where
Adam's sign-like first steps on nodes with near-zero gradients turn
rounding into 1e-4 m: the vertices then differ at the next growth, and
the greedy sampler picks other nodes from them."""

import dataclasses

import numpy as np
import pytest

from occlusionfusion_tpu.fusion.frame_loader import ArraySequence as SeqJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.models.checkpoint import load_motion_complete_params
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.nicp import NICPConfig as NICPConfigJ
from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
from occlusionfusion_tpu_torch.models.checkpoint import (
    load_motion_complete_net,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig
from test_fusion_e2e import H, INTR, W, small_config
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    port_fusion_config,
    port_sequence,
)

N_FRAMES = 5
GROWTH = 2
LOOPS = ["run", "run_fused"]
SOLVER = {"run": "gn_dense", "run_fused": "nicp"}
GN = dict(iters=6, w_point=1.0, w_arap=10.0, w_motion=1.0)
NODE_ATOL = 1e-5


def spheres_depth(spheres):
    """Analytic z-depth of the nearest of several spheres (centre,
    radius) from the pinhole camera at the origin."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    d = np.stack([(u - INTR.cx) / INTR.fx, (v - INTR.cy) / INTR.fy,
                  np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    best = np.full((H, W), np.inf)
    for c, r in spheres:
        c = np.asarray(c, np.float32)
        b = d @ c
        disc = b * b - (c @ c - r * r)
        t = b - np.sqrt(np.maximum(disc, 0))
        best = np.where((disc > 0) & (t > 0) & (t < best), t, best)
    return np.where(np.isfinite(best), best * d[..., 2], 0.0).astype(
        np.float32)


def appearing_sequence(n=N_FRAMES):
    depths = [spheres_depth([([0.0, 0.0, 1.0 + 0.004 * i], 0.1),
                             ([0.22 - 0.02 * i, 0.0, 0.95], 0.04)])
              for i in range(n)]
    colors = [np.full((H, W, 3), 128.0, np.float32)] * n
    return SeqJ(colors, depths, INTR)


@pytest.fixture(scope="module")
def runs():
    """loop -> (JAX fusion, JAX infos, port fusion, port infos)."""
    params = load_motion_complete_params()
    net = load_motion_complete_net(device="cpu")
    seq_j = appearing_sequence()
    out = {}
    for loop in LOOPS:
        cfg_j = dataclasses.replace(
            small_config(), nicp=NICPConfigJ(iters=20), use_motion_model=True,
            dense_skin_max_bytes=0, brick_size=4, max_bricks=1024,
            growth_interval=GROWTH, solver=SOLVER[loop],
            gn=GNConfigJ(linear_solver="cholesky", assembly="blocks", **GN))
        cfg_t = port_fusion_config(cfg_j, nicp=NICPConfig(iters=20),
                                   gn=GNConfig(**GN))
        fj = DynamicFusionJ(seq_j, cfg_j, motion_params=params)
        infos_j = (fj.run() if loop == "run"
                   else fj.run_fused(chunk=2, motion_params=params))
        ft = DynamicFusion(port_sequence(seq_j), cfg_t, device="cpu")
        infos_t = getattr(ft, loop)(motion_net=net,
                                    **({"chunk": 2} if loop != "run" else {}))
        out[loop] = (fj, infos_j, ft, infos_t)
    return out


@pytest.mark.parametrize("loop", LOOPS)
def test_growth_counts_match_jax(runs, loop):
    fj, infos_j, ft, infos_t = runs[loop]
    assert len(infos_t) == len(infos_j) == N_FRAMES - 1
    grown = [i.get("n_new_nodes") for i in infos_t]
    assert grown == [i.get("n_new_nodes") for i in infos_j]
    # nodes at frame 2 and at frame 4; run_fused reports them at a growth
    # chunk's last frame only
    assert grown[1] > 0 and grown[3] > 0, grown
    if loop == "run_fused":
        assert grown[0] is None and grown[2] is None
    assert ft.node_count == fj.node_count > 20
    # the refresh activated bricks on the sliding sphere's surface
    np.testing.assert_array_equal(ft.brick_ids, np.asarray(fj.brick_ids))
    assert (ft.brick_ids >= 0).sum() > len(ft.brick_ids) // 2
    for a, b in zip(infos_t, infos_j):
        assert abs(a["n_correspondences"] - b["n_correspondences"]) <= (
            0.005 * b["n_correspondences"])


@pytest.mark.parametrize("loop", LOOPS)
def test_grown_graph_matches_jax(runs, loop):
    fj, _, ft, _ = runs[loop]
    np.testing.assert_allclose(ft.nodes.numpy(), np.asarray(fj.nodes),
                               atol=NODE_ATOL, rtol=0)
    for name in ("node_valid", "edges", "node_clusters"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                      np.asarray(getattr(fj, name)), name)
    np.testing.assert_allclose(ft.edge_weights.numpy(),
                               np.asarray(fj.edge_weights), atol=1e-4)
    assert ft.graph.pyramid.keys() == fj.graph.pyramid.keys()
    for k, v in fj.graph.pyramid.items():
        np.testing.assert_array_equal(ft.graph.pyramid[k], v, k)


@pytest.mark.parametrize("loop", LOOPS)
def test_median_translation_matches_jax(runs, loop):
    fj, _, ft, _ = runs[loop]
    n = fj.node_count
    med_t = np.median(ft.warp.translations.numpy()[:n], axis=0)
    med_j = np.median(np.asarray(fj.warp.translations)[:n], axis=0)
    np.testing.assert_allclose(med_t, med_j, atol=1e-4, rtol=0)


def test_fused_growth_rebuilds_the_tables(runs):
    """Each growth chunk that added nodes rebuilt the tables: the voxel
    skin table covers the refreshed bricks and the new nodes."""
    _, _, ft, _ = runs["run_fused"]
    assert [g["frame"] for g in ft.growth_log] == [2, 4]
    assert all(g["n_new_nodes"] > 0 and g["n_new_bricks"] > 0
               for g in ft.growth_log), ft.growth_log
    anchors = ft.vox_table.anchors.numpy()[ft.vox_table.valid.numpy()]
    assert anchors.max() >= ft.node_count - ft.growth_log[-1]["n_new_nodes"]
    assert not ft.vox_table.valid.numpy()[~ft.brick_valid.numpy()].any()
