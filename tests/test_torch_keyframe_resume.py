"""save_state / load_state of the port against the JAX package on the
CPU: a snapshot written by either package loads in the other, and the
resumed run continues as the same package's own resumed run does.

- Stepwise (tests/test_fusion_e2e.py's sphere, 48^3, N-ICP with 20 Adam
  iterations and the motion GNN): the writer saves after frame 2, a fresh
  object of each package loads the file and runs frames 3 and 4; the
  port's continuation is held to JAX's from the same file (counts equal,
  node transforms within 1e-4, TSDF within 1e-4 where the weights
  agree), for a JAX-written and a port-written file.
- The fused engine: ``run_fused`` to frame 2, save, load, then
  ``build_fused`` and two ``register_frame_fused`` steps in each package.
- ROADMAP F10: JAX's fused engine never advances the motion history it
  saves, and a fused resume starts afresh in both packages; the stepwise
  loops save and restore the history they carry.
- The flow source after ``load_state``: neither package has a previous
  frame there, so the stepwise loop's first frame runs no flow and the
  next one does (tests/test_torch_flow_modes.py's textured pair and
  checkpoints/flow.npz, dense Gauss-Newton)."""

import dataclasses

import numpy as np
import pytest

from occlusionfusion_tpu.fusion.frame_loader import ArraySequence as SeqJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.models.checkpoint import (
    load_motion_complete_params,
    normalize_indexed,
)
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.nicp import NICPConfig as NICPConfigJ
from occlusionfusion_tpu.utils.snapshot import load_flat as load_flat_jax
from occlusionfusion_tpu.utils.snapshot import load_params
from occlusionfusion_tpu_torch.fusion.pipeline import DynamicFusion
from occlusionfusion_tpu_torch.models.checkpoint import (
    FLOW_NPZ,
    load_flow_nets,
    load_motion_complete_net,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig
from occlusionfusion_tpu_torch.utils.snapshot import load_flat
from test_fusion_e2e import make_sequence, small_config
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    port_fusion_config,
    port_sequence,
    textured_sphere_frames,
)

RT_ATOL = 1e-4
TSDF_ATOL = 1e-4
SAVE_AT = 2
N_FRAMES = 5


def _configs():
    cfg_j = dataclasses.replace(small_config(), nicp=NICPConfigJ(iters=20),
                                use_motion_model=True,
                                dense_skin_max_bytes=0)
    return cfg_j, port_fusion_config(cfg_j, nicp=NICPConfig(iters=20))


def _assert_same_run(ft, fj, infos_t, infos_j):
    assert [i["n_correspondences"] for i in infos_t] == [
        i["n_correspondences"] for i in infos_j]
    n = fj.node_count
    assert ft.node_count == n and ft.frame_id == fj.frame_id
    for name in ("rotations", "translations"):
        np.testing.assert_allclose(
            getattr(ft.warp, name).numpy()[:n],
            np.asarray(getattr(fj.warp, name))[:n], atol=RT_ATOL, rtol=0)
    w_t, w_j = ft.tsdf.weight.numpy(), np.asarray(fj.tsdf.weight)
    same = w_t == w_j
    assert np.mean(~same) <= 1e-4
    np.testing.assert_allclose(ft.tsdf.tsdf.numpy()[same],
                               np.asarray(fj.tsdf.tsdf)[same],
                               atol=TSDF_ATOL)


@pytest.fixture(scope="module")
def stepwise(tmp_path_factory):
    """writer -> (snapshot path, JAX resumed (fusion, infos), port resumed
    (fusion, infos)), and the writers' objects."""
    d = tmp_path_factory.mktemp("snapshots")
    seq_j, _ = make_sequence(n_frames=N_FRAMES)
    seq_t = port_sequence(seq_j)
    cfg_j, cfg_t = _configs()
    params = load_motion_complete_params()
    net = load_motion_complete_net(device="cpu")
    writers = {"jax": DynamicFusionJ(seq_j, cfg_j, motion_params=params),
               "port": DynamicFusion(seq_t, cfg_t, device="cpu")}
    paths = {}
    for name, f in writers.items():
        if name == "jax":
            f.run(end=SAVE_AT + 1)
        else:
            f.run(end=SAVE_AT + 1, motion_net=net)
        paths[name] = str(d / f"{name}.npz")
        f.save_state(paths[name])
    out = {}
    for name, path in paths.items():
        fj = DynamicFusionJ(seq_j, cfg_j, motion_params=params)
        fj.load_state(path)
        infos_j = [fj.register_frame(seq_j.load(i))
                   for i in range(SAVE_AT + 1, N_FRAMES)]
        ft = DynamicFusion(seq_t, cfg_t, device="cpu")
        ft.load_state(path)
        infos_t = [ft.register_frame(seq_t.load(i), net)
                   for i in range(SAVE_AT + 1, N_FRAMES)]
        out[name] = (path, (fj, infos_j), (ft, infos_t))
    return out, writers


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stepwise_resume_matches_jax(stepwise, writer):
    out, _ = stepwise
    _, (fj, infos_j), (ft, infos_t) = out[writer]
    assert ft.frame_id == N_FRAMES - 1
    _assert_same_run(ft, fj, infos_t, infos_j)


def test_snapshots_have_the_same_layout(stepwise):
    """The two writers' files: the same keys, dtypes and shapes, and equal
    graph arrays (the node positions, marching-cubes vertices, to
    rounding)."""
    out, _ = stepwise
    fj, ft = load_flat_jax(out["jax"][0]), load_flat(out["port"][0])
    assert sorted(fj) == sorted(ft)
    assert any(k.startswith("motion_state/") for k in fj)
    for k in fj:
        assert fj[k].dtype == ft[k].dtype and fj[k].shape == ft[k].shape, k
    np.testing.assert_allclose(ft["nodes"], fj["nodes"], atol=1e-6)
    for k in ("node_valid", "edges", "node_clusters", "node_count",
              "model_valid", "frame_id", "vol_dim", "motion_state/frame_idx",
              "motion_state/history_len", "motion_state/prev_n"):
        np.testing.assert_array_equal(ft[k], fj[k], k)


def test_f10_motion_history_on_save_and_resume(stepwise, tmp_path):
    """ROADMAP F10. The stepwise loops save the history they carry
    (frame_idx = frames registered) and resume with it. The JAX fused
    engine never advances the history it saves: after run_fused its file
    holds a fresh one (frame_idx 0) although the engine ran 2 frames; the
    port's fused engine saves none, which loads as the same fresh
    history. A fused resume (build_fused) starts afresh in both."""
    out, writers = stepwise
    for name in ("jax", "port"):
        flat = load_flat(out[name][0])
        assert int(flat["motion_state/frame_idx"]) == SAVE_AT
    seq_j, _ = make_sequence(n_frames=SAVE_AT + 1)
    cfg_j, cfg_t = _configs()
    params = load_motion_complete_params()
    fj = DynamicFusionJ(seq_j, cfg_j, motion_params=params)
    fj.run_fused(chunk=2, motion_params=params)
    fj.save_state(str(tmp_path / "fused_j.npz"))
    flat = load_flat(str(tmp_path / "fused_j.npz"))
    assert int(flat["motion_state/frame_idx"]) == 0
    assert not flat["motion_state/history"].any()
    ft = DynamicFusion(port_sequence(seq_j), cfg_t, device="cpu")
    ft.run_fused(chunk=2, motion_net=load_motion_complete_net(device="cpu"))
    ft.save_state(str(tmp_path / "fused_t.npz"))
    assert not any(k.startswith("motion_state/")
                   for k in load_flat(str(tmp_path / "fused_t.npz")))
    # a stepwise resume restores the carried history; a fused one does not
    resumed = DynamicFusion(port_sequence(seq_j), cfg_t, device="cpu")
    resumed.load_state(out["port"][0])
    assert int(resumed._resume_motion.frame_idx) == SAVE_AT
    _, state, _ = resumed.build_fused(None)
    assert int(state.motion.frame_idx) == 0
    _, state_j, _ = fj.build_fused(params)
    assert int(state_j.motion.frame_idx) == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fused_resume_matches_jax(writer, tmp_path):
    seq_j, _ = make_sequence(n_frames=N_FRAMES)
    seq_t = port_sequence(seq_j)
    cfg_j, cfg_t = _configs()
    params = load_motion_complete_params()
    net = load_motion_complete_net(device="cpu")
    path = str(tmp_path / "fused.npz")
    if writer == "jax":
        w = DynamicFusionJ(seq_j, cfg_j, motion_params=params)
        w.run_fused(chunk=2, end=SAVE_AT + 1, motion_params=params)
    else:
        w = DynamicFusion(seq_t, cfg_t, device="cpu")
        w.run_fused(chunk=2, end=SAVE_AT + 1, motion_net=net)
    w.save_state(path)
    runs = []
    for f, p, seq in ((DynamicFusionJ(seq_j, cfg_j, motion_params=params),
                       params, seq_j),
                      (DynamicFusion(seq_t, cfg_t, device="cpu"), net,
                       seq_t)):
        f.load_state(path)
        sc, state, tables = f.build_fused(p)
        infos = []
        for i in range(SAVE_AT + 1, N_FRAMES):
            state, info = f.register_frame_fused(sc, state, tables,
                                                 seq.load(i), p)
            infos.append({"n_correspondences": int(np.asarray(info)[1])})
        f.adopt_fused_state(state)
        f.frame_id = N_FRAMES - 1
        runs.append((f, infos))
    (fj, infos_j), (ft, infos_t) = runs
    _assert_same_run(ft, fj, infos_t, infos_j)


def test_first_frame_after_load_runs_no_flow(tmp_path):
    from test_torch_flow_modes import GN, INTR_J, SMALL

    centers = [np.array([0.0, 0.0, 0.6]) + np.array([0.006, 0.0, 0.002]) * i
               for i in range(4)]
    depths, colors = textured_sphere_frames(centers, 64, 64, INTR_J, 0.1)
    seq_j = SeqJ(colors, depths, INTR_J)
    seq_t = port_sequence(seq_j)
    tree = normalize_indexed(load_params(FLOW_NPZ))
    pwc, mask = load_flow_nets(device="cpu")
    cfg_j = dataclasses.replace(
        small_config(), use_flow=True, flow_mask_threshold=0.35,
        gn=GNConfigJ(linear_solver="cholesky", assembly="blocks", **GN),
        **{**SMALL, "graph": small_config().graph})
    cfg_t = port_fusion_config(cfg_j, gn=GNConfig(**GN))
    path = str(tmp_path / "flow.npz")
    w = DynamicFusionJ(seq_j, cfg_j, flow_params=tree["pwc"],
                       mask_params=tree["mask"])
    w.run(end=2)
    w.save_state(path)
    fj = DynamicFusionJ(seq_j, cfg_j, flow_params=tree["pwc"],
                        mask_params=tree["mask"])
    ft = DynamicFusion(seq_t, cfg_t, device="cpu", flow_net=pwc,
                       mask_net=mask)
    for f in (fj, ft):
        f.load_state(path)
        assert f.prev_frame is None
    infos_j = [fj.register_frame(seq_j.load(i)) for i in (2, 3)]
    infos_t = [ft.register_frame(seq_t.load(i)) for i in (2, 3)]
    assert [i["n_flow_filled"] for i in infos_t][0] == 0
    assert infos_t[1]["n_flow_filled"] > 0
    with pytest.raises(ValueError, match="previous frame"):
        f2 = DynamicFusion(seq_t, cfg_t, device="cpu", flow_net=pwc,
                           mask_net=mask)
        f2.load_state(path)
        sc, state, tables = f2.build_fused(None)
        f2.register_frame_fused(sc, state, tables, seq_t.load(2))
    _assert_same_run(ft, fj, infos_t, infos_j)
    assert ft._stepwise[1].prev_rgbxyz is not None
