"""The port's evaluation and export tools against the JAX scripts on the
CPU, on the same tiny inputs (the JAX scripts run in this process through
``torch_port_impl.run_jax_script``, which reads their per-sample values
before their JSON rounds them):

- ``export_deepdeform`` at 64x64, 3 frames, 2,000 vertices: the same
  tree (depth PNGs, flows, graph blobs, node deformations equal; pixel
  anchors equal, their weights within 1e-6); the port's PNG colour,
  encoded as the JAX script encodes it, gives the JAX script's JPEG;
- ``evaluate_deepdeform`` on the port's tree, with the ground-truth flow
  and with checkpoints/flow.npz, the datasets' node cap cut from 1,024 to
  128 in both packages (the graphs have ~30 nodes): per sample graph_mm
  and epe3d_mm within 0.01 mm, epe2d_px within 1e-3 px, the same valid
  solves and match candidates;
- ``evaluate_dt4d --synthetic --shape limbs --rotate_deg 3`` at 2 frames
  (fused, gn_dense), with the volume cut to 32^3 of 12 mm voxels and 128
  nodes in both packages: per-frame EPE and ate_m within 1e-5 m, equal
  correspondence counts; then ``--trajectory`` on JAX's estimated poses,
  pose_ate_m within 1e-6 m;
- ``visualize_demo`` on ``run_demo``'s output: the points, colour values
  and arrows it draws equal to what the JAX script hands matplotlib, and
  each PNG read back at its size.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

from occlusionfusion_tpu_torch.fusion.frame_loader import read_png
from torch_port_impl import one_torch_thread, run_jax_script  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_NPZ = os.path.join(ROOT, "checkpoints", "flow.npz")
EXPORT = ["--frames", "3", "--height", "64", "--width", "64", "--verts",
          "2000"]
EVAL_DD = ["--height", "64", "--width", "64", "--matches", "256"]
CLIP = ["--synthetic", "--shape", "limbs", "--rotate_deg", "3", "--frames",
        "2"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """(JAX tree, port tree) of export_deepdeform."""
    from occlusionfusion_tpu_torch.scripts import export_deepdeform

    jax_dir = str(tmp_path_factory.mktemp("dd_jax"))
    port_dir = str(tmp_path_factory.mktemp("dd_port"))
    run_jax_script("export_deepdeform", ["--out", jax_dir] + EXPORT)
    export_deepdeform.main(["--out", port_dir] + EXPORT + CPU)
    return jax_dir, port_dir


def _samples(root):
    with open(os.path.join(root, "train.json")) as fh:
        return json.load(fh)


def test_export_writes_the_jax_tree(exports):
    from occlusionfusion_tpu_torch.data import formats

    jax_dir, port_dir = exports
    sj, st = _samples(jax_dir), _samples(port_dir)
    assert len(st) == len(sj) == 2
    colour = ("source_color", "target_color")
    for a, b in zip(st, sj):
        assert all(a[k].endswith(".png") and b[k] == a[k][:-4] + ".jpg"
                   for k in colour)
        assert ({k: v for k, v in a.items() if k not in colour}
                == {k: v for k, v in b.items() if k not in colour})
    for s, j in zip(st, sj):
        for key in ("source_depth", "target_depth"):
            np.testing.assert_array_equal(
                read_png(os.path.join(port_dir, s[key])),
                read_png(os.path.join(jax_dir, s[key])))
        for key in ("optical_flow", "scene_flow"):
            np.testing.assert_array_equal(
                formats.load_flow(os.path.join(port_dir, s[key])),
                formats.load_flow(os.path.join(jax_dir, s[key])))
        for key, load in (("graph_nodes", formats.load_graph_nodes),
                          ("graph_edges", formats.load_graph_edges),
                          ("graph_edges_weights",
                           formats.load_graph_edges_weights),
                          ("graph_clusters", formats.load_graph_clusters),
                          ("graph_node_deformations",
                           formats.load_graph_nodes),
                          ("pixel_anchors", formats.load_int_image)):
            np.testing.assert_array_equal(
                load(os.path.join(port_dir, s[key])),
                load(os.path.join(jax_dir, s[key])), err_msg=key)
        np.testing.assert_allclose(
            formats.load_float_image(os.path.join(port_dir,
                                                  s["pixel_weights"])),
            formats.load_float_image(os.path.join(jax_dir,
                                                  s["pixel_weights"])),
            rtol=0, atol=1e-6)
        anchors = formats.load_int_image(os.path.join(port_dir,
                                                      s["pixel_anchors"]))
        assert (anchors[0] >= 0).sum() > 500
    # colour: the port's PNG, encoded as the JAX script encodes it (JPEG,
    # quality 95, through Pillow), gives the JAX script's image
    from PIL import Image

    for s, j in zip(st, sj):
        for key in ("source_color", "target_color"):
            png = read_png(os.path.join(port_dir, s[key]))
            assert png.shape == (64, 64, 3) and png.dtype == np.uint8
            again = os.path.join(port_dir, "again.jpg")
            Image.fromarray(png).save(again, quality=95)
            np.testing.assert_array_equal(
                np.asarray(Image.open(again)),
                np.asarray(Image.open(os.path.join(jax_dir, j[key]))))


@pytest.fixture
def small_deepdeform_cap(monkeypatch):
    """Both datasets pad the graph to 128 nodes instead of 1,024."""
    from occlusionfusion_tpu.data import deepdeform as DDJ
    from occlusionfusion_tpu_torch.data import deepdeform as DD

    for mod in (DDJ, DD):
        monkeypatch.setattr(mod, "DeepDeformConfig", functools.partial(
            mod.DeepDeformConfig, max_nodes=128))


@pytest.mark.parametrize("source", ["gt_flow", "flow_weights"])
def test_evaluate_deepdeform_matches_jax(exports, small_deepdeform_cap,
                                         source):
    from occlusionfusion_tpu_torch.scripts import evaluate_deepdeform

    root = exports[1]
    flag = (["--gt_flow"] if source == "gt_flow"
            else ["--flow_weights", FLOW_NPZ])
    local, _ = run_jax_script("evaluate_deepdeform",
                              ["--root", root] + EVAL_DD + flag)
    ref = local["main"]
    metrics, per = evaluate_deepdeform.main(["--root", root] + EVAL_DD
                                            + flag + CPU)
    assert metrics["samples"] == 2 and per["valid"] == ref["valid_solves"]
    np.testing.assert_allclose(per["graph_mm"], ref["graph_mm"], atol=1e-2)
    np.testing.assert_allclose(per["epe3d_mm"], ref["epe3d_mm"], atol=1e-2)
    np.testing.assert_allclose(per["epe2d_px"], ref["epe2d"], atol=1e-3)
    assert per["n_ok"][-1] == int(ref["ok"].sum()) > 256
    assert len(per["epe2d_px"]) == (2 if source == "flow_weights" else 0)


def _small_fusion(monkeypatch):
    """Both packages' FusionConfig at 32^3 voxels of 12 mm, 128 nodes and
    1,024 points, whatever the script asks for."""
    from occlusionfusion_tpu.fusion import pipeline as PJ
    from occlusionfusion_tpu_torch.fusion import pipeline as P

    for mod in (PJ, P):
        cls = mod.FusionConfig

        def small(*a, _cls=cls, **kw):
            return dataclasses.replace(
                _cls(*a, **kw), vol_dim=(32, 32, 32), voxel_size=0.012,
                max_nodes=128, max_points=1024)

        monkeypatch.setattr(mod, "FusionConfig", small)


@pytest.fixture(scope="module")
def dt4d_runs(tmp_path_factory):
    """(JAX locals of main, JAX step infos, port metrics, port details) of
    evaluate_dt4d on the limbs clip, and the trajectory file of JAX's
    estimated poses."""
    from occlusionfusion_tpu_torch.scripts import evaluate_dt4d

    with pytest.MonkeyPatch.context() as mp:
        _small_fusion(mp)
        local, rets = run_jax_script("evaluate_dt4d", CLIP,
                                     returns=("register_frame_fused",))
        metrics, details = evaluate_dt4d.main(CLIP + CPU)
    ref = local["main"]
    path = str(tmp_path_factory.mktemp("traj") / "trajectory.npz")
    np.savez(path, frame_ids=np.asarray(ref["est_ids"]),
             rotations=np.stack(ref["est_R"]),
             translations=np.stack(ref["est_t"]))
    infos = [np.asarray(r[1]) for r in rets["register_frame_fused"]]
    return ref, infos, metrics, details, path


def test_evaluate_dt4d_matches_jax(dt4d_runs):
    ref, infos, metrics, details, _ = dt4d_runs
    assert metrics["frames"] == 2 and metrics["valid_solve_ratio"] == 1.0
    assert metrics["nodes"] == int(ref["fusion"].node_count) > 20
    np.testing.assert_allclose(details["per_frame_epe"],
                               ref["per_frame_epe"], rtol=0, atol=1e-5)
    assert abs(details["ate_m"] - ref["ate"]) <= 1e-5
    assert abs(details["pose_ate_m"]
               - ref["pose_metrics"]["pose_ate_m"]) <= 1e-5
    assert details["n_correspondences"] == [int(i[1]) for i in infos]
    assert details["n_correspondences"][0] > 500


def test_evaluate_dt4d_scores_a_trajectory_as_jax(dt4d_runs):
    from occlusionfusion_tpu_torch.scripts import evaluate_dt4d

    path = dt4d_runs[4]
    argv = CLIP + ["--trajectory", path]
    local, _ = run_jax_script("evaluate_dt4d", argv)
    metrics, _ = evaluate_dt4d.main(argv + CPU)
    ref = local["main"]["metrics"]
    assert metrics["keyframes"] == ref["keyframes"] == 2
    assert abs(metrics["pose_ate_m"] - ref["pose_ate_m"]) <= 1e-6
    assert abs(metrics["rot_err_deg"] - ref["rot_err_deg"]) <= 1e-4


def test_visualize_demo_draws_what_jax_plots(tmp_path, monkeypatch):
    import chip_smoke as CS
    from mpl_toolkits.mplot3d import Axes3D

    from occlusionfusion_tpu_torch.scripts import run_demo, visualize_demo

    demo_in, demo_out = tmp_path / "in", tmp_path / "out"
    CS.cli_demo_dir(str(demo_in))
    run_demo.main(["--input", str(demo_in), "--output", str(demo_out),
                   "--frames", "2"] + CPU)
    calls = []
    for name in ("scatter", "quiver"):
        orig = getattr(Axes3D, name)

        def record(self, *a, _orig=orig, _name=name, **kw):
            calls.append((_name, [np.asarray(x) for x in a], kw))
            return _orig(self, *a, **kw)

        monkeypatch.setattr(Axes3D, name, record)
    argv = ["--input", str(demo_in), "--output", str(demo_out), "--frames",
            "1", "2"]
    run_jax_script("visualize_demo", argv + ["--out_dir",
                                             str(tmp_path / "viz_jax")])
    written = visualize_demo.main(argv + ["--out_dir",
                                          str(tmp_path / "viz")])
    assert len(calls) == 8  # 2 frames x 2 panels x (scatter, quiver)
    for f, frame in enumerate((1, 2)):
        panels = visualize_demo.panels(str(demo_in / "node"),
                                       str(demo_out / "node"), frame)
        for p, panel in enumerate(panels):
            (_, sc, skw), (_, qv, _) = calls[4 * f + 2 * p: 4 * f + 2 * p + 2]
            np.testing.assert_array_equal(np.stack(sc, -1), panel["points"])
            np.testing.assert_array_equal(
                np.asarray(skw["c"], np.float32), panel["values"])
            np.testing.assert_array_equal(np.stack(qv[:3], -1),
                                          panel["starts"])
            np.testing.assert_array_equal(np.stack(qv[3:], -1),
                                          panel["vectors"])
        assert 0 < len(panels[0]["starts"]) < len(panels[1]["starts"])
        img = read_png(written[f])
        assert img.shape == (440, 960, 3) and img.dtype == np.uint8
        assert len(np.unique(img.reshape(-1, 3), axis=0)) > 10
