"""The port's inference CLIs (``python -m occlusionfusion_tpu_torch.scripts.*``,
run in-process with ``--device cpu``) against the JAX package's scripts
(in-process through runpy, as tests/test_cli.py runs them) on the same
files, at tests/test_cli.py's sizes: convert_dt4d, run_fusion (fused
N-ICP, the object engine with gn_dense, --save_state and
--resume_state), register_pair with both solvers, run_demo and
convert_checkpoint; ``--device cuda`` without a card fails."""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from occlusionfusion_tpu_torch.fusion.frame_loader import read_png
from occlusionfusion_tpu_torch.scripts import (
    convert_checkpoint,
    convert_dt4d,
    register_pair,
    run_demo,
    run_fusion,
)
from occlusionfusion_tpu_torch.utils.viz import load_ply

from torch_port_impl import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RT_ATOL = 1e-4  # test_torch_stepwise.RT_ATOL
# the motion GNN's documented cross-backend drift (0.35 mm, 0.015)
DEMO_MOTION_TOL, DEMO_CONF_TOL = 3.5e-4, 0.015
FUSION_ARGS = ["--voxel_dim", "48", "--voxel_size", "0.006",
               "--node_coverage", "0.03", "--nicp_iters", "40",
               "--max_nodes", "256", "--max_points", "2048",
               "--no_motion_model"]
COUNTS = ("n_correspondences", "n_visible_nodes")
MESH_SHARE = 0.999


def run_jax_script(name, argv):
    old = sys.argv
    sys.argv = [name] + argv
    try:
        runpy.run_path(os.path.join(REPO, "scripts", name),
                       run_name="__main__")
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


@pytest.fixture(scope="module")
def clip(work):
    """tests/test_cli.py's clip: a marching-cubes sphere translating 2 mm
    a frame, 6 frames."""
    from occlusionfusion_tpu_torch.data.deformingthings4d import save_anime
    from occlusionfusion_tpu_torch.graph import native

    n = 20
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    sdf = np.linalg.norm(g - (n - 1) / 2.0, axis=0) - 6.0
    verts, faces = native.marching_cubes(sdf)
    verts = (verts * 0.02).astype(np.float32)
    offs = np.stack([np.full((len(verts), 3), 0.002 * f, np.float32)
                     for f in range(1, 6)])
    path = str(work / "c.anime")
    save_anime(path, verts, faces, offs)
    return path, verts, faces, offs


@pytest.fixture(scope="module")
def seqs(work, clip):
    convert = ["--anime", clip[0], "--height", "96", "--width", "96",
               "--fx", "180"]
    jax_dir, port_dir = str(work / "seq_jax"), str(work / "seq_port")
    run_jax_script("convert_dt4d.py", convert + ["--out", jax_dir])
    convert_dt4d.main(convert + ["--out", port_dir, "--device", "cpu"])
    return jax_dir, port_dir


def test_convert_dt4d_frames_equal(seqs):
    jax_dir, port_dir = seqs
    names = sorted(os.listdir(os.path.join(jax_dir, "depth")))
    assert len(names) == 6
    assert names == sorted(os.listdir(os.path.join(port_dir, "depth")))
    for name in names:
        np.testing.assert_array_equal(
            read_png(os.path.join(port_dir, "depth", name)),
            read_png(os.path.join(jax_dir, "depth", name)))
        grey = read_png(os.path.join(port_dir, "color", name))
        assert grey.shape == (96, 96, 3) and (grey == 128).all()
    np.testing.assert_allclose(
        np.loadtxt(os.path.join(port_dir, "intrinsics.txt")),
        np.loadtxt(os.path.join(jax_dir, "intrinsics.txt")))
    np.testing.assert_array_equal(
        np.load(os.path.join(port_dir, "gt_vertices.npy")),
        np.load(os.path.join(jax_dir, "gt_vertices.npy")))


def _fusion_pair(work, seqs, tag, extra):
    """Both run_fusion CLIs on the port's sequence (both packages read its
    PNGs) with ``extra`` flags -> (jax results dir, port results dir)."""
    seq = seqs[1]
    out_j, out_t = str(work / f"{tag}_jax"), str(work / f"{tag}_port")
    run_jax_script("run_fusion.py", ["--datadir", seq, "--results", out_j]
                   + FUSION_ARGS + extra)
    run_fusion.main(["--datadir", seq, "--results", out_t, "--device", "cpu"]
                    + FUSION_ARGS + extra)
    return out_j, out_t


def _check_fusion_outputs(out_j, out_t, node_files):
    for name in node_files:
        np.testing.assert_allclose(np.load(os.path.join(out_t, name)),
                                   np.load(os.path.join(out_j, name)),
                                   atol=RT_ATOL)
    with open(os.path.join(out_j, "convergence.json")) as fh:
        conv_j = json.load(fh)
    with open(os.path.join(out_t, "convergence.json")) as fh:
        conv_t = json.load(fh)
    assert [[r[k] for k in COUNTS] for r in conv_t] == \
        [[r[k] for k in COUNTS] for r in conv_j]
    vj, _ = load_ply(os.path.join(out_j, "final_mesh.ply"))
    vt, _ = load_ply(os.path.join(out_t, "final_mesh.ply"))
    # held as point sets, each vertex to the other mesh's nearest, both
    # ways: a TSDF value at the zero crossing that differs in the last
    # bits adds or drops a vertex (the object engine: 7,129 vertices
    # against JAX's 7,131), and a vertex whose 4th and 5th nearest nodes
    # tie takes another anchor set (one of 10,495 moved 6.2 mm in a fused
    # gn_dense run: nodes at 0.11484972 m and 0.11484973 m). All
    # but such vertices are held as the transforms are.
    for a, b in ((vt, vj), (vj, vt)):
        err, _ = cKDTree(b).query(a)
        assert np.mean(err <= RT_ATOL) >= MESH_SHARE, np.sort(err)[-10:]


def test_run_fusion_fused(work, seqs):
    out_j, out_t = _fusion_pair(work, seqs, "fused", ["--end_frame", "3"])
    _check_fusion_outputs(out_j, out_t, ["deformed_nodes_final.npy"])


def test_run_fusion_object_gn_dense_save_and_resume(work, seqs):
    """The object engine with --solver gn_dense to frame 1 with
    --save_state, then each package resumed from its own snapshot to
    frame 2."""
    common = ["--datadir", seqs[1], "--engine", "object", "--solver",
              "gn_dense"] + FUSION_ARGS
    outs = []
    for tag, run, extra in (
            ("jax", lambda a: run_jax_script("run_fusion.py", a), []),
            ("port", run_fusion.main, ["--device", "cpu"])):
        out, state = str(work / f"object_{tag}"), str(work / f"{tag}.npz")
        run(common + extra + ["--results", out, "--end_frame", "2",
                              "--save_state", state])
        run(common + extra + ["--results", out, "--end_frame", "3",
                              "--resume_state", state])
        outs.append(out)
    _check_fusion_outputs(*outs, ["deformed_nodes_000001.npy",
                                  "deformed_nodes_000002.npy"])


@pytest.fixture(scope="module")
def pair_files(work, clip):
    """tests/test_cli.py's random cloud and its shifted copy as npz, and
    the clip's frame-0 and frame-2 meshes as PLY."""
    from occlusionfusion_tpu_torch.utils.viz import save_ply

    rng = np.random.RandomState(0)
    src = rng.randn(400, 3).astype(np.float32) * 0.2
    tgt = (src + np.asarray([0.01, 0.0, 0.02], np.float32)).astype(np.float32)
    files = {k: str(work / f"{k}.npz") for k in ("s", "t")}
    np.savez(files["s"], points=src)
    np.savez(files["t"], points=tgt)
    _, verts, faces, offs = clip
    for k, v in (("s_mesh", verts), ("t_mesh", verts + offs[1])):
        files[k] = str(work / f"{k}.ply")
        save_ply(files[k], v, faces)
    return files


# N-ICP on the meshes (geodesic edges), GN on the cloud (k-NN edges). On
# tests/test_cli.py's cloud (156 nodes over 400 points) N-ICP is
# ill-conditioned: Adam's first steps on near-zero gradients amplify
# float noise, so that JAX's own warped points move by 5.1e-4 m when the
# targets are scaled by 1 + 1e-7 (the port lands 1.5e-4 m from JAX's).
@pytest.mark.parametrize("solver,inputs,extra", [
    ("nicp", ("s_mesh", "t_mesh"), ["--node_coverage", "0.05", "--iters",
                                    "80", "--lr", "0.02"]),
    ("gn_dense", ("s", "t"), ["--node_coverage", "0.1"]),
])
def test_register_pair(work, pair_files, solver, inputs, extra):
    args = ["--source", pair_files[inputs[0]], "--target",
            pair_files[inputs[1]], "--solver", solver] + extra
    out_j, out_t = str(work / f"{solver}_jax.ply"), str(work / f"{solver}.ply")
    run_jax_script("register_pair.py", args + ["--out", out_j])
    register_pair.main(args + ["--out", out_t, "--device", "cpu"])
    wj, fj = load_ply(out_j)
    wt, ft = load_ply(out_t)
    np.testing.assert_allclose(wt, wj, atol=RT_ATOL)
    if solver == "nicp":
        np.testing.assert_array_equal(ft, fj)
    else:
        assert ft is None and fj is None


@pytest.fixture(scope="module")
def demo_dir(work):
    """Three frames of node/graph files at the demo caps (512, 128, 32,
    32), their pyramid drawn as __graft_entry__._demo_scale_inputs draws
    it, with random motion and visibility."""
    rng = np.random.RandomState(0)
    sizes, ks = [227, 55, 17, 6], (8, 6, 4, 3)
    root = work / "demo_in"
    for sub in ("node", "graph"):
        (root / sub).mkdir(parents=True)
    pos = rng.randn(sizes[0], 3).astype(np.float32) * 0.2
    for f in range(1, 4):
        nn = [rng.randint(0, sizes[l], size=(sizes[l], ks[l])).astype(np.int16)
              for l in range(4)]
        down = [np.sort(rng.choice(sizes[l], size=sizes[l + 1],
                                   replace=False)).astype(np.int16)
                for l in range(3)]
        up = [rng.randint(0, sizes[l + 1], size=sizes[l]).astype(np.int16)
              for l in range(3)]
        np.savez(root / "graph" / f"{f:04d}.npz",
                 **{f"nn_index_l{l}": nn[l] for l in range(4)},
                 **{f"down_sample_idx{i + 1}": down[i] for i in range(3)},
                 **{f"up_sample_idx{i + 1}": up[i] for i in range(3)})
        motion = rng.randn(sizes[0], 3).astype(np.float32) * 0.01
        visible = (rng.rand(sizes[0], 1) > 0.3).astype(np.float32)
        np.save(root / "node" / f"{f:04d}.npy",
                np.hstack([pos + 0.002 * f, motion, visible]))
    return str(root)


def test_run_demo(work, demo_dir):
    weights = os.path.join(REPO, "checkpoints", "motion_complete.npz")
    out_j, out_t = str(work / "demo_jax"), str(work / "demo_port")
    run_jax_script("run_demo.py", ["--input", demo_dir, "--output", out_j,
                                   "--weights", weights])
    run_demo.main(["--input", demo_dir, "--output", out_t, "--device",
                   "cpu"])
    for f in range(1, 4):
        j = np.load(os.path.join(out_j, "node", f"{f:04d}.npy"))
        t = np.load(os.path.join(out_t, "node", f"{f:04d}.npy"))
        np.testing.assert_allclose(t[:, :3], j[:, :3], atol=DEMO_MOTION_TOL)
        np.testing.assert_allclose(t[:, 3], j[:, 3], atol=DEMO_CONF_TOL)


def test_convert_checkpoint_round_trip(work):
    src = os.path.join(REPO, "checkpoints", "motion_complete.npz")
    data = np.load(src)
    tar = str(work / "model.tar")
    torch.save({"model_state_dict": {k: torch.from_numpy(data[k])
                                     for k in data.files}}, tar)
    out = str(work / "converted.npz")
    convert_checkpoint.main([tar, out])
    back = np.load(out)
    assert sorted(back.files) == sorted(data.files)
    for k in data.files:
        np.testing.assert_array_equal(back[k], data[k])
        assert back[k].dtype == data[k].dtype


@pytest.mark.parametrize("module,argv", [
    (convert_dt4d, ["--anime", "x.anime", "--out", "seq"]),
    (run_fusion, ["--datadir", "seq"]),
    (register_pair, ["--source", "s.npz", "--target", "t.npz"]),
    (run_demo, []),
])
def test_cuda_without_a_card_fails(monkeypatch, module, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(argv + ["--device", "cuda"])


def test_flow_checkpoint_without_masknet(work):
    """run_fusion's --flow_weights takes a checkpoint of train_flow
    without --with_mask (the JAX script reads its "mask" as optional)."""
    from occlusionfusion_tpu_torch.models.checkpoint import load_flow_nets

    data = np.load(os.path.join(REPO, "checkpoints", "flow.npz"))
    path = str(work / "pwc_only.npz")
    np.savez(path, **{k: data[k] for k in data.files
                      if not k.startswith("mask/")})
    pwc, mask = load_flow_nets(path, device="cpu")
    assert mask is None and not pwc.training
