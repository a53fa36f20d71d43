"""The port's data/ modules against the JAX package's: the same seeds give
the same arrays, bit for bit (where the JAX module takes an SVD the
port's Kabsch differs at f32 rounding, stated below), and files written
by either package read back in the other."""

import os
import sys
from argparse import Namespace

import numpy as np
import pytest

from occlusionfusion_tpu.data import deformingthings4d as JD
from occlusionfusion_tpu.data import formats as JF
from occlusionfusion_tpu.data import synthetic_shapes as JS
from occlusionfusion_tpu.geometry.camera import Intrinsics as JIntrinsics

from occlusionfusion_tpu_torch.data import deformingthings4d as PD
from occlusionfusion_tpu_torch.data import formats as PF
from occlusionfusion_tpu_torch.data import synthetic_shapes as PS
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

from torch_port_impl import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            equal_trees(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            equal_trees(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", ["blob", "limbs", "arms"])
def test_shape_clip_and_labels_bitwise(shape):
    kw = dict(n_frames=5, n_verts=400, seed=3, rotate_deg=2.0,
              rotate_osc_deg=10.0)
    equal_trees(JS.shape_clip(shape, **kw), PS.shape_clip(shape, **kw))
    verts = PS.shape_clip(shape, **kw)[0]
    equal_trees(JS.surface_labels(shape, verts),
                PS.surface_labels(shape, verts))


@pytest.mark.parametrize("kind", ["static", "truck_return", "orbit_return"])
def test_camera_path_bitwise(kind):
    equal_trees(JS.camera_path(kind, 7), PS.camera_path(kind, 7))


def test_np_render_and_rendered_flow_pair_bitwise():
    verts = PS.shape_clip("limbs", 3, 600, seed=1)[0] + np.float32([0, 0, 1.5])
    colors = PD.procedural_vertex_colors(verts)
    intr = Intrinsics(np.float32(120.0), np.float32(120.0), np.float32(24.0),
                      np.float32(20.0))
    equal_trees(JS.np_render(verts, colors, intr, (40, 48)),
                PS.np_render(verts, colors, intr, (40, 48)))
    kw = dict(H=48, W=48, n_verts=800, n_frames=6)
    equal_trees(JS.rendered_flow_pair(np.random.RandomState(5), **kw),
                PS.rendered_flow_pair(np.random.RandomState(5), **kw))


@pytest.fixture(scope="module")
def anime_path(tmp_path_factory):
    verts, faces, offs = JS.shape_clip("arms", 4, 700, seed=2)
    faces = np.random.RandomState(0).randint(0, 700, (50, 3)).astype(np.int32)
    path = str(tmp_path_factory.mktemp("anime") / "clip.anime")
    JD.save_anime(path, verts, faces, offs)
    return path


def test_anime_files_both_ways(anime_path, tmp_path):
    equal_trees(JD.load_anime(anime_path), PD.load_anime(anime_path))
    back = str(tmp_path / "back.anime")
    PD.save_anime(back, *PD.load_anime(anime_path))
    assert open(back, "rb").read() == open(anime_path, "rb").read()


def test_anime_rendering_bitwise(anime_path):
    j_intr = JIntrinsics(100.0, 100.0, 32.0, 24.0)
    p_intr = Intrinsics(100.0, 100.0, 32.0, 24.0)
    poses = JS.camera_path("orbit_return", 4, orbit_deg=15.0)
    kw = dict(image_hw=(48, 64), max_frames=3, camera_poses=poses)
    equal_trees(JD.anime_to_depth_sequence(anime_path, j_intr, **kw),
                PD.anime_to_depth_sequence(anime_path, p_intr, device="cpu",
                                           **kw))
    equal_trees(JD.anime_to_rgbd_sequence(anime_path, j_intr, **kw),
                PD.anime_to_rgbd_sequence(anime_path, p_intr, device="cpu",
                                          **kw))


FORMATS = [
    ("flow", np.float32, (2, 5, 7)),
    ("graph_nodes", np.float32, (6, 3)),
    ("graph_edges", np.int32, (6, 4)),
    ("graph_edges_weights", np.float32, (6, 4)),
    ("graph_clusters", np.int32, (6, 1)),
    ("float_image", np.float32, (3, 5, 7)),
    ("int_image", np.int32, (2, 5, 7)),
]


@pytest.mark.parametrize("name,dtype,shape", FORMATS)
def test_formats_both_ways(name, dtype, shape, tmp_path):
    a = (np.random.RandomState(0).randn(*shape) * 10).astype(dtype)
    pj, pp = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    getattr(JF, f"save_{name}")(pj, a)
    getattr(PF, f"save_{name}")(pp, a)
    assert open(pj, "rb").read() == open(pp, "rb").read()
    np.testing.assert_array_equal(getattr(PF, f"load_{name}")(pj), a)
    np.testing.assert_array_equal(getattr(JF, f"load_{name}")(pp), a)


def test_clip_to_training_samples(tmp_path):
    """On a marching-cubes blob clip (train_motion's writer): the draws,
    the graph and its padded pyramid bit for bit; the motion fields
    (through the rigid factor: the JAX module's SVD Kabsch, the port's
    Horn form) within 2e-4 of JAX's in normalized units: an f32 ulp of R
    (~1e-7) moves a node 1.5 m from the camera by ~1.5e-5 cm, which the
    sigma normalization (std ~0.2 cm here) scales to ~1e-4."""
    from occlusionfusion_tpu.data.motion_clips import (
        MotionClipConfig as JC,
        clip_to_training_samples as jclip,
    )
    from occlusionfusion_tpu_torch.data.motion_clips import (
        MotionClipConfig,
        clip_to_training_samples,
    )

    from occlusionfusion_tpu_torch.scripts.train_motion import (
        make_synthetic_clip,
    )

    anime_path = make_synthetic_clip(str(tmp_path / "blob.anime"), seed=7,
                                     n_frames=4)
    js, jg = jclip(anime_path, JC(), seed=4)
    ps, pg = clip_to_training_samples(anime_path, MotionClipConfig(), seed=4)
    assert len(pg.node_indices) > 8
    np.testing.assert_array_equal(jg.node_indices, pg.node_indices)
    assert len(js) == len(ps) == 3
    for j, p in zip(js, ps):
        for f in ("pos", "history_len", "node_mask"):
            equal_trees(getattr(j, f), getattr(p, f))
        equal_trees(tuple(j.pyramid), tuple(p.pyramid))
        np.testing.assert_array_equal(np.asarray(j.curr_motion)[:, 3],
                                      p.curr_motion[:, 3])
        for f in ("curr_motion", "gt_motion", "history"):
            np.testing.assert_allclose(getattr(p, f), np.asarray(getattr(j, f)),
                                       atol=2e-4, rtol=0)


@pytest.fixture(scope="module")
def dd_root(tmp_path_factory):
    sys.path.insert(0, REPO)
    from scripts.export_deepdeform import export

    out = str(tmp_path_factory.mktemp("dd"))
    export(Namespace(out=out, shape="limbs", frames=3, height=64, width=64,
                     fx=150.0, verts=1500, seed=0, rotate_deg=3.0,
                     splat_radius=2, node_coverage=0.05, split="train"))
    return out


def test_deepdeform_dataset_on_exported_files(dd_root):
    from occlusionfusion_tpu.data.deepdeform import (
        DeepDeformConfig as JCfg,
        DeepDeformDataset as JDS,
    )
    from occlusionfusion_tpu_torch.data.deepdeform import (
        DeepDeformConfig,
        DeepDeformDataset,
    )

    jds = JDS(dd_root, "train", JCfg(image_height=64, image_width=64))
    pds = DeepDeformDataset(dd_root, "train",
                            DeepDeformConfig(image_height=64, image_width=64))
    assert len(pds) == len(jds) == 2
    for i in range(len(pds)):
        equal_trees(jds[i], pds[i])


def test_fourdmatch_dataset_on_written_files(tmp_path):
    from occlusionfusion_tpu.data.fourdmatch import (
        FourDMatchConfig as JCfg,
        FourDMatchDataset as JDS,
    )
    from occlusionfusion_tpu_torch.data.fourdmatch import (
        FourDMatchConfig,
        FourDMatchDataset,
    )

    rng = np.random.RandomState(0)
    for i in range(2):
        os.makedirs(tmp_path / "train" / f"s{i}", exist_ok=True)
        np.savez(tmp_path / "train" / f"s{i}" / "pair.npz",
                 s_pc=rng.randn(90, 3), t_pc=rng.randn(70, 3),
                 correspondences=rng.randint(0, 60, (40, 2)),
                 rot=np.eye(3), trans=rng.randn(3, 1),
                 s2t_flow=rng.randn(90, 3))
    j = JDS(str(tmp_path), "train", JCfg(max_points=64,
                                          max_correspondences=32))
    p = FourDMatchDataset(str(tmp_path), "train",
                          FourDMatchConfig(max_points=64,
                                           max_correspondences=32))
    assert len(p) == len(j) == 2
    for i in range(2):
        equal_trees(j[i], p[i])
