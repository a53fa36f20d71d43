"""The port's utils/ against the JAX package's: each metric on the same
inputs, the PLY/OBJ writers byte for byte with the PLY reader's round
trip, the flow colour wheel, the headless mesh render (within one grey
level), the PNG writer against Pillow, PhaseTimer and device_trace; the
viz module imports where matplotlib is missing."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occlusionfusion_tpu.utils import metrics as MJ
from occlusionfusion_tpu.utils import viz as VJ

from occlusionfusion_tpu_torch.fusion.frame_loader import read_png, write_png
from occlusionfusion_tpu_torch.utils import metrics as MT
from occlusionfusion_tpu_torch.utils import viz as VT
from occlusionfusion_tpu_torch.utils.profiling import PhaseTimer, device_trace

from torch_port_impl import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    pred = rng.randn(64, 3).astype(np.float32) * 0.05
    gt = pred + rng.randn(64, 3).astype(np.float32) * 0.03
    mask = rng.rand(64) > 0.3
    return rng, pred, gt, mask


def _both(fn_name, *args, **kw):
    j = getattr(MJ, fn_name)(*(jnp.asarray(a) for a in args), **kw)
    t = getattr(MT, fn_name)(*(torch.from_numpy(np.asarray(a))
                               for a in args), **kw)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("name,kw", [
    ("epe_3d", {}), ("accuracy_at", {"threshold": 0.04}),
    ("nfmr", {}), ("nfmr", {"threshold": 0.02}),
])
def test_point_metrics(data, name, kw):
    _, pred, gt, mask = data
    j, t = _both(name, pred, gt, mask, **kw)
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_epe_2d(data):
    rng = data[0]
    pred, gt = rng.randn(2, 8, 8, 2).astype(np.float32)
    mask = rng.rand(8, 8) > 0.5
    j, t = _both("epe_2d", pred, gt, mask)
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_inlier_ratio(data):
    rng, pred, gt, _ = data
    ms = rng.randint(0, 64, 40).astype(np.int32)
    mt = rng.randint(0, 64, 40).astype(np.int32)
    valid = rng.rand(40) > 0.2
    j, t = _both("inlier_ratio", pred, gt, ms, mt, valid, threshold=0.1)
    np.testing.assert_allclose(t, j, rtol=1e-6)


@pytest.mark.parametrize("angle,shift", [(0.1, 0.05), (0.4, 0.05),
                                          (0.1, 0.3)])
def test_registration_recall(angle, shift):
    c, s = np.cos(angle), np.sin(angle)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    eye = np.eye(3, dtype=np.float32)
    t = np.asarray([shift, 0, 0], np.float32)
    z = np.zeros(3, np.float32)
    j, tt = _both("registration_recall", R, t, eye, z)
    assert bool(tt) == bool(j)


def test_valid_solve_ratio():
    flags = np.asarray([True, False, True, True])
    j, t = _both("valid_solve_ratio", flags)
    np.testing.assert_allclose(t, j)


def test_ply_and_obj_bytes_and_round_trip(tmp_path, data):
    rng = data[0]
    v = rng.randn(30, 3).astype(np.float32)
    f = rng.randint(0, 30, (20, 3))
    col = rng.randint(0, 256, (30, 3))
    for name, args in (("a.ply", (v, f)), ("b.ply", (v, None, col)),
                       ("c.ply", (v,))):
        VJ.save_ply(str(tmp_path / ("j" + name)), *args)
        VT.save_ply(str(tmp_path / ("t" + name)), *args)
        assert (tmp_path / ("t" + name)).read_bytes() == \
            (tmp_path / ("j" + name)).read_bytes()
    VJ.save_obj(str(tmp_path / "j.obj"), v, f)
    VT.save_obj(str(tmp_path / "t.obj"), v, f)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    back_v, back_f = VT.load_ply(str(tmp_path / "ta.ply"))
    np.testing.assert_array_equal(back_v, v)
    np.testing.assert_array_equal(back_f, f)
    assert VT.load_ply(str(tmp_path / "tc.ply"))[1] is None


def test_flow_to_color_and_meshes(data):
    rng = data[0]
    flow = rng.randn(16, 16, 2).astype(np.float32)
    np.testing.assert_array_equal(VT.flow_to_color(flow),
                                  VJ.flow_to_color(flow))
    np.testing.assert_array_equal(VT.flow_to_color(flow, max_norm=2.0),
                                  VJ.flow_to_color(flow, max_norm=2.0))
    nodes = rng.randn(6, 3).astype(np.float32)
    edges = np.asarray([[1, 2, -1], [0, 3, 4], [0, 5, -1], [1, -1, -1],
                        [1, 5, -1], [2, 4, -1]])
    for got, want in ((VT.graph_mesh(nodes, edges, nodes * 0.1),
                       VJ.graph_mesh(nodes, edges, nodes * 0.1)),
                      (VT.line_mesh(nodes, edges), VJ.line_mesh(nodes, edges))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_render_mesh_within_one_grey_level():
    g = np.linspace(-1, 1, 40, dtype=np.float32)
    u, v = np.meshgrid(g, g)
    pts = np.stack([u.ravel(), v.ravel(), 0.3 * (u * u + v * v).ravel()],
                   -1).astype(np.float32)
    kw = dict(image_hw=(48, 64), azimuth_deg=30.0)
    j, t = VJ.render_mesh(pts, **kw), VT.render_mesh(pts, **kw)
    assert t.dtype == np.uint8 and t.shape == (48, 64, 3)
    assert np.abs(t.astype(int) - j.astype(int)).max() <= 1


def test_png_writer_against_pillow(tmp_path, data):
    from PIL import Image

    rng = data[0]
    for img in (rng.randint(0, 65536, (5, 7)).astype(np.uint16),
                rng.randint(0, 256, (6, 4)).astype(np.uint8),
                rng.randint(0, 256, (3, 5, 3)).astype(np.uint8)):
        p = str(tmp_path / "x.png")
        write_png(p, img)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
        np.testing.assert_array_equal(read_png(p), img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "y.png"), np.zeros((2, 2), np.float32))


def test_phase_timer_and_trace(tmp_path):
    timer = PhaseTimer()
    for _ in range(2):
        with timer.span("a", sync=[torch.ones(3)]):
            torch.ones(4).sum()
    with timer.span("b") as box:
        box["sync"] = {"x": torch.zeros(2)}
    assert timer.counts == {"a": 2, "b": 1}
    assert "n=2" in timer.summary()
    timer.reset()
    assert not timer.totals
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).cumsum(0)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_viz_imports_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    mod = importlib.reload(VT)
    assert mod.flow_to_color(np.ones((2, 2, 2), np.float32)).shape == (2, 2, 3)
    with pytest.raises(ImportError):
        mod.plot_depth("x.png", np.zeros((2, 2)))
