"""The port's remaining public host and library functions against the JAX
package on the CPU, on the same seeded numpy inputs, at the JAX suite's
tolerances: se3_exp and the quaternion maps (tests/test_geometry.py,
1e-6/1e-5), unweighted kabsch (1e-5), ed_warp_normals (1e-6),
deform_normals and from_origin_form (tests/test_tsdf.py, 1e-6/1e-5), the
segment sums and means (1e-5), radius_neighbors (equal), the per-node
predicted locations (1e-6), skinning_weights at JAX's defaults (equal
anchors, weights 1e-6), pixel anchors (euclidean: equal anchors, weights
1e-6; geodesic: equal), mask_gt and deformed_gt_points (equal), the
depth-route and regular-grid graphs (equal arrays), and the PNG
decoder's Adam7 interlacing (grey8, grey16, RGB8, RGBA8; each read equal
to its non-interlaced twin)."""

import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occlusionfusion_tpu.fusion import flow_correspondence as FCJ
from occlusionfusion_tpu.fusion import warpfield as WJ
from occlusionfusion_tpu.geometry import edwarp as EWJ
from occlusionfusion_tpu.geometry.kabsch import kabsch as kabsch_j
from occlusionfusion_tpu.geometry import skinning as SKJ
from occlusionfusion_tpu.geometry import so3 as SO3J
from occlusionfusion_tpu.geometry.camera import Intrinsics as IntrJ
from occlusionfusion_tpu.graph import edgraph as EGJ
from occlusionfusion_tpu.graph import pixel_anchors as PAJ
from occlusionfusion_tpu.ops import gt_helpers as GTJ
from occlusionfusion_tpu.ops import knn as KNNJ
from occlusionfusion_tpu.ops import segment_ops as SEGJ
from occlusionfusion_tpu_torch.fusion import flow_correspondence as FC
from occlusionfusion_tpu_torch.fusion import warpfield as W
from occlusionfusion_tpu_torch.fusion.frame_loader import read_png
from occlusionfusion_tpu_torch.geometry import edwarp as EW
from occlusionfusion_tpu_torch.geometry.kabsch import kabsch
from occlusionfusion_tpu_torch.geometry import skinning as SK
from occlusionfusion_tpu_torch.geometry import so3 as SO3
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.graph import edgraph as EG
from occlusionfusion_tpu_torch.graph import pixel_anchors as PA
from occlusionfusion_tpu_torch.ops import gt_helpers as GT
from occlusionfusion_tpu_torch.ops import knn as KNN
from occlusionfusion_tpu_torch.ops import segment_ops as SEG
from torch_port_impl import one_torch_thread, random_pose_field, tt  # noqa: F401


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_se3_exp_matches_jax():
    rng = np.random.RandomState(0)
    xi = rng.randn(64, 6).astype(np.float32) * 0.5
    xi[:8, :3] *= 1e-5  # the small-angle branches
    xi[8, :3] = 0.0
    R_j, t_j = SO3J.se3_exp(jnp.asarray(xi))
    R_t, t_t = SO3.se3_exp(tt(xi))
    np.testing.assert_allclose(_np(R_t), _np(R_j), atol=1e-6)
    np.testing.assert_allclose(_np(t_t), _np(t_j), atol=1e-6)


def test_quaternion_maps_match_jax():
    rng = np.random.RandomState(1)
    q = rng.randn(64, 4).astype(np.float32)
    np.testing.assert_allclose(
        _np(SO3.quaternion_to_matrix(tt(q))),
        _np(SO3J.quaternion_to_matrix(jnp.asarray(q))), atol=1e-6)
    R, _ = random_pose_field(60, seed=2, rot=2.5)
    # rotations by ~pi about each axis take the x, y and z pivots
    R = np.concatenate([R, np.diag([1.0, -1.0, -1.0])[None],
                        np.diag([-1.0, 1.0, -1.0])[None],
                        np.diag([-1.0, -1.0, 1.0])[None],
                        np.eye(3)[None]]).astype(np.float32)
    q_j = _np(SO3J.matrix_to_quaternion(jnp.asarray(R)))
    q_t = _np(SO3.matrix_to_quaternion(tt(R)))
    np.testing.assert_allclose(q_t, q_j, atol=1e-5)
    np.testing.assert_allclose(_np(SO3.quaternion_to_matrix(tt(q_t))), R,
                               atol=1e-5)


def test_unweighted_kabsch_matches_jax():
    rng = np.random.RandomState(3)
    (R, t) = random_pose_field(1, seed=4, rot=0.8, trans=0.3)
    src = rng.randn(4, 50, 3).astype(np.float32)
    dst = (src @ R[0].T + t[0] + rng.randn(4, 50, 3) * 1e-3).astype(
        np.float32)
    R_j, t_j = kabsch_j(jnp.asarray(src), jnp.asarray(dst))
    R_t, t_t = kabsch(tt(src), tt(dst))
    np.testing.assert_allclose(_np(R_t), _np(R_j), atol=1e-5)
    np.testing.assert_allclose(_np(t_t), _np(t_j), atol=1e-5)


def _skin_inputs(seed, P=300, N=40, k=4):
    rng = np.random.RandomState(seed)
    R, t = random_pose_field(N, seed=seed + 1)
    anchors = rng.randint(0, N, (P, k)).astype(np.int32)
    w = rng.rand(P, k).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    normals = rng.randn(P, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return R, t, anchors, w, normals


@pytest.mark.parametrize("renormalize", [True, False])
def test_ed_warp_normals_matches_jax(renormalize):
    R, _, anchors, w, n = _skin_inputs(5)
    ref = EWJ.ed_warp_normals(*(jnp.asarray(a) for a in (n, R, anchors, w)),
                              renormalize=renormalize)
    got = EW.ed_warp_normals(tt(n), tt(R), tt(anchors), tt(w),
                             renormalize=renormalize)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-6)


def test_deform_normals_and_origin_form_match_jax():
    R, t, anchors, w, n = _skin_inputs(6)
    nodes = np.random.RandomState(7).randn(len(R), 3).astype(np.float32)
    valid = np.random.RandomState(8).rand(len(n)) > 0.3
    node_valid = np.ones(len(R), bool)
    ref = WJ.deform_normals(
        WJ.WarpFieldState(*(jnp.asarray(a) for a in (nodes, node_valid, R,
                                                      t))),
        jnp.asarray(n), WJ.SkinTable(*(jnp.asarray(a) for a in (anchors, w,
                                                                 valid))))
    got = W.deform_normals(
        W.WarpFieldState(*(tt(a) for a in (nodes, node_valid, R, t))),
        tt(n), W.SkinTable(*(tt(a) for a in (anchors, w, valid))))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-6)
    np.testing.assert_array_equal(_np(got)[~valid], n[~valid])
    t_origin = (t + nodes - np.einsum("nij,nj->ni", R, nodes)).astype(
        np.float32)
    R_j, t_j = WJ.from_origin_form(*(jnp.asarray(a) for a in (nodes, R,
                                                               t_origin)))
    R_t, t_t = W.from_origin_form(tt(nodes), tt(R), tt(t_origin))
    np.testing.assert_array_equal(_np(R_t), _np(R_j))
    np.testing.assert_allclose(_np(t_t), _np(t_j), atol=1e-6)
    np.testing.assert_allclose(_np(t_t), t, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_sums_and_means_match_jax(masked):
    rng = np.random.RandomState(9)
    E, C, N = 500, 5, 37
    values = rng.randn(E, C).astype(np.float32)
    weights = rng.rand(E).astype(np.float32)
    ids = rng.randint(0, N - 3, E).astype(np.int32)  # 3 empty segments
    mask = rng.rand(E) > 0.4 if masked else None
    ref = SEGJ.segment_weighted_sum(jnp.asarray(values), jnp.asarray(weights),
                                    jnp.asarray(ids), N)
    got = SEG.segment_weighted_sum(tt(values), tt(weights), tt(ids), N)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5)
    ref = SEGJ.segment_mean(jnp.asarray(values), jnp.asarray(ids), N,
                            None if mask is None else jnp.asarray(mask))
    got = SEG.segment_mean(tt(values), tt(ids), N,
                           None if mask is None else tt(mask))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5)


@pytest.mark.parametrize("max_k", [6, 40])
def test_radius_neighbors_matches_jax(max_k):
    rng = np.random.RandomState(10)
    q = rng.rand(200, 3).astype(np.float32)
    r = rng.rand(30, 3).astype(np.float32)
    q_valid = rng.rand(200) > 0.2
    r_valid = rng.rand(30) > 0.2
    ref = KNNJ.radius_neighbors(jnp.asarray(q), jnp.asarray(r), 0.25, max_k,
                                jnp.asarray(q_valid), jnp.asarray(r_valid))
    got = KNN.radius_neighbors(tt(q), tt(r), 0.25, max_k, tt(q_valid),
                               tt(r_valid))
    assert got.dtype == torch.int32 and got.shape == (200, max_k)
    np.testing.assert_array_equal(_np(got), _np(ref))
    assert 0 < (_np(got) < 30).sum() < (_np(got) >= 0).sum()


def test_predicted_node_locations_match_jax():
    rng = np.random.RandomState(11)
    H, Wd, K, N = 12, 15, 4, 20
    targets = rng.randn(H, Wd, 3).astype(np.float32)
    valid = rng.rand(H, Wd) > 0.3
    anchors = rng.randint(-1, N - 4, (H, Wd, K)).astype(np.int32)
    weights = rng.rand(H, Wd, K).astype(np.float32)
    ref = FCJ.predicted_node_locations(
        *(jnp.asarray(a) for a in (targets, valid, anchors, weights)), N)
    got = FC.predicted_node_locations(tt(targets), tt(valid), tt(anchors),
                                      tt(weights), N)
    np.testing.assert_array_equal(_np(got[1]), _np(ref[1]))
    assert not _np(got[1])[-4:].any()
    np.testing.assert_allclose(_np(got[0]), _np(ref[0]), atol=1e-6)


def _assert_anchors_match(a_t, w_t, a_j, w_j, atol=1e-6):
    np.testing.assert_array_equal(_np(a_t), _np(a_j))
    np.testing.assert_allclose(_np(w_t), _np(w_j), rtol=0, atol=atol)


@pytest.mark.parametrize("cutoff", [4.0, 1.5])
def test_skinning_weights_at_jax_defaults(cutoff):
    """The JAX defaults (any surviving anchor, 1e-12) and a narrow cutoff
    that leaves points with some anchors out of range."""
    rng = np.random.RandomState(12)
    q = rng.rand(400, 3).astype(np.float32)
    nodes = rng.rand(50, 3).astype(np.float32)
    valid = rng.rand(50) > 0.1
    a_j, w_j, ok_j = SKJ.skinning_weights(
        jnp.asarray(q), jnp.asarray(nodes), jnp.asarray(valid), 0.08,
        cutoff_sigmas=cutoff)
    a_t, w_t, ok_t = SK.skinning_weights(tt(q), tt(nodes), tt(valid), 0.08,
                                         cutoff_sigmas=cutoff)
    np.testing.assert_array_equal(_np(ok_t), _np(ok_j))
    _assert_anchors_match(a_t, w_t, a_j, w_j)
    if cutoff < 2:
        w = _np(w_t)
        assert ((w > 0).sum(1) < 4)[_np(ok_t)].any()


INTR = (120.0, 120.0, 24.0, 20.0)


def _point_image(h=40, w=48, seed=13):
    """A wavy surface at ~1 m with a hole and a far step, [h, w, 3]."""
    rng = np.random.RandomState(seed)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 1.0 + 0.05 * np.sin(u / 7.0) * np.cos(v / 5.0)
    z[:, w * 3 // 4:] += 0.3  # a depth step the mesh must not bridge
    z[9:19, 10:24] = 0.0  # a hole
    z += rng.randn(h, w).astype(np.float32) * 1e-4
    fx, fy, cx, cy = INTR
    return np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z],
                    -1).astype(np.float32)


def test_pixel_anchors_euclidean_matches_jax():
    pts = _point_image()
    g = EGJ.build_graph_from_depth(pts, EGJ.GraphConfig(
        node_coverage=0.03, max_triangle_edge=0.05))
    node_valid = np.ones(len(g.nodes), bool)
    node_valid[::5] = False
    for nv in (None, node_valid):
        a_j, w_j = PAJ.pixel_anchors_euclidean(pts, g.nodes, nv, 0.03)
        a_t, w_t = PA.pixel_anchors_euclidean(pts, g.nodes, nv, 0.03,
                                              device="cpu")
        assert a_t.shape == (40, 48, 4) and a_t.dtype == np.int32
        _assert_anchors_match(a_t, w_t, a_j, w_j)
        assert 0 < (a_t[..., 0] >= 0).sum() < 40 * 48


def test_pixel_anchors_geodesic_matches_jax():
    pts = _point_image()
    ids = np.asarray([0, 130, 400, 777, 1100, 1500], np.int32)
    ref = PAJ.pixel_anchors_geodesic(pts, 0.05, ids, 0.05, k=3)
    got = PA.pixel_anchors_geodesic(pts, 0.05, ids, 0.05, k=3)
    for a, b in zip(got[:2] + got[2], ref[:2] + ref[2]):
        np.testing.assert_array_equal(a, b)
    assert (got[0][..., 0] >= 0).sum() > 200


def test_gt_helpers_match_jax():
    src = _point_image()
    rng = np.random.RandomState(14)
    flow = np.zeros_like(src)
    flow[..., 2] = 0.02
    flow[..., :2] = rng.randn(*src.shape[:2], 2) * 0.004
    tgt = _point_image(seed=15)
    tgt[..., 2] = np.where(tgt[..., 2] > 0, tgt[..., 2] + 0.02, 0.0)
    tgt[25:30] = 0.0
    intr_j = IntrJ(*(np.float32(x) for x in INTR))
    intr_t = Intrinsics(*(float(np.float32(x)) for x in INTR))
    ref = GTJ.deformed_gt_points(jnp.asarray(src), jnp.asarray(flow))
    got = GT.deformed_gt_points(tt(src), tt(flow))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), _np(b))
    for diff in (0.05, 0.01):
        ref = GTJ.mask_gt(jnp.asarray(src), jnp.asarray(flow),
                          jnp.asarray(tgt), intr_j, diff)
        got = GT.mask_gt(tt(src), tt(flow), tt(tgt), intr_t, diff)
        np.testing.assert_array_equal(_np(got), _np(ref))
        assert 0 < _np(got).sum() < _np(got).size


def _assert_graphs_equal(g_t, g_j):
    for name in ("nodes", "node_indices", "edges", "edge_weights",
                 "edge_distances", "clusters", "cluster_sizes", "vertices",
                 "faces"):
        a, b = getattr(g_t, name), getattr(g_j, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert sorted(g_t.pyramid) == sorted(g_j.pyramid)
    for k in g_j.pyramid:
        np.testing.assert_array_equal(g_t.pyramid[k], g_j.pyramid[k])


def test_build_graph_from_depth_matches_jax():
    pts = _point_image()
    kw = dict(node_coverage=0.03, max_triangle_edge=0.05)
    g_t = EG.build_graph_from_depth(pts, EG.GraphConfig(**kw))
    g_j = EGJ.build_graph_from_depth(pts, EGJ.GraphConfig(**kw))
    assert len(g_t.nodes) > 8
    _assert_graphs_equal(g_t, g_j)


@pytest.mark.parametrize("grid", [(6, 5), (9, 11)])
def test_build_regular_graph_matches_jax(grid):
    pts = _point_image()
    g_t = EG.build_regular_graph(pts, *grid, max_depth_diff=0.1)
    g_j = EGJ.build_regular_graph(pts, *grid, max_depth_diff=0.1)
    _assert_graphs_equal(g_t, g_j)
    assert (g_t.edges == -1).any() and len(g_t.nodes) < grid[0] * grid[1]


# ---------------------------------------------------------------------------
# Adam7: a small numpy encoder writes each image interlaced and not


_PASSES = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_rows(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Each row filtered by type (first + row) % 5, as bytes."""
    out, prior = bytearray(), np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = (first + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(row)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) >> 1
        else:
            pred = np.asarray([_paeth(a, b, c)
                               for a, b, c in zip(left, prior, ul)])
        out.append(ftype)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def _encode_png(path, img: np.ndarray, interlace: bool):
    """uint8 [H, W] / [H, W, 3] / [H, W, 4] or uint16 [H, W] -> PNG."""
    chan = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = {1: 0, 3: 2, 4: 6}[chan]
    bpp = chan * depth // 8
    px = img.reshape(img.shape[0], img.shape[1], chan)
    if depth == 16:
        px = px.astype(">u2")

    def scanlines(sub, first):
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            return b""
        rows = np.ascontiguousarray(sub).reshape(sub.shape[0], -1).view(
            np.uint8)
        return _filter_rows(rows, bpp, first)

    if interlace:
        raw = b"".join(scanlines(px[y0::dy, x0::dx], i)
                       for i, (x0, y0, dx, dy) in enumerate(_PASSES))
    else:
        raw = scanlines(px, 0)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, ctype,
                         0, 0, int(interlace))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["grey8", "grey16", "rgb8", "rgba8"])
@pytest.mark.parametrize("hw", [(13, 9), (1, 1), (2, 3), (17, 30)])
def test_adam7_png_reads_as_its_plain_twin(tmp_path, kind, hw):
    rng = np.random.RandomState(sum(hw))
    shape = hw + {"grey8": (), "grey16": (), "rgb8": (3,),
                  "rgba8": (4,)}[kind]
    img = (rng.randint(0, 65536, shape).astype(np.uint16) if kind == "grey16"
           else rng.randint(0, 256, shape).astype(np.uint8))
    plain, adam7 = tmp_path / "plain.png", tmp_path / "adam7.png"
    _encode_png(plain, img, interlace=False)
    _encode_png(adam7, img, interlace=True)
    got = read_png(str(adam7))
    np.testing.assert_array_equal(got, read_png(str(plain)))
    np.testing.assert_array_equal(got, img)
    assert got.dtype == img.dtype
