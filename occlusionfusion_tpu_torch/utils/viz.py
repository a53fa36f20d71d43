"""Visualization and export (a numpy copy of
``occlusionfusion_tpu/utils/viz.py``).

Replaces the reference's visualization layer
(``fusion_with_occlusion/vis/`` open3d/plotly/matplotlib/ipyvolume
backends, ``utils/viz_utils.py``, ``motion_complete_utils.py:148-298``)
with headless-friendly primitives: PLY/OBJ mesh + point-cloud export, the
optical-flow colorwheel, and matplotlib renders of graphs/meshes —
no open3d/plotly dependency. matplotlib is imported inside the
functions that plot, so the module imports where it is not installed.
"""

from __future__ import annotations

import os

import numpy as np


# ---------------------------------------------------------------------------
# geometry export


def save_ply(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray | None = None,
    colors: np.ndarray | None = None,
):
    """ASCII PLY export of a mesh or point cloud (colors 0..255)."""
    vertices = np.asarray(vertices, np.float32)
    n = vertices.shape[0]
    has_color = colors is not None
    lines = ["ply", "format ascii 1.0", f"element vertex {n}"]
    lines += ["property float x", "property float y", "property float z"]
    if has_color:
        lines += [
            "property uchar red", "property uchar green", "property uchar blue"
        ]
    if faces is not None:
        lines.append(f"element face {len(faces)}")
        lines.append("property list uchar int vertex_indices")
    lines.append("end_header")
    body = []
    if has_color:
        c = np.clip(np.asarray(colors), 0, 255).astype(np.int32)
        for v, col in zip(vertices, c):
            body.append(f"{v[0]} {v[1]} {v[2]} {col[0]} {col[1]} {col[2]}")
    else:
        for v in vertices:
            body.append(f"{v[0]} {v[1]} {v[2]}")
    if faces is not None:
        for f in np.asarray(faces, np.int64):
            body.append(f"3 {f[0]} {f[1]} {f[2]}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines + body) + "\n")


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        for v in np.asarray(vertices):
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in np.asarray(faces, np.int64) + 1:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def load_ply(path: str):
    """Minimal ASCII PLY reader (vertices + faces) for round-tripping."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    n_v = n_f = 0
    header_end = 0
    for i, ln in enumerate(lines):
        if ln.startswith("element vertex"):
            n_v = int(ln.split()[-1])
        elif ln.startswith("element face"):
            n_f = int(ln.split()[-1])
        elif ln == "end_header":
            header_end = i + 1
            break
    verts = np.array(
        [[float(x) for x in ln.split()[:3]] for ln in lines[header_end : header_end + n_v]],
        np.float32,
    )
    faces = np.array(
        [
            [int(x) for x in ln.split()[1:4]]
            for ln in lines[header_end + n_v : header_end + n_v + n_f]
        ],
        np.int32,
    ) if n_f else None
    return verts, faces


# ---------------------------------------------------------------------------
# flow colorwheel (motion_complete_utils.py:148-239 / utils/flow_vis.py)


def _make_colorwheel() -> np.ndarray:
    """Baker et al. optical-flow colorwheel, [55, 3] uint8."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def flow_to_color(flow: np.ndarray, max_norm: float | None = None) -> np.ndarray:
    """[..., 2] flow -> [..., 3] uint8 colorwheel image."""
    wheel = _make_colorwheel()
    n_cols = wheel.shape[0]
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    if max_norm is None:
        max_norm = max(rad.max(), 1e-6)
    u, v = u / max_norm, v / max_norm
    rad = np.minimum(rad / max_norm, 1.0)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (n_cols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % n_cols
    f = (fk - k0)[..., None]
    col = wheel[k0] / 255 * (1 - f) + wheel[k1] / 255 * f
    col = 1 - rad[..., None] * (1 - col)
    return (col * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# line meshes (motion_complete_utils.py:38-147 LineMesh / merge_meshes)


def merge_meshes(meshes):
    """Concatenate ``(vertices, faces[, colors])`` triples into one mesh
    with reindexed faces (``motion_complete_utils.py`` merge_meshes)."""
    verts, faces, colors = [], [], []
    offset = 0
    for m in meshes:
        v = np.asarray(m[0], np.float32)
        f = np.asarray(m[1], np.int64)
        verts.append(v)
        faces.append(f + offset)
        if len(m) > 2 and m[2] is not None:
            colors.append(np.broadcast_to(np.asarray(m[2]), v.shape).copy())
        else:
            colors.append(np.full_like(v, 128.0))
        offset += v.shape[0]
    return (
        np.concatenate(verts, 0),
        np.concatenate(faces, 0),
        np.concatenate(colors, 0),
    )


def line_mesh(points, edges, radius: float = 0.002, color=(255, 0, 0),
              sides: int = 6):
    """Triangle-mesh cylinders along graph edges — the headless
    equivalent of the reference's open3d ``LineMesh``
    (``motion_complete_utils.py:38-147``). ``edges`` is [E, 2] index
    pairs (or an [N, K] neighbor table with -1/self padding, K != 2 —
    a two-column array is always read as edge pairs). Returns
    ``(vertices, faces, colors)`` ready for :func:`save_ply`."""
    points = np.asarray(points, np.float32)
    edges = np.asarray(edges, np.int64)
    if edges.ndim == 2 and edges.shape[1] != 2:
        ii = np.repeat(np.arange(edges.shape[0]), edges.shape[1])
        jj = edges.reshape(-1)
        keep = (jj >= 0) & (jj != ii) & (jj < len(points))
        edges = np.stack([ii[keep], jj[keep]], axis=1)
    meshes = []
    ang = 2 * np.pi * np.arange(sides) / sides
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=1)  # [S, 2]
    for a, b in edges:
        p0, p1 = points[a], points[b]
        axis = p1 - p0
        ln = np.linalg.norm(axis)
        if ln < 1e-9:
            continue
        axis = axis / ln
        # orthonormal frame around the axis
        ref = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else np.array([0, 1.0, 0])
        u = np.cross(axis, ref)
        u /= np.linalg.norm(u)
        w = np.cross(axis, u)
        circ = ring[:, :1] * u + ring[:, 1:] * w  # [S, 3]
        v = np.concatenate([p0 + radius * circ, p1 + radius * circ], 0)
        s = sides
        i = np.arange(s)
        j = (i + 1) % s
        quads_a = np.stack([i, j, i + s], axis=1)
        quads_b = np.stack([j, j + s, i + s], axis=1)
        meshes.append((v, np.concatenate([quads_a, quads_b], 0), color))
    if not meshes:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int64),
            np.zeros((0, 3), np.float32),
        )
    return merge_meshes(meshes)


def graph_mesh(nodes, edges, node_motion=None, radius: float = 0.002,
               max_norm: float | None = None):
    """Deformation-graph edge mesh with edges colored by node-motion
    magnitude via the flow colorwheel when ``node_motion`` is given —
    the headless stand-in for the reference's graph renders
    (``utils/viz_utils.py`` get_graph / ``visualize.py``)."""
    nodes = np.asarray(nodes, np.float32)
    if node_motion is None:
        return line_mesh(nodes, edges, radius=radius)
    m = np.asarray(node_motion, np.float32)
    col3 = flow_to_color(m[:, :2], max_norm=max_norm)  # [N, 3] uint8
    edges = np.asarray(edges, np.int64)
    if edges.ndim == 2 and edges.shape[1] != 2:
        ii = np.repeat(np.arange(edges.shape[0]), edges.shape[1])
        jj = edges.reshape(-1)
        keep = (jj >= 0) & (jj != ii) & (jj < len(nodes))
        edges = np.stack([ii[keep], jj[keep]], axis=1)
    meshes = [
        line_mesh(nodes, np.array([[a, b]]), radius=radius,
                  color=tuple(int(x) for x in col3[a]))
        for a, b in edges
    ]
    meshes = [m_ for m_ in meshes if len(m_[0])]
    if not meshes:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int64),
            np.zeros((0, 3), np.float32),
        )
    return merge_meshes(meshes)


# ---------------------------------------------------------------------------
# matplotlib renders (headless)


def plot_graph(path: str, nodes, edges, node_colors=None, title=""):
    """Render the deformation graph to an image file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    nodes = np.asarray(nodes)
    for i, row in enumerate(np.asarray(edges)):
        for j in row:
            if j >= 0:
                seg = nodes[[i, j]]
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "gray", lw=0.5)
    c = node_colors if node_colors is not None else "C0"
    ax.scatter(nodes[:, 0], nodes[:, 1], nodes[:, 2], c=c, s=12)
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_depth(path: str, depth: np.ndarray, title=""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.asarray(depth), cmap="turbo")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


# ---------------------------------------------------------------------------
# headless shaded-mesh renderer (the open3d-viewer replacement)


def _box_blur_masked(x: np.ndarray, mask: np.ndarray, r: int) -> np.ndarray:
    """Mask-normalized (2r+1)-box blur via integral images."""
    H, W = x.shape
    w = mask.astype(np.float32)
    xs = np.where(mask, x, 0.0).astype(np.float32)

    def boxsum(a):
        c = np.pad(np.cumsum(np.cumsum(a, 0), 1), ((1, 0), (1, 0)))
        y0 = np.clip(np.arange(H) - r, 0, H)
        y1 = np.clip(np.arange(H) + r + 1, 0, H)
        x0 = np.clip(np.arange(W) - r, 0, W)
        x1 = np.clip(np.arange(W) + r + 1, 0, W)
        return (c[y1][:, x1] - c[y0][:, x1] - c[y1][:, x0] + c[y0][:, x0])

    s, n = boxsum(xs), boxsum(w)
    return np.where(mask, s / np.maximum(n, 1e-9), x)


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray | None = None,
    image_hw=(480, 480),
    colors: np.ndarray | None = None,
    azimuth_deg: float = 0.0,
    elevation_deg: float = 15.0,
    distance: float | None = None,
    light=(-0.3, -0.4, 0.85),
    splat_radius: int = 2,
    supersample: int = 2,
) -> np.ndarray:
    """Shaded turntable render -> uint8 [H, W, 3] image.

    The open3d-window replacement for headless environments (the
    reference's ``fusion_with_occlusion/vis/visualizer.py`` open3d
    backend): orbits the camera around the mesh centroid, splats the
    points through the same numpy z-buffer the data path uses, then
    shades in SCREEN SPACE — normals from the rendered depth map's
    gradients (smooth for point clouds regardless of splat-gap winners),
    Lambertian + ambient, box-downsampled for antialiasing. ``faces``
    is accepted for API parity but unused (point splatting needs none).
    """
    from occlusionfusion_tpu_torch.data.synthetic_shapes import np_render
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    v = np.asarray(vertices, np.float32)
    center = v.mean(0)

    # orbit camera: rotate the WORLD so the camera stays at -z
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    Ry = np.asarray(
        [[np.cos(az), 0, np.sin(az)], [0, 1, 0], [-np.sin(az), 0, np.cos(az)]],
        np.float32)
    Rx = np.asarray(
        [[1, 0, 0], [0, np.cos(el), -np.sin(el)], [0, np.sin(el), np.cos(el)]],
        np.float32)
    R = Rx @ Ry
    radius = float(np.linalg.norm(v - center, axis=1).max() + 1e-9)
    if distance is None:
        distance = 3.2 * radius
    vc = (v - center) @ R.T + np.asarray([0, 0, distance], np.float32)

    base = (
        np.asarray(colors, np.float32)
        if colors is not None
        else np.full((len(vc), 3), np.float32(200.0))
    )

    H, W = image_hw
    ss = max(int(supersample), 1)
    Hs, Ws = H * ss, W * ss
    # fill ~90% of the half-image at the orbit distance
    f = 0.45 * min(Hs, Ws) * distance / radius
    intr = Intrinsics(
        np.float32(f), np.float32(f),
        np.float32(Ws / 2), np.float32(Hs / 2),
    )
    depth, albedo, mask, _ = np_render(
        vc, base, intr, (Hs, Ws), splat_radius=splat_radius * ss
    )
    # the splat depth is piecewise-constant (terraced at splat
    # boundaries) — box-blur it over the valid mask before taking
    # gradients or the normals speckle
    depth = _box_blur_masked(depth, mask, splat_radius * ss + 1)
    # screen-space normals from the depth gradient (camera space):
    # p(u,v) = ((u-cx)/f z, (v-cy)/f z, z); n = dp/du x dp/dv
    d = np.where(mask, depth, np.nan)
    dzdv, dzdu = np.gradient(d)
    vv, uu = np.mgrid[0:Hs, 0:Ws].astype(np.float32)
    z = np.where(mask, depth, 1.0)
    du = np.stack([(z + (uu - Ws / 2) * dzdu) / f, (vv - Hs / 2) * dzdu / f,
                   dzdu], -1)
    dv = np.stack([(uu - Ws / 2) * dzdv / f, (z + (vv - Hs / 2) * dzdv) / f,
                   dzdv], -1)
    n = np.cross(du, dv)
    bad = ~np.isfinite(n).all(-1)
    n[bad] = np.asarray([0.0, 0.0, -1.0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    n[n[..., 2] > 0] *= -1.0  # face the camera

    ld = np.asarray(light, np.float32)
    ld /= np.linalg.norm(ld) + 1e-9
    lam = np.clip(-(n @ ld), 0.0, 1.0)[..., None]
    img = albedo * (0.3 + 0.7 * lam)
    img = np.where(mask[..., None], img, 30.0)  # dark background
    if ss > 1:
        img = img.reshape(H, ss, W, ss, 3).mean((1, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def save_turntable(
    path_pattern: str,
    vertices: np.ndarray,
    faces: np.ndarray | None = None,
    n_views: int = 8,
    **kw,
) -> list:
    """Write ``n_views`` orbit renders to ``path_pattern % index`` (RGB
    PNG by ``fusion.frame_loader.write_png``: neither PIL nor matplotlib).
    Returns the written paths."""
    from occlusionfusion_tpu_torch.fusion.frame_loader import write_png

    paths = []
    for i in range(n_views):
        img = render_mesh(
            vertices, faces, azimuth_deg=360.0 * i / n_views, **kw
        )
        p = path_pattern % i if "%" in path_pattern else path_pattern
        write_png(p, img)
        paths.append(p)
        if "%" not in path_pattern:
            break
    return paths
