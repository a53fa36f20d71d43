"""DeformingThings4D (.anime) clips: loading, depth rendering, GT eval
(port of ``occlusionfusion_tpu/data/deformingthings4d.py``).

Equivalent of the reference's DT4D tooling
(``preprocessing/createDeformingThings4D.py``, anime reader at
``fusion_tests/ssdr.py:14-29``): reads the .anime binary format, animates
the mesh, renders synthetic depth sequences through our point-splat
rasterizer (the port's ``ops/rasterize.py``, on the card unless
``device="cpu"``), and exposes ground-truth per-frame vertex
trajectories for ATE / node-motion-EPE evaluation (the parity metrics of
BASELINE config 3 are defined against these GT trajectories since the
fork ships no Lepard/NT weights).

.anime layout (little-endian): int32 nf, nv, nt; f32[nv, 3] rest
vertices; int32[nt, 3] triangles; f32[nf-1, nv, 3] per-frame offsets.
"""

from __future__ import annotations

import numpy as np


def load_anime(path: str):
    """-> (verts [nv, 3], faces [nt, 3], offsets [nf-1, nv, 3])."""
    with open(path, "rb") as fh:
        nf, nv, nt = np.frombuffer(fh.read(12), np.int32)
        verts = np.frombuffer(fh.read(4 * nv * 3), np.float32).reshape(nv, 3)
        faces = np.frombuffer(fh.read(4 * nt * 3), np.int32).reshape(nt, 3)
        offsets = np.frombuffer(fh.read(4 * (nf - 1) * nv * 3), np.float32)
        offsets = offsets.reshape(nf - 1, nv, 3)
    return verts.copy(), faces.copy(), offsets.copy()


def save_anime(path: str, verts, faces, offsets):
    with open(path, "wb") as fh:
        nf = offsets.shape[0] + 1
        np.asarray([nf, verts.shape[0], faces.shape[0]], np.int32).tofile(fh)
        np.ascontiguousarray(verts, np.float32).tofile(fh)
        np.ascontiguousarray(faces, np.int32).tofile(fh)
        np.ascontiguousarray(offsets, np.float32).tofile(fh)


def frame_vertices(verts, offsets, frame: int):
    """Animated vertices at frame (frame 0 = rest pose)."""
    return verts if frame == 0 else verts + offsets[frame - 1]


def anime_to_depth_sequence(
    path: str,
    intrinsics,
    image_hw=(240, 320),
    camera_offset=(0.0, 0.0, 1.5),
    scale: float = 1.0,
    splat_radius: int = 2,
    max_frames: int | None = None,
    camera_poses=None,
    device=None,
):
    """Render an .anime clip to synthetic depth maps + GT trajectories.

    Places the animated mesh ``camera_offset`` in front of the camera.
    ``camera_poses``: optional (Rs [F,3,3], ts [F,3]) world->camera per
    frame (``synthetic_shapes.camera_path``) — a moving camera makes the
    object leave the frustum and return, the keyframe pose-graph regime.
    Returns (depths [F, H, W], gt_vertices [F, nv, 3] in camera frame),
    numpy.
    """
    import torch

    from occlusionfusion_tpu_torch.device import resolve_device
    from occlusionfusion_tpu_torch.ops.rasterize import render_depth

    dev = resolve_device(device)

    verts, faces, offsets = load_anime(path)
    n_frames = offsets.shape[0] + 1
    if max_frames:
        n_frames = min(n_frames, max_frames)
    center = verts.mean(0)
    offset = np.asarray(camera_offset, np.float32)
    depths, gt = [], []
    for f in range(n_frames):
        v = (frame_vertices(verts, offsets, f) - center) * scale + offset
        if camera_poses is not None:
            v = v @ camera_poses[0][f].T + camera_poses[1][f]
        depth, _ = render_depth(
            torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev),
            intrinsics, image_hw, splat_radius=splat_radius,
        )
        depths.append(depth.cpu().numpy())
        gt.append(v.astype(np.float32))
    return np.stack(depths), np.stack(gt)


def trajectory_ate(pred: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error: RMS over frames x points of the L2
    position error (the BASELINE ATE metric)."""
    err = np.linalg.norm(pred - gt, axis=-1)
    return float(np.sqrt(np.mean(err**2)))


def rigid_pose_np(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid (R, t) with dst ≈ R @ src + t (numpy Kabsch;
    the GT-pose extractor for pose-trajectory evaluation)."""
    cs, cd = src.mean(0), dst.mean(0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H.astype(np.float64))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    return R.astype(np.float32), (cd - R @ cs).astype(np.float32)


def pose_trajectory_ate(
    frame_ids: np.ndarray,  # [K]
    R_est: np.ndarray,  # [K, 3, 3]  canonical -> frame
    t_est: np.ndarray,  # [K, 3]
    gt: np.ndarray,  # [F, nv, 3] GT vertex trajectories (camera frame)
) -> dict:
    """Score an estimated keyframe pose trajectory (the
    ``results/trajectory.npz`` artifact of scripts/run_fusion.py) against
    a clip's GT vertex trajectories.

    The GT pose at frame f is the rigid component of the GT motion,
    Kabsch(gt[0] -> gt[f]). Both est and GT poses are maps on the same
    scene, so they are compared as actions on the canonical centroid
    (position ATE, origin-independent) plus geodesic rotation error.
    Returns {"pose_ate_m", "rot_err_deg", "keyframes"}.
    """
    c = gt[0].mean(0)
    pos_err, rot_err = [], []
    for k, f in enumerate(np.asarray(frame_ids, int)):
        Rg, tg = rigid_pose_np(gt[0], gt[f])
        pos_err.append(
            np.linalg.norm((R_est[k] @ c + t_est[k]) - (Rg @ c + tg))
        )
        cosang = (np.trace(R_est[k].T @ Rg) - 1.0) / 2.0
        rot_err.append(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))
    return {
        "pose_ate_m": float(np.sqrt(np.mean(np.square(pos_err)))),
        "rot_err_deg": float(np.mean(rot_err)),
        "keyframes": int(len(pos_err)),
    }


def procedural_vertex_colors(verts: np.ndarray, seed: int = 0) -> np.ndarray:
    """Deterministic high-frequency texture over the surface (0..255):
    optical flow needs appearance gradients; plain gray defeats it."""
    v = np.asarray(verts, np.float32)
    rng = np.random.RandomState(seed)
    basis = rng.randn(3, 3).astype(np.float32) * 60.0
    phase = rng.rand(3).astype(np.float32) * 6.28
    c = 127.0 + 90.0 * np.sin(v @ basis.T + phase)
    c += rng.randn(*c.shape).astype(np.float32) * 8.0
    return np.clip(c, 0, 255).astype(np.float32)


def anime_to_rgbd_sequence(
    path: str,
    intrinsics,
    image_hw=(240, 320),
    camera_offset=(0.0, 0.0, 1.5),
    scale: float = 1.0,
    splat_radius: int = 2,
    max_frames: int | None = None,
    vert_colors: np.ndarray | None = None,
    camera_poses=None,
    device=None,
):
    """Textured variant of ``anime_to_depth_sequence``: renders color
    via the nearest-point composite (ops/rasterize.render_depth_color).
    ``camera_poses`` as in ``anime_to_depth_sequence``.
    Returns (depths [F, H, W], colors [F, H, W, 3], gt [F, nv, 3])."""
    import torch

    from occlusionfusion_tpu_torch.device import resolve_device
    from occlusionfusion_tpu_torch.ops.rasterize import render_depth_color

    dev = resolve_device(device)

    verts, faces, offsets = load_anime(path)
    n_frames = offsets.shape[0] + 1
    if max_frames:
        n_frames = min(n_frames, max_frames)
    if vert_colors is None:
        vert_colors = procedural_vertex_colors(verts)
    center = verts.mean(0)
    offset = np.asarray(camera_offset, np.float32)
    cj = torch.from_numpy(np.ascontiguousarray(vert_colors, np.float32)).to(
        dev)
    depths, colors, gt = [], [], []
    for f in range(n_frames):
        v = (frame_vertices(verts, offsets, f) - center) * scale + offset
        if camera_poses is not None:
            v = v @ camera_poses[0][f].T + camera_poses[1][f]
        depth, color, _ = render_depth_color(
            torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev),
            cj, intrinsics, image_hw, splat_radius=splat_radius,
        )
        depths.append(depth.cpu().numpy())
        colors.append(color.cpu().numpy())
        gt.append(v.astype(np.float32))
    return np.stack(depths), np.stack(colors), np.stack(gt)
