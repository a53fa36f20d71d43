"""Procedural deforming test shapes + rendered flow-training pairs (port
of ``occlusionfusion_tpu/data/synthetic_shapes.py``; numpy only: the same
seed gives the same arrays, bit for bit).

The shape generators used by ``scripts/evaluate_dt4d.py --synthetic``
(blob / limbs / articulated arms), factored into the package so the flow
trainer can render DOMAIN-MATCHED training pairs: same point-splat
renderer, same procedural texture, same camera, exact ground-truth
optical flow from the known vertex correspondences. This replaces the
reference's missing flow-training data path (its ``train.py`` is absent
and DeepDeform is not shipped; supervision layout mirrors
``model/dataset.py`` flow/mask GT semantics).

The numpy renderer here is a host-side twin of
``ops/rasterize.render_depth_color``, so data generation never waits on
the device.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# shape clips (verts [nv,3], faces [nt,3], offsets [nf-1,nv,3])
# ---------------------------------------------------------------------------


def blob_or_limbs_clip(n_frames, n_verts, rng, rotate_deg=0.0, shape="blob",
                       rotate_osc_deg=0.0):
    """Sphere with a traveling bulge; ``limbs`` adds 4 protruding lobes
    with matchable local geometry. rng draw order is load-bearing: the
    eval goldens pin clips generated from a given seed."""
    v = rng.randn(n_verts, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = np.full(n_verts, 0.12, np.float32)
    if shape == "limbs":
        limb_dirs = np.asarray(
            [[1, 0, 0.3], [-1, 0.2, 0], [0, 1, -0.2], [0.2, -1, 0]],
            np.float32,
        )
        limb_dirs /= np.linalg.norm(limb_dirs, axis=1, keepdims=True)
        for d in limb_dirs:
            w = np.maximum(v @ d, 0.0) ** 8
            r = r + 0.06 * w.astype(np.float32)
    verts = (v * r[:, None]).astype(np.float32)
    faces = np.zeros((1, 3), np.int32)  # faces unused by the renderer
    offsets = []
    for f in range(1, n_frames):
        phase = f / n_frames
        # rigid drift + a traveling bulge
        drift = np.asarray([0.0, 0.0, 0.002]) * f
        bulge_dir = np.asarray(
            [np.cos(2 * np.pi * phase), np.sin(2 * np.pi * phase), 0.0]
        )
        w = np.maximum(v @ bulge_dir, 0.0) ** 2
        deformed = verts + (
            drift + 0.03 * w[:, None] * v * phase
        ).astype(np.float32)
        a = np.deg2rad(rotate_deg) * f + np.deg2rad(
            rotate_osc_deg
        ) * np.sin(2 * np.pi * f / n_frames)
        if a:
            Rz = np.asarray(
                [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]], np.float32)
            deformed = deformed @ Rz.T
        offsets.append((deformed - verts).astype(np.float32))
    return verts, faces, np.stack(offsets)


def arms_clip(n_frames, n_verts, rng, rotate_deg=0.0, rotate_osc_deg=0.0):
    """Body ellipsoid + two limbs swinging rigidly about shoulder
    joints; the left limb crosses in front of the body (self-occlusion,
    the hard regime)."""
    n_body = n_verts // 2
    n_limb = (n_verts - n_body) // 2
    v = rng.randn(n_body, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    body = v * np.asarray([0.09, 0.12, 0.07], np.float32)

    def capsule(joint, axis, length=0.14, radius=0.025, n=n_limb):
        t = rng.rand(n).astype(np.float32)
        ring = rng.randn(n, 3).astype(np.float32)
        axis = axis / np.linalg.norm(axis)
        ring -= np.outer(ring @ axis, axis)
        ring /= np.linalg.norm(ring, axis=1, keepdims=True) + 1e-9
        return joint + np.outer(t * length, axis) + ring * radius

    jointL = np.asarray([-0.09, 0.08, 0.0], np.float32)
    jointR = np.asarray([0.09, 0.08, 0.0], np.float32)
    limbL = capsule(jointL, np.asarray([-0.7, -1.0, 0.0]))
    limbR = capsule(jointR, np.asarray([0.7, -1.0, 0.0]))
    verts = np.concatenate([body, limbL, limbR]).astype(np.float32)
    is_l = np.zeros(len(verts), bool)
    is_l[n_body : n_body + n_limb] = True
    is_r = np.zeros(len(verts), bool)
    is_r[n_body + n_limb :] = True

    def rot_about(pts, joint, axis, angle):
        axis = axis / np.linalg.norm(axis)
        K = np.asarray(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
             [-axis[1], axis[0], 0]], np.float32)
        R = (
            np.eye(3, dtype=np.float32)
            + np.sin(angle) * K
            + (1 - np.cos(angle)) * (K @ K)
        )
        return (pts - joint) @ R.T + joint

    offsets = []
    for f in range(1, n_frames):
        phase = 2 * np.pi * f / n_frames
        d = verts.copy()
        # left limb swings about the x-axis toward the camera (-z),
        # crossing in front of the body: strong self-occlusion
        d[is_l] = rot_about(
            d[is_l], jointL, np.asarray([1.0, 0, 0]),
            0.9 * np.sin(phase),
        )
        # right limb swings in-plane about z
        d[is_r] = rot_about(
            d[is_r], jointR, np.asarray([0, 0, 1.0]),
            0.7 * np.sin(phase + 1.0),
        )
        a = np.deg2rad(rotate_deg) * f + np.deg2rad(
            rotate_osc_deg
        ) * np.sin(2 * np.pi * f / n_frames)
        if a:
            Rz = np.asarray(
                [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]], np.float32)
            d = d @ Rz.T
        offsets.append((d - verts).astype(np.float32))
    return verts, np.zeros((1, 3), np.int32), np.stack(offsets)


def surface_labels(shape: str, verts: np.ndarray) -> np.ndarray:
    """Per-vertex surface-identity label for a ``shape_clip`` shape
    (0 = body; 1..K = parts). Derived deterministically from the vertex
    layout/geometry the generators use — no rng draws, so golden clips
    are unaffected.

    - ``arms``: index arithmetic (body / left limb / right limb blocks,
      see ``arms_clip``).
    - ``limbs``: lobe membership by direction (a vertex belongs to the
      lobe whose ``limb_dirs`` row it most aligns with, when the
      alignment would produce a significant bulge weight — the same
      ``max(v@d, 0)^8`` field the generator shapes with).
    - ``blob``: all zeros (one surface).

    The bridge-negative supervision consumes these: a confident match
    joining two different labels' points that are geometrically near in
    the target frame is a cross-surface bridge — the diagnosed arms
    failure that match-level supervision alone cannot penalize."""
    n = len(verts)
    if shape == "arms":
        n_body = n // 2
        n_limb = (n - n_body) // 2
        lbl = np.zeros(n, np.int32)
        lbl[n_body : n_body + n_limb] = 1
        lbl[n_body + n_limb : n_body + 2 * n_limb] = 2
        return lbl
    if shape == "limbs":
        limb_dirs = np.asarray(
            [[1, 0, 0.3], [-1, 0.2, 0], [0, 1, -0.2], [0.2, -1, 0]],
            np.float32,
        )
        limb_dirs /= np.linalg.norm(limb_dirs, axis=1, keepdims=True)
        v = verts / (np.linalg.norm(verts, axis=1, keepdims=True) + 1e-9)
        a = v @ limb_dirs.T  # [n, 4]
        best = a.max(1)
        lbl = np.where(best > 0.8, a.argmax(1) + 1, 0)
        return lbl.astype(np.int32)
    return np.zeros(n, np.int32)


def shape_clip(shape, n_frames, n_verts, seed=0, rotate_deg=0.0,
               rotate_osc_deg=0.0):
    """Dispatch on shape name; one RandomState per clip, draw order
    matching the original ``evaluate_dt4d.synthetic_anime``.
    ``rotate_osc_deg``: oscillating in-plane rotation (amplitude, one
    period over the clip) — the object swings away and RETURNS, the
    revisit regime keyframe loop closure exists for (a monotonic
    rotate_deg never closes a loop)."""
    rng = np.random.RandomState(seed)
    if shape == "arms":
        return arms_clip(n_frames, n_verts, rng, rotate_deg, rotate_osc_deg)
    return blob_or_limbs_clip(n_frames, n_verts, rng, rotate_deg, shape,
                              rotate_osc_deg)


# ---------------------------------------------------------------------------
# camera trajectories (world -> camera per frame)
# ---------------------------------------------------------------------------


def camera_path(kind, n_frames, amp=0.25, orbit_deg=25.0,
                pivot=(0.0, 0.0, 1.5)):
    """Per-frame world->camera rigid poses: p_cam = R[f] @ p + t[f].

    The reference's clips keep a static camera; these paths create the
    leave-and-revisit regime the keyframe pose graph exists for (the
    model exits the frustum and returns; no reference counterpart).

    Kinds:
      * ``static``       — identity (the default everywhere else).
      * ``truck_return`` — the camera trucks sideways by
        ``amp * sin(2*pi*f/F)`` metres and comes back: the object
        drifts off-frame (partially or fully, depending on amp) and
        re-enters by the final frames.
      * ``orbit_return`` — the camera yaws about ``pivot`` (the object
        centre in camera coordinates) by ``orbit_deg * sin(2*pi*f/F)``
        degrees and returns: viewpoint change + frustum exit at high
        amplitude.

    Returns (Rs [F,3,3] float32, ts [F,3] float32).
    """
    Rs = np.repeat(np.eye(3, dtype=np.float32)[None], n_frames, 0).copy()
    ts = np.zeros((n_frames, 3), np.float32)
    if kind in (None, "static"):
        return Rs, ts
    ph = np.sin(2.0 * np.pi * np.arange(n_frames) / max(n_frames - 1, 1))
    if kind == "truck_return":
        # camera moves +x; the world shifts -x in camera coordinates
        ts[:, 0] = -amp * ph
        return Rs, ts
    if kind == "orbit_return":
        piv = np.asarray(pivot, np.float32)
        th = np.deg2rad(orbit_deg) * ph
        for f in range(n_frames):
            c, s = np.cos(th[f]), np.sin(th[f])
            R = np.asarray(
                [[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32
            )
            Rs[f] = R
            ts[f] = piv - R @ piv
        return Rs, ts
    raise ValueError(
        f"camera_path kind must be static/truck_return/orbit_return, "
        f"got {kind!r}"
    )


# ---------------------------------------------------------------------------
# numpy point-splat renderer (host twin of ops/rasterize.py)
# ---------------------------------------------------------------------------

_FAR = 1e9


def np_render(points, colors, intr, image_hw, splat_radius=2):
    """Splat [P,3] camera-frame points: returns (depth [H,W] 0=empty,
    color [H,W,3], mask [H,W] bool, winner [H,W] int point index, P where
    empty). Same z-buffer + lowest-index-at-min-depth tie-break as
    ``ops/rasterize.render_depth_color`` (cross-tested)."""
    H, W = image_hw
    points = np.asarray(points, np.float32)
    P = points.shape[0]
    z = points[:, 2]
    valid = z > 1e-6
    zs = np.where(valid, z, 1.0)
    u0 = np.round(points[:, 0] / zs * float(intr.fx) + float(intr.cx)).astype(
        np.int64
    )
    v0 = np.round(points[:, 1] / zs * float(intr.fy) + float(intr.cy)).astype(
        np.int64
    )
    # vectorize the (2r+1)^2 splat offsets, then one lexsort per pass
    # (np.minimum.at is ~10x slower; exact same z-buffer + tie-break)
    k = 2 * splat_radius + 1
    dys, dxs = np.meshgrid(
        np.arange(-splat_radius, splat_radius + 1),
        np.arange(-splat_radius, splat_radius + 1), indexing="ij",
    )
    px = (u0[:, None] + dxs.reshape(-1)[None, :]).reshape(-1)
    py = (v0[:, None] + dys.reshape(-1)[None, :]).reshape(-1)
    zz = np.repeat(z, k * k)
    ids = np.repeat(np.arange(P, dtype=np.int64), k * k)
    ok = (
        np.repeat(valid, k * k)
        & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    )
    flat = (py * W + px)[ok]
    zz = zz[ok]
    ids = ids[ok]

    depth = np.full(H * W, _FAR, np.float32)
    order = np.lexsort((zz, flat))
    fs = flat[order]
    first = np.flatnonzero(np.r_[True, fs[1:] != fs[:-1]])
    depth[fs[first]] = zz[order][first]
    mask = depth < _FAR

    winner = np.full(H * W, P, np.int64)
    at_min = np.abs(zz - depth[flat]) < 1e-6
    fm, im = flat[at_min], ids[at_min]
    order = np.lexsort((im, fm))
    fs = fm[order]
    first = np.flatnonzero(np.r_[True, fs[1:] != fs[:-1]])
    winner[fs[first]] = im[order][first]
    color = np.where(
        ((winner < P) & mask)[:, None],
        np.asarray(colors, np.float32)[np.minimum(winner, P - 1)],
        0.0,
    )
    return (
        np.where(mask, depth, 0.0).reshape(H, W),
        color.reshape(H, W, 3),
        mask.reshape(H, W),
        winner.reshape(H, W),
    )


def _project(pts, intr):
    z = np.maximum(pts[..., 2], 1e-6)
    u = pts[..., 0] / z * float(intr.fx) + float(intr.cx)
    v = pts[..., 1] / z * float(intr.fy) + float(intr.cy)
    return u, v


def _backproject(depth, intr):
    H, W = depth.shape
    v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    x = (u - float(intr.cx)) / float(intr.fx) * depth
    y = (v - float(intr.cy)) / float(intr.fy) * depth
    return np.stack([x, y, depth], -1)


# ---------------------------------------------------------------------------
# rendered flow-training pairs
# ---------------------------------------------------------------------------


def rendered_flow_pair(
    rng,
    H=160,
    W=160,
    intr=None,
    shapes=("blob", "limbs", "arms"),
    n_verts=5000,
    n_frames=12,
    max_gap=2,
    splat_radius=2,
    depth_tol=0.01,
    camera_offset=1.5,
):
    """One rendered RGB-D pair with exact GT flow / validity / mask GT.

    Returns a dict of numpy arrays: im1/im2 [H,W,3] RGB in [0,1] (the
    in-loop normalization, pipeline.py rgbxyz), flow [H,W,2] full-res
    pixels source->target, valid [H,W] (source splat exists), src6/tgt6
    [H,W,6] RGB+XYZ images (XYZ backprojected from the rendered depth,
    matching inference), mask_gt [H,W] (target-visible AND
    depth-consistent under the GT flow — the MaskNet supervision
    semantics of ``model/dataset.py``).

    GT flow at pixel p is proj_target(x) - p where x is the surface
    point winning p's z-buffer — so bilinear sampling the target point
    image at p + flow recovers x's true target location, exactly the
    lift ``flow_correspondences`` performs.
    """
    from occlusionfusion_tpu_torch.data.deformingthings4d import (
        frame_vertices,
        procedural_vertex_colors,
    )

    if intr is None:
        from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

        intr = Intrinsics(
            np.float32(300.0), np.float32(300.0),
            np.float32(W / 2), np.float32(H / 2),
        )
    shape = shapes[rng.randint(len(shapes))]
    rotate_deg = float(rng.uniform(0.0, 6.0))
    verts, _, offs = shape_clip(
        shape, n_frames, n_verts, seed=int(rng.randint(1 << 31)),
        rotate_deg=rotate_deg,
    )
    colors = procedural_vertex_colors(verts, seed=int(rng.randint(1 << 31)))
    center = verts.mean(0)
    off = np.asarray(
        [rng.uniform(-0.03, 0.03), rng.uniform(-0.03, 0.03),
         camera_offset + rng.uniform(-0.25, 0.25)], np.float32)
    scale = float(rng.uniform(0.8, 1.25))
    i = int(rng.randint(0, n_frames - 1 - max_gap))
    j = i + 1 + (int(rng.randint(max_gap)) if max_gap > 0 else 0)
    v_i = (frame_vertices(verts, offs, i) - center) * scale + off
    v_j = (frame_vertices(verts, offs, j) - center) * scale + off

    d1, c1, m1, win = np_render(v_i, colors, intr, (H, W), splat_radius)
    d2, c2, _, _ = np_render(v_j, colors, intr, (H, W), splat_radius)

    P = len(v_i)
    valid = m1 & (win < P)
    safe = np.minimum(win, P - 1)
    tgt_pts = v_j[safe]  # [H,W,3] target position of each pixel's point
    uj, vj = _project(tgt_pts, intr)
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    flow = np.stack([uj - uu, vj - vv], -1).astype(np.float32)
    flow = np.where(valid[..., None], flow, 0.0)

    # mask GT: flowed target in-bounds, visible (depth-consistent)
    ui = np.clip(np.round(uj).astype(np.int64), 0, W - 1)
    vi = np.clip(np.round(vj).astype(np.int64), 0, H - 1)
    inb = (uj >= 0) & (uj <= W - 1) & (vj >= 0) & (vj <= H - 1)
    zbuf = d2[vi, ui]
    mask_gt = valid & inb & (zbuf > 0) & (
        np.abs(tgt_pts[..., 2] - zbuf) < depth_tol
    )

    im1 = (c1 / 255.0).astype(np.float32)
    im2 = (c2 / 255.0).astype(np.float32)
    src6 = np.concatenate([im1, _backproject(d1, intr)], -1).astype(np.float32)
    tgt6 = np.concatenate([im2, _backproject(d2, intr)], -1).astype(np.float32)
    return dict(
        im1=im1, im2=im2, flow=flow, valid=valid,
        src6=src6, tgt6=tgt6, mask_gt=mask_gt,
    )
