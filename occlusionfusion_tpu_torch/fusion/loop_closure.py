"""Keyframe loop-closure measurement: rigid projective ICP (port of
``occlusionfusion_tpu/fusion/loop_closure.py``).

Keyframes store their depth observation. A loop closure re-registers the
current model (or a keyframe's observed points) against an earlier
keyframe's depth with a few rounds of rigid projective association and a
Cauchy-reweighted Kabsch fit; the SE(3) it finds is a measurement that
ties the two keyframe poses (``fusion/pose_graph.py``). Relocalization
runs the same alignment against the current keyframe. Host-side keyframe
work: it runs between chunks, eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch.fusion.correspondence import (
    projective_correspondences,
)
from occlusionfusion_tpu_torch.geometry.camera import (
    Intrinsics,
    backproject_depth,
)
from occlusionfusion_tpu_torch.geometry.kabsch import weighted_kabsch


class RigidAlignment(NamedTuple):
    rotation: torch.Tensor  # [3, 3]
    translation: torch.Tensor  # [3]
    inlier_fraction: torch.Tensor  # valid matches / valid points
    residual: torch.Tensor  # median |aligned - target| over inliers
    # the same at the identity pose; a fully lost pose has no inliers
    # there and its median reads 0.0, so read it with the fraction below
    initial_residual: torch.Tensor
    initial_inlier_fraction: torch.Tensor = None


def _masked_median(x, mask):
    srt = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))[0]
    idx = torch.clamp(torch.sum(mask.to(torch.int32)) // 2, min=0)
    med = srt[idx]
    return torch.where(torch.isfinite(med), med, torch.zeros_like(med))


@torch.no_grad()
def rigid_depth_alignment(
    points,  # [P, 3] model points (camera frame)
    point_valid,  # [P]
    depth_im,  # [H, W] the stored keyframe observation
    intr: Intrinsics,
    iters: int = 5,
    max_depth_diff: float = 0.1,
    coarse_init: bool = True,
    coarse_inlier_threshold: float = 0.25,
    coarse_band: float = 0.25,
    feat_init=None,  # optional (R [3, 3], t [3]) feature pose
) -> RigidAlignment:
    """The rigid (R, t) mapping ``points`` onto the surface observed in
    ``depth_im``: ``iters`` rounds of projective association and weighted
    Kabsch. With ``coarse_init``, when fewer than
    ``coarse_inlier_threshold`` of the points associate at the identity
    pose (and the depth has any pixel), ``iters`` wide-band rounds
    (``coarse_band``) first run from the centroid offset, or from
    ``feat_init`` where given, and the fine rounds start from their
    result; otherwise the fine rounds start at the identity."""

    def step(R, t, band):
        cur = points @ R.T + t
        targets, ok = projective_correspondences(
            cur, point_valid, depth_im, intr, max_depth_diff=band)
        dist = torch.linalg.vector_norm(cur - targets, dim=-1)
        s = torch.clamp(_masked_median(dist, ok), min=1e-6)
        w = ok.to(torch.float32) / (1.0 + torch.square(dist / (3.0 * s)))
        dR, dt = weighted_kabsch(cur, targets, weights=w)
        return dR @ R, dR @ t + dt

    def median_residual(pts):
        targets, ok = projective_correspondences(
            pts, point_valid, depth_im, intr, max_depth_diff=max_depth_diff)
        err = _masked_median(torch.linalg.vector_norm(pts - targets, dim=-1),
                             ok)
        frac = torch.sum(ok.to(torch.float32)) / torch.clamp(
            torch.sum(point_valid.to(torch.float32)), min=1.0)
        return err, frac

    dev = points.device
    r0, frac0 = median_residual(points)
    init_R = torch.eye(3, dtype=points.dtype, device=dev)
    init_t = torch.zeros(3, dtype=points.dtype, device=dev)
    if coarse_init:
        obs = backproject_depth(depth_im, intr).reshape(-1, 3)
        obs_ok = (depth_im.reshape(-1) > 0).to(torch.float32)
        obs_c = torch.sum(obs * obs_ok[:, None], 0) / torch.clamp(
            torch.sum(obs_ok), min=1.0)
        pw = point_valid.to(torch.float32)
        pts_c = torch.sum(points * pw[:, None], 0) / torch.clamp(
            torch.sum(pw), min=1.0)
        lost = (frac0 < coarse_inlier_threshold) & (torch.sum(obs_ok) > 0)
        start_R = init_R
        start_t = torch.where(lost, obs_c - pts_c, torch.zeros_like(obs_c))
        if feat_init is not None:
            fR, ft = feat_init
            start_R = torch.where(lost, fR, start_R)
            start_t = torch.where(lost, ft, start_t)
        cR, ct = start_R, start_t
        for _ in range(iters):
            cR, ct = step(cR, ct, coarse_band)
        # the recovery pose only when lost: a healthy start keeps the
        # identity and the wide-band rounds are discarded
        init_R = torch.where(lost, cR, init_R)
        init_t = torch.where(lost, ct, init_t)
    R, t = init_R, init_t
    for _ in range(iters):
        R, t = step(R, t, max_depth_diff)
    err, frac = median_residual(points @ R.T + t)
    return RigidAlignment(
        rotation=R, translation=t, inlier_fraction=frac, residual=err,
        initial_residual=r0, initial_inlier_fraction=frac0,
    )
