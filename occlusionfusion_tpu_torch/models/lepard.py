"""Lepard-style point-cloud matcher and its scene flow (port of
``occlusionfusion_tpu/models/lepard.py``): KPFCN features of both clouds,
the repositioning transformer, dual-softmax mutual matches, and the
matched coarse flows blended onto every source point.

Unbatched: the JAX ``batched_encode`` (the same maths over a stacked
pair) and the ``motion_coherence_filter`` (``coherence_tau > 0``, off in
the shipped checkpoints) are not ported and raise. The k-NN here is
``ops/knn.knn_torch`` (the port of the XLA ``knn_lax`` the JAX Lepard
calls), not kernel K1, which takes k = 4 for the skinning only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from occlusionfusion_tpu_torch.models import kpconv as K
from occlusionfusion_tpu_torch.models import transformer3d as TR
from occlusionfusion_tpu_torch.ops.knn import knn_torch


class LepardConfig(NamedTuple):
    kpfcn: K.KPFCNConfig = K.KPFCNConfig()
    reposition: TR.RepositionConfig = TR.RepositionConfig()
    match_threshold: float = 0.05
    blend_knn: int = 3
    blend_radius: float = 0.1
    batched_encode: bool = False
    coherence_tau: float = 0.0
    coherence_knn: int = 4
    coherence_mad: float = 0.0


class LepardNet(nn.Module):
    """``kpfcn``, ``proj`` and ``reposition``, named as the JAX tree."""

    def __init__(self, config: LepardConfig):
        super().__init__()
        if config.batched_encode:
            raise NotImplementedError("batched_encode is not ported")
        if config.coherence_tau > 0.0:
            raise NotImplementedError(
                "motion_coherence_filter (coherence_tau > 0) is not ported")
        self.config = config
        self.kpfcn = K.KPFCN(config.kpfcn)
        self.proj = K.Linear(config.kpfcn.out_dim, config.reposition.dim)
        self.reposition = TR.RepositionTransformer(config.reposition)


class LepardMatches(NamedTuple):
    src_points: torch.Tensor  # [S, 3] coarse source points
    tgt_points: torch.Tensor  # [T, 3] coarse target points
    src_valid: torch.Tensor
    tgt_valid: torch.Tensor
    confidence: torch.Tensor  # [S, T]
    match_tgt: torch.Tensor  # [S] best target per source
    match_valid: torch.Tensor  # [S] mutual + confident
    rigid_R: torch.Tensor  # [3, 3]
    rigid_t: torch.Tensor  # [3]


def lepard_match(net: LepardNet, src_points, src_valid, tgt_points,
                 tgt_valid) -> LepardMatches:
    config = net.config
    pyr = config.kpfcn.pyramid
    f_src, src_c = K.kpfcn_encode(net.kpfcn,
                                  K.build_pyramid(src_points, src_valid, pyr))
    f_tgt, tgt_c = K.kpfcn_encode(net.kpfcn,
                                  K.build_pyramid(tgt_points, tgt_valid, pyr))
    f_src, f_tgt, R, t = TR.reposition_transformer(
        net.reposition, net.proj(f_src), net.proj(f_tgt), src_c.points,
        tgt_c.points, src_c.valid, tgt_c.valid)
    conf = TR.dual_softmax_confidence(f_src, f_tgt, src_c.valid, tgt_c.valid,
                                      config.reposition.temperature)
    _, match_tgt, match_valid = TR.mutual_topk_matches(
        conf, config.match_threshold)
    return LepardMatches(
        src_points=src_c.points, tgt_points=tgt_c.points,
        src_valid=src_c.valid, tgt_valid=tgt_c.valid, confidence=conf,
        match_tgt=match_tgt, match_valid=match_valid & src_c.valid,
        rigid_R=R, rigid_t=t,
    )


def blend_anchor_motion(query_points, anchor_points, anchor_flows,
                        anchor_valid, knn: int = 3, radius: float = 0.1):
    """Inverse-squared-distance blend of the ``knn`` nearest valid anchor
    flows; a query needs all of them within ``radius``. Returns
    (flow [Q, 3], mask [Q])."""
    d2, idx = knn_torch(query_points, anchor_points, knn, anchor_valid)
    in_range = d2 <= radius * radius
    w = torch.where(in_range, 1.0 / torch.clamp(d2, min=1e-10),
                    torch.zeros_like(d2))
    wsum = torch.sum(w, dim=1, keepdim=True)
    flow = torch.sum(anchor_flows[idx.long()] * w[..., None], dim=1) / (
        torch.clamp(wsum, min=1e-10))
    mask = torch.all(in_range, dim=1) & (wsum[:, 0] > 0)
    return torch.where(mask[:, None], flow, torch.zeros_like(flow)), mask


def scene_flow(net: LepardNet, source_points, source_valid, target_points,
               target_valid, normalize_radius: float = 0.3):
    """Match the clouds, then blend the matched coarse flows onto every
    source point. Both clouds are rescaled about their joint centroid to
    the RMS radius ``normalize_radius`` before matching (KPConv's voxel
    fixes an absolute scale) and the flows scaled back; the blend runs
    in metric space. Returns (flow [P, 3], mask [P], matches)."""
    config = net.config
    both = torch.cat([source_points, target_points])
    w = torch.cat([source_valid, target_valid]).to(torch.float32)[:, None]
    n = torch.clamp(torch.sum(w), min=1.0)
    center = torch.sum(both * w, dim=0) / n
    rms = torch.sqrt(
        torch.sum(torch.sum((both - center) ** 2, -1) * w[:, 0]) / n)
    scale = normalize_radius / torch.clamp(rms, min=1e-6)
    m = lepard_match(net, (source_points - center) * scale, source_valid,
                     (target_points - center) * scale, target_valid)
    anchor_flow = (m.tgt_points[m.match_tgt] - m.src_points) / scale
    anchor_pos = m.src_points / scale + center
    flow, mask = blend_anchor_motion(
        source_points, anchor_pos, anchor_flow, m.match_valid,
        knn=config.blend_knn, radius=config.blend_radius)
    return flow, mask & source_valid, m
