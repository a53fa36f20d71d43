"""Lepard-style point-cloud matcher and its scene flow (port of
``occlusionfusion_tpu/models/lepard.py``): KPFCN features of both clouds,
the repositioning transformer, dual-softmax mutual matches, the motion
coherence filter of the matched anchors, and the matched coarse flows
blended onto every source point.

Both clouds are encoded one after the other, or with ``batched_encode``
in one pyramid and encoder pass over both (the JAX ``vmap``: the pyramid
built per cloud on a leading batch axis, then ``kpconv.merge_batch``).
The coherence filter (``coherence_tau > 0``) is on in four of the seven
matcher checkpoints' side-cars (``lepard_bridge_r5``, ``_r5b``, ``_r5d``
and ``lepard_fine_r4``). The k-NN here is ``ops/knn.knn_torch`` (the
port of the XLA ``knn_lax`` the JAX Lepard calls), not kernel K1, which
takes k = 4 for the skinning only.
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
        self.config = config
        self.kpfcn = K.KPFCN(config.kpfcn)
        self.proj = K.Linear(config.kpfcn.out_dim, config.reposition.dim)
        self.reposition = TR.RepositionTransformer(config.reposition)


def init_lepard(config: LepardConfig = LepardConfig(),
                generator: torch.Generator | None = None,
                device=None) -> LepardNet:
    """A freshly initialised matcher with the JAX ``init_lepard_params``'s
    layout and per-tensor scale (not its draws): the KPFCN's, the
    projection N(0, 1 / out_dim), the transformer's."""
    net = LepardNet(config)
    K.init_kpfcn_(net.kpfcn, generator)
    with torch.no_grad():
        net.proj.w.normal_(generator=generator).mul_(
            (1.0 / net.proj.w.shape[0]) ** 0.5)
        net.proj.b.zero_()
    TR.init_reposition_(net.reposition, generator)
    return net.to(device)


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


def _encode_pair(net: LepardNet, src_points, src_valid, tgt_points,
                 tgt_valid):
    """KPFCN features and coarse (points, valid) of both clouds:
    ((f_src, pts, valid), (f_tgt, pts, valid))."""
    config = net.config
    pyr = config.kpfcn.pyramid
    if not config.batched_encode:
        out = []
        for pts, vld in ((src_points, src_valid), (tgt_points, tgt_valid)):
            f, c = K.kpfcn_encode(net.kpfcn, K.build_pyramid(pts, vld, pyr))
            out.append((f, c.points, c.valid))
        return out
    # level 0 of each cloud alone (their sizes differ), then one pyramid
    # on the stacked pair and one encoder pass over its merged layout
    s0, sv0 = K.grid_subsample(src_points, src_valid, pyr.first_voxel,
                               pyr.level_sizes[0])
    t0, tv0 = K.grid_subsample(tgt_points, tgt_valid, pyr.first_voxel,
                               pyr.level_sizes[0])
    levels = K.build_pyramid_from_level0(torch.stack([s0, t0]),
                                         torch.stack([sv0, tv0]), pyr)
    f, c = K.kpfcn_encode(net.kpfcn, K.merge_batch(levels), batch=2)
    return list(zip(f.reshape(2, -1, f.shape[-1]), c.points.reshape(2, -1, 3),
                    c.valid.reshape(2, -1)))


def lepard_match(net: LepardNet, src_points, src_valid, tgt_points,
                 tgt_valid) -> LepardMatches:
    config = net.config
    (f_src, src_c, src_cv), (f_tgt, tgt_c, tgt_cv) = _encode_pair(
        net, src_points, src_valid, tgt_points, tgt_valid)
    f_src, f_tgt, R, t = TR.reposition_transformer(
        net.reposition, net.proj(f_src), net.proj(f_tgt), src_c, tgt_c,
        src_cv, tgt_cv)
    conf = TR.dual_softmax_confidence(f_src, f_tgt, src_cv, tgt_cv,
                                      config.reposition.temperature)
    _, match_tgt, match_valid = TR.mutual_topk_matches(
        conf, config.match_threshold)
    return LepardMatches(
        src_points=src_c, tgt_points=tgt_c, src_valid=src_cv,
        tgt_valid=tgt_cv, confidence=conf, match_tgt=match_tgt,
        match_valid=match_valid & src_cv, rigid_R=R, rigid_t=t,
    )


def motion_coherence_filter(anchor_points, anchor_flows, valid,
                            knn: int = 4, tau: float = 0.08,
                            mad_mult: float = 0.0):
    """The refined validity [S] of matched anchors: an anchor is dropped
    where its flow is further than ``tau + mad_mult * MAD`` from the
    component-wise median flow of its ``knn`` + 1 nearest valid anchors
    (itself included; MAD, the median distance of those neighbours' flows
    from that median). Anchors with ``(knn + 1) // 2`` or fewer valid
    neighbour slots keep their validity (no quorum)."""
    _, idx = knn_torch(anchor_points, anchor_points, knn + 1, valid)
    idx = idx.long()
    nb_ok = valid[idx]  # [S, k+1]
    nb_flows = anchor_flows[idx]  # [S, k+1, 3]
    med = _masked_median(nb_flows, nb_ok[..., None].expand_as(nb_flows),
                         dim=1)
    dev = torch.linalg.vector_norm(anchor_flows - med, dim=-1)
    nb_dev = torch.linalg.vector_norm(nb_flows - med[:, None, :], dim=-1)
    mad = _masked_median(nb_dev, nb_ok, dim=1)
    quorum = torch.sum(nb_ok, dim=1) > (knn + 1) // 2
    return valid & ((dev <= tau + mad_mult * mad) | ~quorum)


def _masked_median(x, mask, dim: int):
    """Median of ``x`` along ``dim`` over the ``mask`` slots only (the
    others sorted to the end as the largest float, the middle one or two
    of the valid slots taken by count); 0 where no slot is valid."""
    big = torch.full_like(x, torch.finfo(x.dtype).max)
    xs = torch.sort(torch.where(mask, x, big), dim=dim).values
    cnt = torch.sum(mask, dim=dim, keepdim=True)
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.div(cnt, 2, rounding_mode="floor")
    med = 0.5 * (torch.take_along_dim(xs, lo, dim)
                 + torch.take_along_dim(xs, hi, dim))
    return torch.where(cnt > 0, med, torch.zeros_like(med)).squeeze(dim)


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
    fixes an absolute scale) and the flows scaled back; with
    ``coherence_tau`` > 0 the coherence filter refines the matches there;
    the blend runs in metric space. Returns (flow [P, 3], mask [P],
    matches, their ``match_valid`` the refined one)."""
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
    match_valid = m.match_valid
    if config.coherence_tau > 0.0:
        # in the normalized space, where tau is scale-free
        match_valid = motion_coherence_filter(
            m.src_points, m.tgt_points[m.match_tgt] - m.src_points,
            match_valid, knn=config.coherence_knn, tau=config.coherence_tau,
            mad_mult=config.coherence_mad)
    anchor_flow = (m.tgt_points[m.match_tgt] - m.src_points) / scale
    anchor_pos = m.src_points / scale + center
    flow, mask = blend_anchor_motion(
        source_points, anchor_pos, anchor_flow, match_valid,
        knn=config.blend_knn, radius=config.blend_radius)
    return flow, mask & source_valid, m._replace(match_valid=match_valid)
