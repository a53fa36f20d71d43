"""Repositioning transformer with volumetric rotary position encoding
(port of ``occlusionfusion_tpu/models/transformer3d.py``).

Interleaved self, cross and positioning layers over the two clouds'
coarse features. A positioning layer matches (dual softmax), fits a
rigid transform by soft Procrustes (``geometry/kabsch.weighted_kabsch``,
which takes no host sync, so a CUDA graph captures it), rewarps the
source points and recomputes their rotary encoding. Attention is dense
with padding masks. ``sinkhorn_confidence``, the entropic optimal
transport alternative to the dual softmax, has no caller on the fused
path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from occlusionfusion_tpu_torch.geometry.kabsch import weighted_kabsch
from occlusionfusion_tpu_torch.models.kpconv import Linear

_NEG = -1e30


def rotary_pe_3d(points, feature_dim: int, voxel: float = 0.08):
    """[P, 3] -> (cos, sin) [P, 3 * (D // 6)]: D // 6 frequencies per
    axis of the voxelized coordinates."""
    d_axis = feature_dim // 6
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        d_axis, dtype=torch.float32, device=points.device) / d_axis)
    angles = (points / voxel)[:, :, None] * freq[None, None, :]
    angles = angles.reshape(points.shape[0], -1)
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """Rotate the feature pairs (x[:d2], x[d2:2 d2]) of x [P, D]."""
    d2 = cos.shape[-1]
    x1, x2 = x[..., :d2], x[..., d2 : 2 * d2]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos,
                      x[..., 2 * d2 :]], dim=-1)


def _layer_norm(x, scale, bias, eps=1e-5):
    m = torch.mean(x, -1, keepdim=True)
    v = torch.var(x, -1, keepdim=True, unbiased=False)
    return (x - m) / torch.sqrt(v + eps) * scale + bias


class AttentionLayer(nn.Module):
    """Multi-head attention and a gated MLP (parameter names as in the
    JAX tree)."""

    def __init__(self, dim: int):
        super().__init__()
        for name in ("q", "k", "v", "merge"):
            setattr(self, name, Linear(dim, dim))
        self.mlp1 = Linear(2 * dim, 2 * dim)
        self.mlp2 = Linear(2 * dim, dim)
        self.norm1_scale = nn.Parameter(torch.ones(dim))
        self.norm1_bias = nn.Parameter(torch.zeros(dim))
        self.norm2_scale = nn.Parameter(torch.ones(dim))
        self.norm2_bias = nn.Parameter(torch.zeros(dim))


def attention_layer(p: AttentionLayer, x, source, x_valid, source_valid,
                    heads: int = 4, x_rope=None, source_rope=None):
    """x [P, D] attends to source [S, D] (invalid sources masked); the
    output is 0 on invalid rows of x."""
    P, D = x.shape
    dh = D // heads
    q, k, v = p.q(x), p.k(source), p.v(source)
    if x_rope is not None:
        q = apply_rotary(q, *x_rope)
    if source_rope is not None:
        k = apply_rotary(k, *source_rope)
    q = q.reshape(P, heads, dh)
    k = k.reshape(-1, heads, dh)
    v = v.reshape(-1, heads, dh)
    logits = torch.einsum("phd,shd->hps", q, k) / math.sqrt(dh)
    logits = torch.where(source_valid[None, None, :], logits,
                         torch.full_like(logits, _NEG))
    attn = torch.softmax(logits, dim=-1)
    msg = torch.einsum("hps,shd->phd", attn, v).reshape(P, D)
    msg = _layer_norm(p.merge(msg), p.norm1_scale, p.norm1_bias)
    h = F.gelu(p.mlp1(torch.cat([x, msg], dim=-1)), approximate="tanh")
    h = _layer_norm(p.mlp2(h), p.norm2_scale, p.norm2_bias)
    out = x + h
    return torch.where(x_valid[:, None], out, torch.zeros_like(out))


def _unit_rows(f):
    return f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                           min=1e-8)


def dual_softmax_confidence(feats_src, feats_tgt, src_valid, tgt_valid,
                            temperature: float = 0.1):
    """[S, T] dual-softmax match confidence, 0 off the valid pairs."""
    sim = (_unit_rows(feats_src) @ _unit_rows(feats_tgt).T) / temperature
    pair = src_valid[:, None] & tgt_valid[None, :]
    sim = torch.where(pair, sim, torch.full_like(sim, _NEG))
    conf = torch.softmax(sim, dim=0) * torch.softmax(sim, dim=1)
    return torch.where(pair, conf, torch.zeros_like(conf))


def sinkhorn_confidence(feats_src, feats_tgt, src_valid, tgt_valid,
                        temperature: float = 0.1, iters: int = 3,
                        dustbin_score: float | None = None):
    """[S, T] entropic optimal-transport confidence, ``iters`` Sinkhorn
    iterations in log space, 0 off the valid pairs. With
    ``dustbin_score`` a slack row and column of that score absorb the
    unmatched mass (each may take the whole other side's); without it the
    padding masks do."""
    M = (_unit_rows(feats_src) @ _unit_rows(feats_tgt).T) / temperature
    pair = src_valid[:, None] & tgt_valid[None, :]
    M = torch.where(pair, M, torch.full_like(M, _NEG))
    S, T = M.shape
    src_m, tgt_m = src_valid, tgt_valid
    log_a = torch.where(src_m, 0.0, _NEG)
    log_b = torch.where(tgt_m, 0.0, _NEG)
    if dustbin_score is not None:
        M = torch.cat([M, M.new_full((S, 1), dustbin_score)], dim=1)
        M = torch.cat([M, M.new_full((1, T + 1), dustbin_score)], dim=0)
        one = src_valid.new_ones(1)
        src_m, tgt_m = torch.cat([src_m, one]), torch.cat([tgt_m, one])

        def mass(v):
            return torch.log(torch.clamp(torch.sum(v).to(M.dtype),
                                         min=1.0))[None]

        log_a = torch.cat([log_a, mass(tgt_valid)])
        log_b = torch.cat([log_b, mass(src_valid)])
    u = M.new_zeros(M.shape[0])
    v = M.new_zeros(M.shape[1])
    for _ in range(iters):
        u = log_a - torch.logsumexp(M + v[None, :], dim=1)
        u = torch.where(src_m, u, torch.zeros_like(u))
        v = log_b - torch.logsumexp(M + u[:, None], dim=0)
        v = torch.where(tgt_m, v, torch.zeros_like(v))
    P = torch.exp(M + u[:, None] + v[None, :])[:S, :T]
    return torch.where(pair, P, torch.zeros_like(P))


def mutual_topk_matches(conf, threshold: float = 0.05):
    """(src_idx [S], tgt_idx [S], valid [S]): each source row's best
    target (first index among ties), valid iff mutual and above
    ``threshold``."""
    best_tgt = torch.argmax(conf, dim=1)
    best_src = torch.argmax(conf, dim=0)
    rows = torch.arange(conf.shape[0], device=conf.device)
    mutual = best_src[best_tgt] == rows
    peak = torch.gather(conf, 1, best_tgt[:, None])[:, 0]
    return rows, best_tgt, mutual & (peak > threshold)


def soft_procrustes(conf, src_points, tgt_points):
    """Rigid fit of each source point to its confidence-weighted target
    barycentre, weighted by the row masses."""
    row_mass = torch.sum(conf, dim=1)
    targets = (conf @ tgt_points) / torch.clamp(row_mass, min=1e-9)[:, None]
    return weighted_kabsch(src_points, targets, row_mass)


class RepositionConfig(NamedTuple):
    dim: int = 256
    heads: int = 4
    layer_types: Sequence[str] = (
        "self", "cross", "positioning", "self", "cross")
    rope_voxel: float = 0.08
    temperature: float = 0.1


class RepositionTransformer(nn.Module):
    """``layers[i]`` holds ``src`` and ``tgt`` attention layers, or nothing
    for a positioning layer."""

    def __init__(self, config: RepositionConfig):
        super().__init__()
        self.config = config
        layers = []
        for lt in config.layer_types:
            if lt not in ("self", "cross", "positioning"):
                raise ValueError(lt)
            layers.append(nn.ModuleDict() if lt == "positioning" else
                          nn.ModuleDict({"src": AttentionLayer(config.dim),
                                         "tgt": AttentionLayer(config.dim)}))
        self.layers = nn.ModuleList(layers)


def reposition_transformer(net: RepositionTransformer, src_feats, tgt_feats,
                           src_points, tgt_points, src_valid, tgt_valid):
    """(src_feats, tgt_feats, R, t): the features after the layers and the
    last positioning layer's rigid estimate (identity without one)."""
    config = net.config
    dev = src_points.device
    R = torch.eye(3, dtype=torch.float32, device=dev)
    t = torch.zeros(3, dtype=torch.float32, device=dev)
    cur_src_pos = src_points
    rope_tgt = rotary_pe_3d(tgt_points, config.dim, config.rope_voxel)
    for lt, p in zip(config.layer_types, net.layers):
        if lt == "self":
            rope_src = rotary_pe_3d(cur_src_pos, config.dim,
                                    config.rope_voxel)
            src_feats = attention_layer(
                p["src"], src_feats, src_feats, src_valid, src_valid,
                config.heads, rope_src, rope_src)
            tgt_feats = attention_layer(
                p["tgt"], tgt_feats, tgt_feats, tgt_valid, tgt_valid,
                config.heads, rope_tgt, rope_tgt)
        elif lt == "cross":
            new_src = attention_layer(p["src"], src_feats, tgt_feats,
                                      src_valid, tgt_valid, config.heads)
            tgt_feats = attention_layer(p["tgt"], tgt_feats, src_feats,
                                        tgt_valid, src_valid, config.heads)
            src_feats = new_src
        else:
            conf = dual_softmax_confidence(src_feats, tgt_feats, src_valid,
                                           tgt_valid, config.temperature)
            R, t = soft_procrustes(conf, src_points, tgt_points)
            cur_src_pos = src_points @ R.T + t
    return src_feats, tgt_feats, R, t


def init_reposition_(net: RepositionTransformer,
                     generator: torch.Generator | None = None):
    """Initialise the transformer in place with the JAX
    ``init_attention_params``'s scale (not its draws): linear weights
    N(0, 1 / C_in), zero biases, layer norms 1 and 0."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Linear):
                m.w.normal_(generator=generator).mul_(
                    (1.0 / m.w.shape[0]) ** 0.5)
                m.b.zero_()
            elif isinstance(m, AttentionLayer):
                m.norm1_scale.fill_(1.0)
                m.norm2_scale.fill_(1.0)
                m.norm1_bias.zero_()
                m.norm2_bias.zero_()
    return net
