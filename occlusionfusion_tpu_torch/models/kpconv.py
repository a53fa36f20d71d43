"""KPConv point-cloud backbone, KPFCN (port of
``occlusionfusion_tpu/models/kpconv.py``).

The multi-scale pyramid (voxel-grid subsampling, radius neighbourhoods
with shadow-index padding, pooling and nearest-upsampling indices) is
built on the device at static sizes, and the KPConv layer is a gather
and one contraction over (neighbours x kernel points x channels). The
k-NN of the neighbourhoods and the upsampling is ``ops/knn.knn_torch``,
the port of the XLA ``knn_lax`` the JAX package calls here: the TPU
kernel K1 (``knn``) takes k = 4 only and stays with the skinning. The
pyramid functions take a leading batch axis (one pyramid per cloud, the
PyTorch form of JAX's ``vmap``), and ``merge_batch`` lays such a pyramid
out as one cloud for one encoder pass (Lepard's ``batched_encode``).

``grid_subsample`` hashes with uint32 wraparound as JAX does (int64
arithmetic masked to 32 bits), orders by a stable sort, and sums each
voxel's points with ``index_add_``, which adds in index order on the CPU
(as XLA's segment sum does) and with atomics on the card.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from occlusionfusion_tpu_torch.ops.knn import knn_torch

_U32 = 0xFFFFFFFF


def kernel_points(num_points: int = 15, radius: float = 1.0,
                  layout: str = "fibonacci") -> torch.Tensor:
    """[K, 3] kernel disposition, the first point at the centre:
    ``"fibonacci"``, a Fibonacci-sphere shell at 0.66 (the layout the
    shipped checkpoints use), or ``"lloyd"``, the reference's Lloyd-relaxed
    dispositions over the unit ball (``_lloyd_dispositions``)."""
    if layout == "lloyd":
        return torch.from_numpy(_lloyd_dispositions(num_points)) * radius
    if layout != "fibonacci":
        raise ValueError(f"kp_layout must be fibonacci or lloyd, got "
                         f"{layout!r}")
    n_shell = num_points - 1
    i = torch.arange(n_shell, dtype=torch.float32)
    golden = (1 + 5**0.5) / 2
    theta = 2 * math.pi * i / golden
    z = 1 - (2 * i + 1) / n_shell
    r = torch.sqrt(torch.clamp(1 - z * z, min=0.0))
    shell = torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], -1)
    pts = torch.cat([torch.zeros((1, 3)), shell * 0.66])
    return pts * radius


@functools.lru_cache(maxsize=None)
def _lloyd_dispositions(num_points: int) -> np.ndarray:
    """Lloyd (centroidal Voronoi) relaxation of ``num_points`` sites over
    the unit ball, site 0 pinned at the origin: the JAX package's numpy
    mirror of the reference's ``spherical_Lloyd``
    (``lepard/kernels/kernel_points.py:66``, fixed="center"), the same
    draws from ``RandomState(1337)`` and the same float64 arithmetic, so
    the result equals the JAX package's bit for bit. f32 [K, 3]."""
    rng = np.random.RandomState(1337)
    v = rng.randn(20000, 3)
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    cloud = (v * rng.rand(20000, 1) ** (1.0 / 3.0)).astype(np.float64)
    pts = cloud[rng.choice(len(cloud), num_points, replace=False)].copy()
    pts[0] = 0.0
    for _ in range(60):
        d2 = ((cloud[:, None] - pts[None]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for k in range(1, num_points):
            m = assign == k
            if m.any():
                pts[k] = cloud[m].mean(0)
    return pts.astype(np.float32)


def grid_subsample(points, valid, voxel: float, max_out: int):
    """Barycentre voxel subsampling -> (centres [..., max_out, 3], valid
    [..., max_out]), voxels ranked by their hash; leading axes are a batch
    of clouds, each subsampled alone."""
    lead, P = points.shape[:-2], points.shape[-2]
    pts = points.reshape(-1, P, 3)
    vld = valid.reshape(-1, P)
    B = pts.shape[0]
    coords = torch.floor(pts / voxel).to(torch.int32).long() & _U32
    h = (((coords[..., 0] * 73856093) & _U32)
         ^ ((coords[..., 1] * 19349669) & _U32)
         ^ ((coords[..., 2] * 83492791) & _U32))
    h = torch.where(vld, h, torch.full_like(h, _U32))  # invalid: one bucket
    order = torch.argsort(h, dim=-1, stable=True)
    hs = torch.gather(h, 1, order)
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=h.device),
                       hs[:, 1:] != hs[:, :-1]], dim=1)
    n_seg = max(P, max_out)
    # each cloud's voxels in a block of n_seg segments of its own
    seg = (torch.cumsum(first.long(), 1) - 1
           + torch.arange(B, device=h.device)[:, None] * n_seg).reshape(-1)
    npts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    nvalid = torch.gather(vld, 1, order)
    sums = torch.zeros((B * n_seg, 3), dtype=points.dtype,
                       device=points.device)
    sums.index_add_(0, seg, torch.where(nvalid[..., None], npts,
                                        torch.zeros_like(npts)).reshape(-1, 3))
    counts = torch.zeros(B * n_seg, dtype=points.dtype, device=points.device)
    counts.index_add_(0, seg, nvalid.reshape(-1).to(points.dtype))
    centers = (sums / torch.clamp(counts[:, None], min=1.0)).reshape(
        B, n_seg, 3)[:, :max_out]
    ok = (counts > 0).reshape(B, n_seg)[:, :max_out]
    return centers.reshape(lead + (max_out, 3)), ok.reshape(lead + (max_out,))


def build_neighbors(queries, q_valid, supports, s_valid, radius: float,
                    max_k: int):
    """[..., Q, max_k] int64 indices into supports [..., S, 3] within
    ``radius``; the shadow index S fills the rest."""
    S = supports.shape[-2]
    d2, idx = knn_torch(queries, supports, min(max_k, S), s_valid)
    ok = (d2 <= radius * radius) & q_valid[..., None]
    out = torch.where(ok, idx.long(), torch.full_like(idx, S, dtype=torch.long))
    if out.shape[-1] < max_k:
        out = F.pad(out, (0, max_k - out.shape[-1]), value=S)
    return out


def kpconv(feats, supports, queries, neighbors, weights, kp, kp_sigma: float):
    """Kernel-point convolution, linear influence relu(1 - d / sigma),
    summed: feats [S, Cin] -> [Q, Cout]."""
    Q, n = neighbors.shape
    K, C, D = weights.shape
    feats_pad = torch.cat([feats, feats.new_zeros((1, C))])
    sup_pad = torch.cat([supports, supports.new_full((1, 3), 1e6)])
    nb_feats = feats_pad[neighbors]  # [Q, n, C]
    nb_pos = sup_pad[neighbors] - queries[:, None, :]
    d = torch.linalg.vector_norm(nb_pos[:, :, None, :] - kp[None, None],
                                 dim=-1)  # [Q, n, K]
    infl = torch.clamp(1.0 - d / kp_sigma, min=0.0)
    wf = torch.einsum("qnk,qnc->qkc", infl, nb_feats)
    return wf.reshape(Q, K * C) @ weights.reshape(K * C, D)


class PyramidLevel(NamedTuple):
    points: torch.Tensor  # [P_l, 3]
    valid: torch.Tensor  # [P_l]
    neighbors: torch.Tensor  # [P_l, n_max] self-neighbourhood
    pool: torch.Tensor = None  # [P_{l+1}, n_max] from level l
    up: torch.Tensor = None  # [P_l] nearest in level l+1


class PyramidConfig(NamedTuple):
    level_sizes: Sequence[int] = (4096, 1024, 256, 64)
    first_voxel: float = 0.025
    radius_scale: float = 2.5
    max_neighbors: Sequence[int] = (26, 28, 30, 30)


def calibrate_neighbor_limits(clouds, config: PyramidConfig,
                              keep_ratio: float = 0.8, hist_cap: int = 64,
                              samples_threshold: int = 2000) -> PyramidConfig:
    """``config`` with per-level ``max_neighbors`` calibrated from sample
    clouds (an iterable of (points [P, 3], valid [P]) arrays), as the
    reference's ``calibrate_neighbors`` (``lepard/datasets/
    dataloader.py:563-590``) and the JAX function: the pyramid built with
    ``hist_cap`` slots, a histogram of the true radius-neighbourhood sizes
    of the valid points per level, and each level's limit the count below
    which ``keep_ratio`` of that neighbour mass lies. Stops once every
    level has seen ``samples_threshold`` neighbourhoods. The pyramids are
    built on the CPU."""
    n_levels = len(config.level_sizes)
    hists = np.zeros((n_levels, hist_cap + 1), np.int64)
    probe = config._replace(max_neighbors=(hist_cap,) * n_levels)
    for pts, vld in clouds:
        levels = build_pyramid(torch.as_tensor(np.asarray(pts, np.float32)),
                               torch.as_tensor(np.asarray(vld, bool)), probe)
        for l, lev in enumerate(levels):
            S = lev.points.shape[0]
            counts = torch.sum(lev.neighbors < S, dim=1).numpy()
            counts = counts[lev.valid.numpy()]
            hists[l] += np.bincount(np.clip(counts, 0, hist_cap),
                                    minlength=hist_cap + 1)
        if hists.sum(axis=1).min() > samples_threshold:
            break
    cumsum = np.cumsum(hists.T, axis=0)
    limits = np.maximum(np.sum(cumsum < keep_ratio * cumsum[-1], axis=0), 1)
    return config._replace(max_neighbors=tuple(int(x) for x in limits))


def build_pyramid(points, valid, config: PyramidConfig):
    """Level 0 by ``grid_subsample`` at ``first_voxel``, then the rest.
    Leading axes of ``points`` [..., P, 3] are a batch of clouds, each
    with its own pyramid (``merge_batch`` makes one cloud of them)."""
    pts, vld = grid_subsample(points, valid, config.first_voxel,
                              config.level_sizes[0])
    return build_pyramid_from_level0(pts, vld, config)


def build_pyramid_from_level0(pts, vld, config: PyramidConfig):
    """Each level's radius neighbourhood; between levels a subsample at
    twice the voxel, the pooling neighbourhoods and the 1-NN upsampling
    index."""
    levels = []
    voxel = config.first_voxel
    n_levels = len(config.level_sizes)
    for l in range(n_levels):
        radius = voxel * config.radius_scale
        nmax = config.max_neighbors[l]
        nb = build_neighbors(pts, vld, pts, vld, radius, nmax)
        if l + 1 < n_levels:
            voxel2 = voxel * 2
            pts2, vld2 = grid_subsample(pts, vld, voxel2,
                                        config.level_sizes[l + 1])
            pool = build_neighbors(pts2, vld2, pts, vld, radius, nmax)
            up = knn_torch(pts, pts2, 1, vld2)[1][..., 0].long()
            levels.append(PyramidLevel(pts, vld, nb, pool, up))
            pts, vld, voxel = pts2, vld2, voxel2
        else:
            levels.append(PyramidLevel(pts, vld, nb))
    return levels


def merge_batch(levels):
    """A pyramid of B clouds (``build_pyramid`` on [B, P, 3]) as one cloud
    of their points, cloud after cloud at every level: each cloud's
    neighbour, pooling and upsampling indices offset by its first point
    there, its shadow indices moved to the merged level's shadow. The
    encoder then runs once over both (``kpfcn_encode(..., batch=B)``)."""
    out = []
    for l, lv in enumerate(levels):
        B, P = lv.points.shape[:2]
        dev = lv.points.device
        b = torch.arange(B, device=dev)

        def merged(idx, n):
            # indices [B, Q, k] into a level of n points a cloud, shadow n
            return torch.where(idx == n, B * n,
                               idx + (b * n)[:, None, None]).reshape(
                                   -1, idx.shape[-1])

        pool = up = None
        if lv.pool is not None:
            pool = merged(lv.pool, P)
            up = (lv.up + (b * levels[l + 1].points.shape[1])[:, None]
                  ).reshape(-1)
        out.append(PyramidLevel(lv.points.reshape(-1, 3),
                                lv.valid.reshape(-1),
                                merged(lv.neighbors, P), pool, up))
    return out


def _group_norm(x, valid, groups: int = 8, eps: float = 1e-5,
                batch: int = 1):
    """Group norm over the valid points (8 groups, no affine), of each of
    the ``batch`` clouds that ``x`` [batch * P, C] holds one after the
    other on its own."""
    C = x.shape[-1]
    g = x.reshape(batch, -1, groups, C // groups)
    m = valid.reshape(batch, -1)[:, :, None, None]
    zero = torch.zeros_like(g)
    count = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1).to(
        x.dtype) * (C // groups)
    mean = torch.sum(torch.where(m, g, zero), dim=(1, 3), keepdim=True) / count
    var = torch.sum(torch.where(m, (g - mean) ** 2, zero), dim=(1, 3),
                    keepdim=True) / count
    return ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


class Linear(nn.Module):
    """x @ w + b with the JAX layout: w [in, out]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.w + self.b


class KernelWeights(nn.Module):
    """KPConv weights [K, Cin, Cout] (the JAX ``{"weights": ...}``)."""

    def __init__(self, K: int, cin: int, cout: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(K, cin, cout))


class ResnetB(nn.Module):
    """Bottleneck residual KPConv block: 1x1 down, KPConv, 1x1 up, plus a
    1x1 skip (max-pooled over the pooling neighbourhood when strided)."""

    def __init__(self, cin: int, cmid: int, cout: int, K: int):
        super().__init__()
        self.down = Linear(cin, cmid)
        self.conv = KernelWeights(K, cmid, cmid)
        self.up = Linear(cmid, cout)
        self.skip = Linear(cin, cout)

    def forward(self, feats, supports: PyramidLevel, queries: PyramidLevel,
                neighbors, kp, sigma, batch: int = 1):
        x = _lrelu(_group_norm(self.down(feats), supports.valid,
                               batch=batch))
        x = kpconv(x, supports.points, queries.points, neighbors,
                   self.conv.weights, kp, sigma)
        x = self.up(_lrelu(_group_norm(x, queries.valid, batch=batch)))
        skip = self.skip(feats)
        if queries.points.shape[0] != supports.points.shape[0]:
            fpad = torch.cat([skip, skip.new_full((1, skip.shape[1]), -1e9)])
            skip = torch.amax(fpad[neighbors], dim=1)
            skip = torch.where(torch.isfinite(skip), skip,
                               torch.zeros_like(skip))
        return _lrelu(x + skip)


class KPFCNConfig(NamedTuple):
    in_dim: int = 1
    first_dim: int = 128
    out_dim: int = 528
    num_kernel_points: int = 15
    blocks_per_stage: int = 1
    num_stages: int = 2
    coarse_upsamples: int = 0
    kp_layout: str = "fibonacci"
    pyramid: PyramidConfig = PyramidConfig()


def full_depth_config(**overrides) -> KPFCNConfig:
    """The reference-depth KPFCN (``lepard/configs/models.py:3-21``):
    three strided stages of two resnetb blocks, the decoder upsampling
    once, so the coarse output sits at pyramid level 2."""
    return KPFCNConfig(blocks_per_stage=2, num_stages=3, coarse_upsamples=1,
                       **overrides)


class _Stage(nn.Module):
    def __init__(self, cin: int, cout: int, blocks: int, K: int):
        super().__init__()
        self.res = nn.ModuleList(
            [ResnetB(cin, cin // 2, cin, K) for _ in range(blocks)])
        self.strided = ResnetB(cin, cin // 2, cout, K)


class KPFCN(nn.Module):
    """The encoder (stem, ``num_stages`` stages of resnetb blocks and a
    strided block, a final block) and ``coarse_upsamples`` nearest-
    upsample decoder blocks; parameter names follow the JAX tree."""

    def __init__(self, config: KPFCNConfig):
        super().__init__()
        self.config = config
        K, d = config.num_kernel_points, config.first_dim
        self.register_buffer("kp_unit",
                             kernel_points(K, 1.0, config.kp_layout),
                             persistent=False)
        self.stem = KernelWeights(K, config.in_dim, d)
        stages = []
        cin = d
        for l in range(config.num_stages):
            cout = d * 2 ** (l + 1)
            stages.append(_Stage(cin, cout, config.blocks_per_stage, K))
            cin = cout
        self.enc = nn.ModuleList(stages)
        self.final_res = ResnetB(cin, cin // 2, cin, K)
        n = config.num_stages
        dec, c = [], cin
        for u in range(config.coarse_upsamples):
            skip_c = d * 2 ** (n - 1 - u)
            dec.append(Linear(c + skip_c, skip_c))
            c = skip_c
        self.dec = nn.ModuleList(dec)
        self.out = Linear(d * 2 ** (n - config.coarse_upsamples),
                          config.out_dim)


def kpfcn_encode(net: KPFCN, levels, batch: int = 1):
    """(features [P_coarse, out_dim], the coarse PyramidLevel). With
    ``batch`` B the levels are ``merge_batch``'s of B clouds: the
    features and the level hold the clouds one after the other, and the
    group norms take each cloud alone."""
    config = net.config
    voxel = config.pyramid.first_voxel
    sigma = voxel * 1.2
    l0 = levels[0]
    x = kpconv(l0.points.new_ones((l0.points.shape[0], config.in_dim)),
               l0.points, l0.points, l0.neighbors, net.stem.weights,
               net.kp_unit * sigma, sigma)
    x = _lrelu(_group_norm(x, l0.valid, batch=batch))
    skips = []
    for l, stage in enumerate(net.enc):
        level, nxt = levels[l], levels[l + 1]
        sigma = voxel * 1.2
        kp = net.kp_unit * sigma
        for block in stage.res:
            x = block(x, level, level, level.neighbors, kp, sigma, batch)
        skips.append(x)
        x = stage.strided(x, level, nxt, level.pool, kp, sigma, batch)
        voxel *= 2
    deep = levels[config.num_stages]
    sigma = voxel * 1.2
    x = net.final_res(x, deep, deep, deep.neighbors, net.kp_unit * sigma,
                      sigma, batch)
    coarse_idx = config.num_stages
    for u, lin in enumerate(net.dec):
        coarse_idx = config.num_stages - 1 - u
        lvl = levels[coarse_idx]
        x = torch.cat([x[lvl.up], skips[coarse_idx]], dim=-1)
        x = _lrelu(_group_norm(lin(x), lvl.valid, batch=batch))
    return net.out(x), levels[coarse_idx]


def init_kpfcn_(net: KPFCN, generator: torch.Generator | None = None):
    """Initialise a KPFCN in place with the JAX ``init_kpfcn_params``'s
    per-tensor scale (not its draws): linear weights N(0, 2 / C_in), KPConv
    weights N(0, 2 / (K C_in)), zero biases."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Linear):
                m.w.normal_(generator=generator).mul_(
                    (2.0 / m.w.shape[0]) ** 0.5)
                m.b.zero_()
            elif isinstance(m, KernelWeights):
                K, cin = m.weights.shape[:2]
                m.weights.normal_(generator=generator).mul_(
                    (2.0 / (K * cin)) ** 0.5)
    return net
