"""End-to-end differentiable tracking training: PWC-Net + MaskNet trained
through the Gauss-Newton warp solve (port of
``occlusionfusion_tpu/models/tracking_train.py``).

The NeuralTracking idea (``model/model.py:59-86``, ``:865-1537``;
DeformLoss ``model/loss.py:27-71``): the flow net's lifted targets and
MaskNet's correspondence weights enter a dense GN solve over the
embedded-deformation node transforms, and the graph and warp losses
backpropagate through the solve into both nets. MaskNet's continuous
weights enter the residuals directly as ``point_valid``; match pixels
are pre-sampled to a fixed count with a validity mask.

Why the port trains through K3'/K4' where JAX trains through XLA blocks:
the JAX trainer forces ``assembly="blocks"`` because its Pallas kernels
have no VJP. The port has one assembly route, the kernels K3' and K4' on
the card, and ``solve_dense`` takes a differentiable branch when an input
requires grad: each iteration's (M, b, sq) come from
``ops/gn_assembly.PointTermAssembly`` / ``ArapTermAssembly``, whose
forward is the kernel and whose backward is the twin's vector-Jacobian
product. Both packages differentiate the same function, the
``_assemble_blocks("blocks")`` system (ROADMAP F1: K3' and its twin
follow "blocks", not the TPU kernel), so the gradients agree.

The JAX package vmaps over the batch; the port loops over the samples
and reduces the same way: the mean of the per-sample totals, and each
loss term averaged over the samples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from occlusionfusion_tpu_torch.device import resolve_device
from occlusionfusion_tpu_torch.fusion.flow_correspondence import (
    flow_correspondences,
)
from occlusionfusion_tpu_torch.models.deform_loss import (
    DeformLossWeights,
    graph_l2,
    robust_l1,
)
from occlusionfusion_tpu_torch.models.flow_train import masked_bce
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig, GNProblem
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import solve_dense


class TrackingSample(NamedTuple):
    """One training pair with its deformation graph and ground truth (a
    leading batch axis after ``stack_samples``)."""

    src_rgbxyz: torch.Tensor  # [6, H, W] source RGB + point image
    tgt_rgbxyz: torch.Tensor  # [6, H, W]
    flow_gt: torch.Tensor  # [H, W, 2] full-res pixel flow
    flow_valid: torch.Tensor  # [H, W]
    mask_gt: torch.Tensor  # [H, W] 1 = correspondence trustworthy
    match_idx: torch.Tensor  # [M] flat pixel index into H*W
    match_valid: torch.Tensor  # [M]
    source_points: torch.Tensor  # [M, 3] backprojected source pixels
    anchors: torch.Tensor  # [M, K] node ids
    skin_weights: torch.Tensor  # [M, K]
    gt_warped: torch.Tensor  # [M, 3] GT deformed source points
    nodes: torch.Tensor  # [N, 3]
    node_valid: torch.Tensor  # [N]
    edges: torch.Tensor  # [N, Ke]
    edge_weights: torch.Tensor  # [N, Ke]
    gt_node_trans: torch.Tensor  # [N, 3]
    intrinsics: torch.Tensor  # [4] fx, fy, cx, cy


def tracking_forward(pwc, mask_net, sample: TrackingSample, gn: GNConfig):
    """flow net -> lifted 3-D targets -> MaskNet weights -> GN solve from
    the identity. Returns (flow [H, W, 2], mask weights [H, W],
    point_valid [M], GNResult), differentiable in both nets."""
    flow, lifted, valid, weights = flow_correspondences(
        pwc, sample.src_rgbxyz, sample.tgt_rgbxyz, mask_net=mask_net)
    idx = sample.match_idx.long()
    targets = lifted.reshape(-1, 3)[idx]
    point_valid = (weights.reshape(-1)[idx]
                   * valid.reshape(-1)[idx].to(torch.float32)
                   * sample.match_valid.to(torch.float32))
    n = sample.nodes.shape[0]
    dev = sample.nodes.device
    problem = GNProblem(
        source_points=sample.source_points,
        point_anchors=sample.anchors,
        point_weights=sample.skin_weights,
        target_points=targets,
        point_valid=point_valid,
        nodes=sample.nodes,
        node_valid=sample.node_valid,
        edges=sample.edges,
        edge_weights=sample.edge_weights,
        motion_targets=torch.zeros_like(sample.nodes),
        motion_confidence=torch.zeros(n, dtype=torch.float32, device=dev),
        solve_node_mask=sample.node_valid,
        intrinsics=sample.intrinsics,
    )
    result = solve_dense(
        problem, gn, torch.eye(3, device=dev).expand(n, 3, 3).contiguous(),
        torch.zeros((n, 3), device=dev))
    return flow, weights, point_valid, result


def tracking_loss(pwc, mask_net, sample: TrackingSample, gn: GNConfig,
                  weights: DeformLossWeights = DeformLossWeights()):
    """DeformLoss: flow + graph + warp (+ MaskNet BCE, at weight
    min(lambda_mask, 1): a masked mean, where the reference's 1000
    compensates an unmasked one). Returns (total, dict of the unweighted
    terms)."""
    flow, mask_w, _, result = tracking_forward(pwc, mask_net, sample, gn)
    terms = {
        "flow": robust_l1(flow, sample.flow_gt, sample.flow_valid),
        "graph": graph_l2(result.translations, sample.gt_node_trans,
                          sample.node_valid),
        "warp": robust_l1(result.warped_points, sample.gt_warped,
                          sample.match_valid),
    }
    total = (weights.lambda_flow * terms["flow"]
             + weights.lambda_graph * terms["graph"]
             + weights.lambda_warp * terms["warp"])
    if mask_net is not None:
        terms["mask"] = masked_bce(mask_w, sample.mask_gt, sample.flow_valid)
        total = total + min(weights.lambda_mask, 1.0) * terms["mask"]
    return total, terms


def unstack(batch: TrackingSample):
    """The samples of a stacked batch."""
    return [TrackingSample(*(f[i] for f in batch))
            for i in range(batch.nodes.shape[0])]


def batch_loss(pwc, mask_net, batch: TrackingSample, gn: GNConfig,
               weights: DeformLossWeights = DeformLossWeights()):
    """(mean of the per-sample totals, each term's mean) over a stacked
    batch."""
    totals, terms = [], {}
    for sample in unstack(batch):
        total, t = tracking_loss(pwc, mask_net, sample, gn, weights)
        totals.append(total)
        for k, v in t.items():
            terms.setdefault(k, []).append(v)
    return (torch.mean(torch.stack(totals)),
            {k: torch.mean(torch.stack(v)) for k, v in terms.items()})


def make_tracking_train_step(pwc, optimizer, gn: GNConfig, mask_net=None,
                             weights: DeformLossWeights = DeformLossWeights()):
    """``step(batch) -> (loss, terms)``: one optimiser step on the mean
    DeformLoss of a stacked batch, through the solve into both nets."""

    def train_step(batch: TrackingSample):
        optimizer.zero_grad()
        loss, terms = batch_loss(pwc, mask_net, batch, gn, weights)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in terms.items()}

    return train_step


def epe3d(pwc, mask_net, sample: TrackingSample, gn: GNConfig):
    """EPE-3D of the solver's warped points against the GT over the valid
    matches (the reference's eval metric)."""
    _, _, _, result = tracking_forward(pwc, mask_net, sample, gn)
    err = torch.linalg.vector_norm(result.warped_points - sample.gt_warped,
                                   dim=-1)
    m = sample.match_valid.to(torch.float32)
    return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)


# ---------------------------------------------------------------------------
# synthetic data: consistent RGB-D pairs, a graph and the GT warp (numpy
# with the JAX module's draws; the k-NN on the device)


def _smooth_field(rng, H, W, channels, scale, cells=4):
    coarse = rng.randn(cells, cells, channels).astype(np.float32) * scale
    ys = np.linspace(0, cells - 1 - 1e-4, H)
    xs = np.linspace(0, cells - 1 - 1e-4, W)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    return (
        c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
        + c10 * fy * (1 - fx) + c11 * fy * fx
    )


def _bilinear(img, y, x):
    H, W = img.shape[:2]
    x0 = np.clip(np.floor(x).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, H - 2)
    fx = np.clip(x - x0, 0, 1)[..., None]
    fy = np.clip(y - y0, 0, 1)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


def synthetic_tracking_sample(
    rng: np.random.RandomState,
    H: int = 64,
    W: int = 64,
    n_nodes: int = 32,
    n_matches: int = 512,
    warp_cm: float = 0.03,
    occlusion: bool = True,
    corrupt_flow: bool = False,
    device=None,
) -> TrackingSample:
    """A textured smooth surface under a smooth 3-D displacement field:
    the GT flow is the projection of the GT warp, the target images the
    source inverse-warped by it, and an optional occluder (a rectangle of
    replaced target depth) makes lifted targets wrong where MaskNet must
    learn to down-weight them. The graph's edges come from ``knn_torch``
    (k = 5) and the skinning from ``geometry/skinning.skinning_weights``,
    kernel K1 where ``device`` is the card."""
    from occlusionfusion_tpu_torch.geometry.skinning import skinning_weights
    from occlusionfusion_tpu_torch.ops.knn import knn_torch

    dev = resolve_device(device)
    fx = fy = np.float32(0.8 * max(H, W))
    cx, cy = np.float32(W / 2), np.float32(H / 2)
    tex = _smooth_field(rng, H, W, 3, 1.0, cells=8)
    tex += 0.15 * rng.randn(H, W, 3).astype(np.float32)
    im1 = (tex - tex.min()) / max(float(np.ptp(tex)), 1e-6)

    depth1 = (1.0 + 0.25 * _smooth_field(rng, H, W, 1, 1.0, cells=3))[..., 0]
    v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    xyz1 = np.stack(
        [(u - cx) / fx * depth1, (v - cy) / fy * depth1, depth1], axis=-1
    ).astype(np.float32)

    disp = _smooth_field(rng, H, W, 3, warp_cm, cells=3).astype(np.float32)
    xyz_warped = xyz1 + disp
    u2 = fx * xyz_warped[..., 0] / xyz_warped[..., 2] + cx
    v2 = fy * xyz_warped[..., 1] / xyz_warped[..., 2] + cy
    flow_gt = np.stack([u2 - u, v2 - v], axis=-1).astype(np.float32)
    inb = (u2 >= 0) & (u2 <= W - 1) & (v2 >= 0) & (v2 <= H - 1)

    im2 = _bilinear(im1, v - flow_gt[..., 1], u - flow_gt[..., 0]).astype(
        np.float32
    )
    z2 = _bilinear(
        xyz_warped[..., 2:3], v - flow_gt[..., 1], u - flow_gt[..., 0]
    )[..., 0]
    mask_gt = inb.copy()
    if occlusion:
        h0 = rng.randint(0, H // 2)
        w0 = rng.randint(0, W // 2)
        hh = rng.randint(H // 6, H // 3)
        ww = rng.randint(W // 6, W // 3)
        z2[h0 : h0 + hh, w0 : w0 + ww] = 0.5
        occluded = np.zeros((H, W), bool)
        occluded[h0 : h0 + hh, w0 : w0 + ww] = True
        mask_gt &= ~occluded
        if corrupt_flow:
            # wrong but valid flow GT at the occluder and at random
            # depth holes (reconstruction-derived GT's failure mode)
            holes = np.zeros((H, W), bool)
            for _ in range(rng.randint(1, 4)):
                hh0 = rng.randint(0, H - 4)
                ww0 = rng.randint(0, W - 4)
                holes[hh0 : hh0 + rng.randint(2, H // 6),
                      ww0 : ww0 + rng.randint(2, W // 6)] = True
            bad = occluded | holes
            wrong = flow_gt + _smooth_field(
                rng, H, W, 2, 3.0, cells=4
            ).astype(np.float32)
            flow_gt = np.where(bad[..., None], wrong, flow_gt)
            mask_gt &= ~holes
    xyz2 = np.stack(
        [(u - cx) / fx * z2, (v - cy) / fy * z2, z2], axis=-1
    ).astype(np.float32)

    src6 = np.concatenate(
        [im1.transpose(2, 0, 1), xyz1.transpose(2, 0, 1)], 0
    )
    tgt6 = np.concatenate(
        [im2.transpose(2, 0, 1), xyz2.transpose(2, 0, 1)], 0
    )

    flat_idx = rng.permutation(H * W)
    node_idx = flat_idx[:n_nodes]
    nodes = xyz1.reshape(-1, 3)[node_idx]
    gt_node_trans = disp.reshape(-1, 3)[node_idx]
    coverage = 0.35

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x if dtype is None else x.to(dtype)

    nodes_t = t(nodes)
    d2, idx = knn_torch(nodes_t, nodes_t, 5)
    edges = idx[:, 1:]
    ew = np.exp(-d2[:, 1:].cpu().numpy() / (2 * coverage**2))
    ew = ew / ew.sum(axis=1, keepdims=True)

    match_idx = flat_idx[n_nodes : n_nodes + n_matches]
    source_points = xyz1.reshape(-1, 3)[match_idx]
    gt_warped = xyz_warped.reshape(-1, 3)[match_idx]
    anchors, skin_w, skin_valid = skinning_weights(
        t(source_points), nodes_t, None, coverage, k=4)
    match_valid = skin_valid & t(inb.reshape(-1)[match_idx])

    return TrackingSample(
        src_rgbxyz=t(src6.astype(np.float32)),
        tgt_rgbxyz=t(tgt6.astype(np.float32)),
        flow_gt=t(flow_gt),
        flow_valid=t(inb),
        mask_gt=t(mask_gt),
        match_idx=t(match_idx.astype(np.int32)),
        match_valid=match_valid,
        source_points=t(source_points),
        anchors=anchors,
        skin_weights=skin_w,
        gt_warped=t(gt_warped),
        nodes=nodes_t,
        node_valid=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        edges=edges.to(torch.int32),
        edge_weights=t(ew.astype(np.float32)),
        gt_node_trans=t(gt_node_trans),
        intrinsics=torch.tensor([fx, fy, cx, cy], dtype=torch.float32,
                                device=dev),
    )


def stack_samples(samples) -> TrackingSample:
    """Samples stacked on a leading batch axis."""
    return TrackingSample(*(torch.stack(f) for f in zip(*samples)))
