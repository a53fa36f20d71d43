"""Occlusion-aware motion completion network (port of
``occlusionfusion_tpu/models/motion_complete.py``).

An LSTM over the 16-frame motion history feeds, with the current
visible-node motion and centred node positions, a 15-conv graph-attention
U-Net over the 4-level graph pyramid, predicting per-node motion mu (3)
and uncertainty sigma (1). ``MotionCompleteNet`` holds the parameters as
an ``nn.Module`` whose ``state_dict`` keys are the checkpoint's own
(``conv0.lin_query.weight``, ``seq_encoder.weight_ih_l0``, ...); the
forward is the plain function ``motion_complete_forward`` over padded,
masked, static-shape edge lists.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from occlusionfusion_tpu_torch.ops.segment_ops import (
    segment_softmax,
    segment_sum,
)

HIDDEN = 32
FEATURE_DIM = 11
OUTPUT_DIM = 4
# U-Net block widths: layer{lv}{1,2}; levels 5-7 take skip concatenations
BLOCK_WIDTHS = {1: HIDDEN, 2: HIDDEN, 3: HIDDEN, 4: HIDDEN, 5: 2 * HIDDEN,
                6: 3 * HIDDEN, 7: 4 * HIDDEN}


class PyramidBatch(NamedTuple):
    """Static-shape padded graph pyramid for one frame (see the JAX
    package for the edge convention: node -> neighbour, aggregated at the
    neighbour)."""

    edge_src: Sequence[torch.Tensor]
    edge_dst: Sequence[torch.Tensor]
    edge_mask: Sequence[torch.Tensor]
    down_idx: Sequence[torch.Tensor]
    up_idx: Sequence[torch.Tensor]
    node_mask: torch.Tensor


class TransformerConvParams(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.lin_key = nn.Linear(d, d)
        self.lin_query = nn.Linear(d, d)
        self.lin_value = nn.Linear(d, d)
        self.lin_skip = nn.Linear(d, d)


class ResBlockParams(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.conv = TransformerConvParams(d)
        self.norm = nn.LayerNorm(d)


class MotionCompleteNet(nn.Module):
    """Parameter container of the motion-completion net; ``forward`` is
    ``motion_complete_forward``."""

    def __init__(self):
        super().__init__()
        H = HIDDEN
        self.node_encoder = nn.Linear(FEATURE_DIM, H)
        self.seq_linear = nn.Linear(H, 4)
        self.conv0 = TransformerConvParams(H)
        self.norm_out = nn.LayerNorm(4 * H)
        self.lin = nn.Linear(4 * H, OUTPUT_DIM)
        self.seq_encoder = nn.LSTM(4, H, num_layers=2)
        for lv, width in BLOCK_WIDTHS.items():
            for sub in (1, 2):
                setattr(self, f"layer{lv}{sub}", ResBlockParams(width))

    def forward(self, curr_pos, curr_motion, history, history_len, pyramid):
        return motion_complete_forward(
            self, curr_pos, curr_motion, history, history_len, pyramid
        )


def transformer_conv(p: TransformerConvParams, x, edge_src, edge_dst,
                     edge_mask, num_nodes: int):
    """PyG TransformerConv (heads=1, concat), aggregated at ``edge_dst``."""
    C = x.shape[-1]
    q = p.lin_query(x)
    k = p.lin_key(x)
    v = p.lin_value(x)
    src = edge_src.long()
    dst = edge_dst.long()
    logits = torch.sum(q[dst] * k[src], dim=-1) / math.sqrt(C)
    alpha = segment_softmax(logits, dst, num_nodes, edge_mask)
    msg = segment_sum(v[src] * alpha[:, None], dst, num_nodes)
    return msg + p.lin_skip(x)


def deep_gcn_res_plus(p: ResBlockParams, x, edge_src, edge_dst, edge_mask,
                      num_nodes: int):
    """'res+' block: x + conv(relu(norm(x)))."""
    h = F.relu(p.norm(x))
    return x + transformer_conv(
        p.conv, h, edge_src, edge_dst, edge_mask, num_nodes
    )


def lstm_forward(lstm: nn.LSTM, seq):
    """Top-layer hidden states [T, B, H] of a torch LSTM over time-major
    seq [T, B, C_in], zero initial state (gate order i, f, g, o)."""
    return lstm(seq)[0]


def motion_complete_forward(net: MotionCompleteNet, curr_pos, curr_motion,
                            history, history_len, pyramid: PyramidBatch):
    """[N0, 4]: (mu_x, mu_y, mu_z, softplus sigma). ``history_len`` is a
    0-d int tensor; the LSTM output is read at history_len - 1."""
    seq_all = lstm_forward(net.seq_encoder, history)  # [T, N0, H]
    last = torch.clamp(
        torch.as_tensor(history_len, device=history.device).long() - 1,
        0, history.shape[0] - 1,
    ).reshape(1)
    seq_feature = torch.index_select(seq_all, 0, last)[0]
    seq_pred = net.seq_linear(seq_feature)
    x = net.node_encoder(torch.cat([curr_pos, seq_pred, curr_motion], dim=-1))

    def edges(level):
        return (pyramid.edge_src[level], pyramid.edge_dst[level],
                pyramid.edge_mask[level])

    def block(name, feat, level):
        return deep_gcn_res_plus(
            getattr(net, name), feat, *edges(level), feat.shape[0]
        )

    def gather(feat, idx):
        return feat[idx.long()]

    feature0 = transformer_conv(net.conv0, x, *edges(0), x.shape[0])
    feature1 = block("layer12", block("layer11", feature0, 0), 0)
    feature2 = gather(feature1, pyramid.down_idx[0])
    feature2 = block("layer22", block("layer21", feature2, 1), 1)
    feature3 = gather(feature2, pyramid.down_idx[1])
    feature3 = block("layer32", block("layer31", feature3, 2), 2)
    feature4 = gather(feature3, pyramid.down_idx[2])
    feature4 = block("layer42", block("layer41", feature4, 3), 3)
    feature5 = gather(feature4, pyramid.up_idx[2])
    feature5 = block("layer51", torch.cat([feature5, feature3], -1), 2)
    feature5 = block("layer52", feature5, 2)
    feature6 = gather(feature5, pyramid.up_idx[1])
    feature6 = block("layer61", torch.cat([feature6, feature2], -1), 1)
    feature6 = block("layer62", feature6, 1)
    feature7 = gather(feature6, pyramid.up_idx[0])
    feature7 = block("layer71", torch.cat([feature7, feature1], -1), 0)
    feature7 = block("layer72", feature7, 0)
    out = F.relu(net.norm_out(feature7))
    pred = net.lin(out)
    sigma = F.softplus(pred[:, -1:])
    return torch.cat([pred[:, :3], sigma], dim=-1)


def init_motion_complete_net(generator: torch.Generator | None = None,
                             device=None) -> MotionCompleteNet:
    """A freshly initialised net with the JAX ``init_params``'s layout and
    per-tensor scale (not its draws): linear weights U(+-1/sqrt(fan_in)),
    the LSTM's weights U(+-0.1), every bias 0, layer norms 1 and 0."""
    net = MotionCompleteNet()
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("weight_"):  # the LSTM's
                p.uniform_(-0.1, 0.1, generator=generator)
            elif leaf == "weight" and p.dim() == 2:
                s = 1.0 / math.sqrt(p.shape[1])
                p.uniform_(-s, s, generator=generator)
            elif leaf == "weight":  # layer norm
                p.fill_(1.0)
            else:
                p.zero_()
    return net.to(device)
