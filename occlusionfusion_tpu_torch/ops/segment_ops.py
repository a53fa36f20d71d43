"""Segment (scatter) primitives for graph nets (port of
``occlusionfusion_tpu/ops/segment_ops.py``): static-shape gathers plus
``index_add_`` / ``scatter_reduce_`` over padded, masked edge lists."""

from __future__ import annotations

import torch

_NEG_BIG = -1e30


def segment_sum(values, segment_ids, num_segments: int):
    out = torch.zeros(
        (num_segments,) + tuple(values.shape[1:]),
        dtype=values.dtype, device=values.device,
    )
    return out.index_add_(0, segment_ids.long(), values)


def segment_max(values, segment_ids, num_segments: int):
    """Per-segment max of [E]; empty segments give -inf."""
    out = torch.full(
        (num_segments,), float("-inf"), dtype=values.dtype,
        device=values.device,
    )
    return out.scatter_reduce_(0, segment_ids.long(), values, reduce="amax")


def segment_softmax(logits, segment_ids, num_segments: int, edge_mask=None,
                    eps: float = 1e-16):
    """Softmax over edges grouped by segment (torch_geometric semantics:
    subtract the segment max, +eps denominator); masked edges get 0."""
    if edge_mask is not None:
        logits = torch.where(
            edge_mask, logits, torch.full_like(logits, _NEG_BIG)
        )
    seg_max = torch.clamp(
        segment_max(logits, segment_ids, num_segments), min=_NEG_BIG
    )
    ids = segment_ids.long()
    expv = torch.exp(logits - seg_max[ids])
    if edge_mask is not None:
        expv = torch.where(edge_mask, expv, torch.zeros_like(expv))
    denom = segment_sum(expv, ids, num_segments)
    return expv / (denom[ids] + eps)
