"""Weighted rigid alignment (port of ``occlusionfusion_tpu/geometry/kabsch.py``)."""

from __future__ import annotations

import torch


EPS = 1e-8


def weighted_kabsch(src, dst, weights):
    """(R, t) minimizing sum_i w_i |R src_i + t - dst_i|^2 over [..., N, 3]."""
    w = weights[..., None]
    wsum = torch.sum(w, dim=-2) + EPS
    c_src = torch.sum(w * src, dim=-2) / wsum
    c_dst = torch.sum(w * dst, dim=-2) / wsum
    src_c = src - c_src[..., None, :]
    dst_c = dst - c_dst[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", w * src_c, dst_c)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.linalg.det(torch.einsum("...ij,...kj->...ik", V, U))
    D = torch.zeros_like(H) + torch.eye(3, dtype=src.dtype, device=src.device)
    D[..., 2, 2] = d
    R = torch.einsum("...ij,...jk,...lk->...il", V, D, U)
    t = c_dst - torch.einsum("...ij,...j->...i", R, c_src)
    return R, t
