"""Linear-blend-skinning voxel warp (port of ``occlusionfusion_tpu/ops/lbs.py``).

``lbs_warp`` launches kernel K2 (``csrc/lbs.cu``, replacing the TPU
kernel ``lbs_warp_pallas``) on CUDA tensors and runs the plain twin
``lbs_warp_torch`` (the port of ``lbs_warp_lax``: gather + einsum through
``warpfield.deform_points``) on CPU tensors. The kernel works in origin
form, y = (sum_k w_k R_k) x + sum_k w_k t'_k, and forms the table of
t' = (t + g) - R g itself, in shared memory, from the warp field's
tensors; invalid points pass through. The two forms agree to ~1e-6 m at
metre scale. ``pack_transforms`` builds the same table with torch ops,
as the JAX package's ``_pack_transforms`` does.

``lbs_warp_dense`` is the JAX package's other route (``lbs_impl="dense"``,
on any device): the skinning matrix S [P, N_pad] (4 non-zeros a row),
precomputed once per table as bf16 hi/lo halves (``DenseSkin``), times
the packed transforms, as two bf16 matrix products with f32 results.
It streams the whole S every frame: 4.29 GB at 2,097,152 voxels and the
512-node cap, where K2 reads 25-57 bytes a voxel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from occlusionfusion_tpu_torch import device as D
from occlusionfusion_tpu_torch.fusion.warpfield import (
    SkinTable,
    WarpFieldState,
    deform_points,
    to_origin_form,
)
from occlusionfusion_tpu_torch.geometry.edwarp import ed_warp


def pack_transforms(state: WarpFieldState) -> torch.Tensor:
    """[N, 12]: row-major R (origin form), then t'."""
    R, t_origin = to_origin_form(state)
    return torch.cat([R.reshape(-1, 9), t_origin], dim=-1).contiguous()


def lbs_warp_torch(points, anchors, weights, valid, state: WarpFieldState):
    """Plain twin (gather + einsum). On the CPU it warps only the valid
    points, with the same arithmetic per point: most voxels of a volume
    are unreachable and pass through unchanged."""
    if points.is_cuda:
        return deform_points(state, points,
                             SkinTable(anchors, weights, valid))
    rows = torch.nonzero(valid)[:, 0]
    out = points.clone()
    out[rows] = ed_warp(points[rows], state.node_positions, state.rotations,
                        state.translations, anchors[rows], weights[rows])
    return out


# the most nodes whose origin-form table (48 bytes a node) K2 holds in
# shared memory on the H100 beside its per-warp staging buffers (16 warps
# x 96 floats)
MAX_NODES = (D.SMEM_PER_BLOCK - 16 * 96 * 4) // 48


def lbs_warp_cuda(points, anchors, weights, valid, state: WarpFieldState):
    """Kernel K2. Bound on the H100 by device memory (25 bytes per
    voxel, 32 more per valid one); see the note in the source."""
    P, K = anchors.shape
    N = state.node_positions.shape[0]
    if K != 4:
        raise ValueError(f"LBS kernel takes K == 4 anchors, got {K}")
    if N > MAX_NODES:
        raise ValueError(
            f"LBS kernel holds at most {MAX_NODES} nodes in shared memory "
            f"({D.SMEM_PER_BLOCK} bytes), got {N}")
    # the kernel reads a voxel's anchors and weights as one 16-byte load
    D.check_aligned("anchors", anchors, 16)
    D.check_aligned("weights", weights, 16)
    nodes = state.node_positions.contiguous()
    rot = state.rotations.contiguous()
    trans = state.translations.contiguous()
    dev = D.tensors_device(
        points=points, anchors=anchors, weights=weights, valid=valid,
        node_positions=nodes, rotations=rot, translations=trans,
    )
    D.check_cuda_tensor("points", points, torch.float32, (P, 3))
    D.check_cuda_tensor("anchors", anchors, torch.int32, (P, K))
    D.check_cuda_tensor("weights", weights, torch.float32, (P, K))
    D.check_cuda_tensor("valid", valid, torch.bool, (P,))
    D.check_cuda_tensor("node_positions", nodes, torch.float32, (N, 3))
    D.check_cuda_tensor("rotations", rot, torch.float32, (N, 3, 3))
    D.check_cuda_tensor("translations", trans, torch.float32, (N, 3))
    out = torch.empty((P, 3), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    D.launch(
        "of_lbs_warp", dev, points.data_ptr(), anchors.data_ptr(),
        weights.data_ptr(), valid.data_ptr(), nodes.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), P, K, N, out.data_ptr(),
    )
    D.count_launch("lbs_warp")
    return out


def lbs_warp(points, anchors, weights, valid, state: WarpFieldState):
    """K2 on CUDA tensors, the twin on CPU tensors."""
    if points.is_cuda:
        return lbs_warp_cuda(
            points.contiguous(), anchors.contiguous(), weights.contiguous(),
            valid.contiguous(), state,
        )
    return lbs_warp_torch(points, anchors, weights, valid, state)


class DenseSkin(NamedTuple):
    """The dense skinning matrix S [P, N_pad] as bf16 halves, S ~= s_hi +
    s_lo (the JAX package's layout; N_pad is N rounded up to 128)."""

    s_hi: torch.Tensor  # [P, N_pad] bf16
    s_lo: torch.Tensor  # [P, N_pad] bf16


def dense_skin_bytes(n_points: int, n_nodes: int) -> int:
    """Bytes of a DenseSkin of ``n_points`` rows at ``n_nodes`` nodes."""
    n_pad = -(-n_nodes // 128) * 128
    return 2 * n_points * n_pad * 2


@torch.no_grad()
def precompute_dense_skin(anchors, weights, valid, n_nodes: int,
                          rows: int = 1 << 18) -> DenseSkin:
    """S [P, N_pad] from the skin table (each row's K weights at its
    anchors, equal anchors summed; invalid rows zero), split into bf16
    halves s_hi = bf16(S), s_lo = bf16(S - s_hi). Built ``rows`` rows at a
    time, so no f32 copy of the whole S is made. Once per table."""
    P, K = anchors.shape
    n_pad = -(-n_nodes // 128) * 128
    hi = torch.empty((P, n_pad), dtype=torch.bfloat16, device=anchors.device)
    lo = torch.empty_like(hi)
    for r0 in range(0, P, rows):
        a = anchors[r0:r0 + rows].long()
        # an anchor outside the table matches no column (JAX's one-hot)
        keep = valid[r0:r0 + rows, None] & (a >= 0) & (a < n_pad)
        w = torch.where(keep, weights[r0:r0 + rows],
                        torch.zeros_like(weights[r0:r0 + rows]))
        a = torch.clamp(a, 0, n_pad - 1)
        S = torch.zeros((a.shape[0], n_pad), dtype=torch.float32,
                        device=anchors.device)
        for k in range(K):
            S.scatter_add_(1, a[:, k:k + 1], w[:, k:k + 1])
        h = S.to(torch.bfloat16)
        hi[r0:r0 + rows] = h
        lo[r0:r0 + rows] = (S - h.float()).to(torch.bfloat16)
    return DenseSkin(hi, lo)


def _mm_f32(a, b, rows: int = 1 << 18):
    """a @ b of bf16 matrices with an f32 result: the products are exact
    in f32 and summed in f32. On CUDA one cuBLAS product with an f32
    output; on the CPU through f32 copies of ``rows`` rows of a at a
    time."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    bf = b.float()
    return torch.cat([a[r0:r0 + rows].float() @ bf
                      for r0 in range(0, a.shape[0], rows)])


def lbs_warp_dense(points, valid, dense: DenseSkin, state: WarpFieldState):
    """Warp ``points`` [P, 3] through the precomputed skin: the packed
    transforms T [N, 12] split into bf16 T_hi + T_lo, then
    S T ~= s_hi [T_hi | T_lo] + s_lo T_hi (two bf16 products with f32
    results; the dropped s_lo T_lo is ~2^-18 relative), then the 12-term
    blend; invalid points pass through. Within ~1e-5 relative of the
    gather twin, as in JAX."""
    n_pad = dense.s_hi.shape[1]
    T = pack_transforms(state)
    T = torch.nn.functional.pad(T, (0, 0, 0, n_pad - T.shape[0]))
    T_hi = T.to(torch.bfloat16)
    T_lo = (T - T_hi.float()).to(torch.bfloat16)
    hi = _mm_f32(dense.s_hi, torch.cat([T_hi, T_lo], dim=1))
    lo = _mm_f32(dense.s_lo, T_hi)
    m = hi[:, :12] + hi[:, 12:] + lo  # [P, 12]
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    warped = torch.cat([
        m[:, 0:1] * x + m[:, 1:2] * y + m[:, 2:3] * z + m[:, 9:10],
        m[:, 3:4] * x + m[:, 4:5] * y + m[:, 5:6] * z + m[:, 10:11],
        m[:, 6:7] * x + m[:, 7:8] * y + m[:, 8:9] * z + m[:, 11:12],
    ], dim=1)
    return torch.where(valid[:, None], warped, points)
