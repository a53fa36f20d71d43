"""Brute-force k-nearest-neighbour search (port of
``occlusionfusion_tpu/ops/knn.py``).

``knn`` is the front door. On CUDA tensors it launches kernel K1
(``csrc/knn.cu``, replacing the TPU kernel ``knn_pallas``); on CPU
tensors it runs the plain PyTorch twin ``knn_torch`` (the port of
``knn_lax``). Both return d2 clamped >= 0 with int32 indices, nearest
first, and among exactly equal distances the lower ref index first, as
``lax.top_k`` does. Exact ties are common: the model points and the
nodes are both marching-cubes vertices on one voxel lattice.

At metre-scale coordinates the expanded form d2 = |q|^2 - 2 q.r + |r|^2
cancels to ~1e-7 absolute, and the skinning weights exp(-d2 / 2 sigma^2)
inherit that noise divided by 2 sigma^2. Both versions therefore round
every step as the JAX package's XLA CPU program does (fused multiply-adds
in |q|^2 and q.r, plain sums elsewhere), so the port's skinning tables
match the reference's bit for bit and not only to rounding:
  |q|^2 = fma(qz, qz, fma(qy, qy, qx*qx))
  q.r   = fma(qz, rz, fma(qy, ry, qx*rx))
  |r|^2 = (rx*rx + ry*ry) + rz*rz
  d2    = ((|q|^2 - 2 q.r) + |r|^2) + bias      (bias 1e30 on invalid refs)
The twin forms each fused multiply-add in f64 and rounds it once to f32.
"""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch import device as D

_BIG = 1e30
# queries per block of the twin (bounds its [chunk, N] distance matrix)
_CHUNK = 16384


def _sq3(x: torch.Tensor) -> torch.Tensor:
    """|r|^2 = (x0*x0 + x1*x1) + x2*x2, each op rounded."""
    return x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]


def _fma(a, b, c):
    """a*b + c rounded once to f32 (the f64 product of two f32 is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _fma_dot3(a, b):
    """fma(a2, b2, fma(a1, b1, a0*b0)), broadcasting."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1],
                                           a[..., 0] * b[..., 0]))


def _bias(valid, n: int, like: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.zeros(n, dtype=torch.float32, device=like.device)
    return torch.where(
        valid.to(like.device, torch.bool),
        torch.zeros((), dtype=torch.float32, device=like.device),
        torch.full((), _BIG, dtype=torch.float32, device=like.device),
    )


def knn_torch(queries, refs, k: int, valid=None):
    """Plain PyTorch twin: chunked dense distances + a stable sort.
    Returns (sq_dists [P, k] f32, idx [P, k] int32)."""
    queries = queries.to(torch.float32)
    refs = refs.to(torch.float32)
    P, N = queries.shape[0], refs.shape[0]
    k = min(k, N)
    ref_sq = _sq3(refs)
    bias = _bias(valid, N, refs)
    d2s, idxs = [], []
    for lo in range(0, P, _CHUNK):
        q = queries[lo : lo + _CHUNK]
        dot = _fma_dot3(q[:, None, :], refs[None, :, :])
        d2 = _fma_dot3(q, q)[:, None] - 2.0 * dot + ref_sq[None, :] + bias[None, :]
        top, idx = torch.sort(d2, dim=1, stable=True)
        d2s.append(torch.clamp(top[:, :k], min=0.0))
        idxs.append(idx[:, :k].to(torch.int32))
    if not d2s:
        return (
            torch.zeros((0, k), dtype=torch.float32, device=queries.device),
            torch.zeros((0, k), dtype=torch.int32, device=queries.device),
        )
    return torch.cat(d2s), torch.cat(idxs)


def knn_cuda(queries, refs, k: int, valid=None):
    """Kernel K1 (``csrc/knn.cu``). Bound on the H100 by its f32
    operations (9 per query-ref pair); see the note in the source."""
    P, N = queries.shape[0], refs.shape[0]
    if k != 4 or N < 4:
        raise ValueError(f"knn kernel takes k == 4 and >= 4 refs, got "
                         f"k={k}, {N} refs")
    dev = D.tensors_device(queries=queries, refs=refs)
    D.check_cuda_tensor("queries", queries, torch.float32, (None, 3))
    D.check_cuda_tensor("refs", refs, torch.float32, (None, 3))
    ref_sq = _sq3(refs).contiguous()
    bias = _bias(valid, N, refs).contiguous()
    d2 = torch.empty((P, k), dtype=torch.float32, device=dev)
    idx = torch.empty((P, k), dtype=torch.int32, device=dev)
    if P == 0:
        return d2, idx
    D.launch(
        "of_knn", dev, queries.data_ptr(), refs.data_ptr(), ref_sq.data_ptr(),
        bias.data_ptr(), P, N, k, d2.data_ptr(), idx.data_ptr(),
    )
    D.launch_counts["knn"] += 1
    return d2, idx


def knn(queries, refs, k: int, valid=None):
    """K1 on CUDA tensors, the twin on CPU tensors."""
    if queries.is_cuda:
        return knn_cuda(queries.contiguous(), refs.contiguous(), k, valid)
    return knn_torch(queries, refs, k, valid)
