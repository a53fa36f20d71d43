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
The kernel stages each ref as (-2 r, |r|^2): scaling by -2 is exact, so
fma(qz, -2rz, fma(qy, -2ry, qx*(-2rx))) is -2 q.r bit for bit and
(|q|^2 + that) + |r|^2 rounds as d2 above, with no bias: it computes the
valid refs only and gives the lowest-index invalid ones d2 = 1e30 where
fewer than k are valid, as the bias does.
"""

from __future__ import annotations

import torch

from occlusionfusion_tpu_torch import device as D

_BIG = 1e30
# queries per block of the twin (bounds its [chunk, N] distance matrix)
_CHUNK = 16384


def _sq3(x: torch.Tensor) -> torch.Tensor:
    """|r|^2 = (x0*x0 + x1*x1) + x2*x2, each op rounded."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


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


def _k_smallest(d2, k: int):
    """The first k of a stable ascending sort of d2 along its last axis:
    (values, indices), equal distances in index order. On the CPU, where
    sorting whole rows costs most of a test's ``initialize``, it selects
    with ``topk`` instead (k + 1 candidates), orders the k by index and
    then stably by value, and sorts in full only the rows whose k-th and
    (k+1)-th values tie, where the selection itself is ambiguous; the
    result is the stable sort's. On the card the sort stays."""
    n = d2.shape[-1]
    if d2.is_cuda or k >= n:
        top, idx = torch.sort(d2, dim=-1, stable=True)
        return top[..., :k], idx[..., :k]
    with torch.no_grad():
        vals, idx = torch.topk(d2, k + 1, dim=-1, largest=False)
        tie = vals[..., k - 1] == vals[..., k]
        idx = torch.sort(idx[..., :k], dim=-1).values
        order = torch.sort(torch.gather(d2, -1, idx), dim=-1, stable=True)[1]
        idx = torch.gather(idx, -1, order)
        if bool(tie.any()):
            flat = idx.reshape(-1, k)
            rows = torch.nonzero(tie.reshape(-1))[:, 0]
            flat[rows] = torch.sort(d2.reshape(-1, n)[rows], dim=-1,
                                    stable=True)[1][:, :k]
            idx = flat.reshape(idx.shape)
    return torch.gather(d2, -1, idx), idx


def knn_torch(queries, refs, k: int, valid=None):
    """Plain PyTorch twin: chunked dense distances + a stable sort.
    Returns (sq_dists [..., P, k] f32, idx [..., P, k] int32) for queries
    [..., P, 3], refs [..., N, 3] and valid [..., N], the leading
    (batch) axes broadcast: each batch entry is the unbatched search.

    Besides K1's twin, this is the port of ``knn_lax`` wherever the JAX
    package calls that XLA function itself, on the card too: the Lepard
    matcher's neighbourhoods (k = 24-30, batched over the two clouds with
    ``batched_encode``), its 1-NN upsampling, its 3-NN flow blend and
    its coherence filter's neighbourhoods (``models/kpconv.py``,
    ``models/lepard.py``). K1 replaces the TPU kernel ``knn_pallas`` and
    takes k = 4 only; it keeps the skinning calls."""
    queries = queries.to(torch.float32)
    refs = refs.to(torch.float32)
    P, N = queries.shape[-2], refs.shape[-2]
    k = min(k, N)
    if not queries.is_cuda and valid is not None and valid.dim() == 1 \
            and refs.dim() == 2:
        # on the CPU, search the valid refs only (in index order, so ties
        # still go to the lower index; a valid ref's bias is +0): skinning
        # searches a node table that is mostly padding
        keep = torch.nonzero(valid.to(torch.bool))[:, 0]
        if keep.numel() >= k:
            d2, idx = knn_torch(queries, refs[keep], k)
            return d2, keep[idx.long()].to(torch.int32)
    ref_sq = _sq3(refs)[..., None, :]
    bias = _bias(valid, N, refs)[..., None, :]
    d2s, idxs = [], []
    for lo in range(0, P, _CHUNK):
        q = queries[..., lo : lo + _CHUNK, :]
        dot = _fma_dot3(q[..., :, None, :], refs[..., None, :, :])
        d2 = _fma_dot3(q, q)[..., None] - 2.0 * dot + ref_sq + bias
        top, idx = _k_smallest(d2, k)
        d2s.append(torch.clamp(top, min=0.0))
        idxs.append(idx.to(torch.int32))
    if not d2s:
        shape = torch.broadcast_shapes(queries.shape[:-2],
                                       refs.shape[:-2]) + (0, k)
        return (
            torch.zeros(shape, dtype=torch.float32, device=queries.device),
            torch.zeros(shape, dtype=torch.int32, device=queries.device),
        )
    return torch.cat(d2s, dim=-2), torch.cat(idxs, dim=-2)


# the most refs K1 stages in shared memory on the H100: 20 bytes each
# beside the kernel's 128 bytes of static shared memory
MAX_REFS = (D.SMEM_PER_BLOCK - 128) // 20


def knn_cuda(queries, refs, k: int, valid=None):
    """Kernel K1 (``csrc/knn.cu``). Bound on the H100 by its f32
    operations (7 per query and valid ref); see the note in the source.
    The kernel reads ``valid`` itself (None: every ref valid) and forms
    |r|^2 from ``refs``."""
    P, N = queries.shape[0], refs.shape[0]
    if k != 4 or N < 4:
        raise ValueError(f"knn kernel takes k == 4 and >= 4 refs, got "
                         f"k={k}, {N} refs")
    if N > MAX_REFS:
        raise ValueError(f"knn kernel stages at most {MAX_REFS} refs in "
                         f"shared memory ({D.SMEM_PER_BLOCK} bytes), "
                         f"got {N}")
    dev = D.tensors_device(queries=queries, refs=refs,
                           **({} if valid is None else {"valid": valid}))
    D.check_cuda_tensor("queries", queries, torch.float32, (None, 3))
    D.check_cuda_tensor("refs", refs, torch.float32, (None, 3))
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
        D.check_cuda_tensor("valid", valid, torch.bool, (N,))
    d2 = torch.empty((P, k), dtype=torch.float32, device=dev)
    idx = torch.empty((P, k), dtype=torch.int32, device=dev)
    if P == 0:
        return d2, idx
    D.launch(
        "of_knn", dev, queries.data_ptr(), refs.data_ptr(),
        None if valid is None else valid.data_ptr(), P, N, k, d2.data_ptr(),
        idx.data_ptr(),
    )
    D.count_launch("knn")
    return d2, idx


def knn(queries, refs, k: int, valid=None):
    """K1 on CUDA tensors, the twin on CPU tensors."""
    if queries.is_cuda:
        return knn_cuda(queries.contiguous(), refs.contiguous(), k, valid)
    return knn_torch(queries, refs, k, valid)


def radius_neighbors(queries, refs, radius: float, max_k: int, q_valid=None,
                     r_valid=None):
    """Fixed-max-K radius search with shadow-index padding: [P, max_k]
    int32 neighbour indices; a slot with no neighbour inside ``radius``
    gets the shadow index N (one past the last ref). Runs the twin, as
    the JAX package runs ``knn_lax`` here."""
    N = refs.shape[0]
    d2, idx = knn_torch(queries, refs, min(max_k, N), r_valid)
    in_radius = d2 <= radius * radius
    if q_valid is not None:
        in_radius = in_radius & q_valid[:, None]
    out = torch.where(in_radius, idx, torch.full_like(idx, N))
    if out.shape[1] < max_k:
        out = torch.nn.functional.pad(out, (0, max_k - out.shape[1]),
                                      value=N)
    return out.to(torch.int32)
