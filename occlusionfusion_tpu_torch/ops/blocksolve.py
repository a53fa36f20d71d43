"""Explicit inverses of the damped dense Gauss-Newton system (port of
``occlusionfusion_tpu/ops/blocksolve.py``): a recursive 2x2 block Schur
inverse and a Newton-Schulz inverse seeded with the exact block-Jacobi
inverse.

  M = [[A, B], [B^T, D]],  S = D - B^T A^-1 B,  W = A^-1 B
  M^-1 = [[A^-1 + W S^-1 W^T, -W S^-1], [-(W S^-1)^T, S^-1]]

  X0 = alpha blockdiag(D_i^-1), alpha = 1 / ||blockdiag(D_i^-1) M||_inf
  X <- X (2I - M X)

Both are plain large f32 matrix products (``torch.matmul`` with TF32
off), which the JAX package left to XLA outside any Pallas kernel, and
small inverses by ``torch.linalg.inv_ex``, which reports a singular
matrix on the device instead of checking it on the host, so a solve can
be captured in a CUDA graph. The LM damping bounds the condition number,
which keeps the explicit inverses safe in f32.
"""

from __future__ import annotations

import torch


def _inv(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(M).inverse


def spd_schur_inverse(M: torch.Tensor, leaf: int = 96) -> torch.Tensor:
    """Inverse of a well-conditioned SPD matrix by recursive 2x2 block
    Schur complements, split on a 6-dof node boundary where the JAX
    package splits (so the leaves are the same matrices)."""
    n = M.shape[0]
    if n <= leaf:
        return _inv(M)
    h = (n // 2 + 5) // 6 * 6
    if h >= n:
        return _inv(M)
    A, B, D = M[:h, :h], M[:h, h:], M[h:, h:]
    Ai = spd_schur_inverse(A, leaf)
    W = Ai @ B
    S = D - B.T @ W
    Si = spd_schur_inverse(S, leaf)
    WSi = W @ Si
    TL = Ai + WSi @ W.T
    return torch.cat([torch.cat([TL, -WSi], 1), torch.cat([-WSi.T, Si], 1)])


def spd_schur_solve(M: torch.Tensor, rhs: torch.Tensor,
                    leaf: int = 96) -> torch.Tensor:
    """x with M x = rhs, through the recursive inverse."""
    return spd_schur_inverse(M, leaf) @ rhs


def _block_size(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= target and a multiple of 6
    (else the largest divisor <= target, else n)."""
    best = 1
    for b in range(6, min(target, n) + 1, 6):
        if n % b == 0:
            best = b
    if best > 1:
        return best
    for b in range(min(target, n), 0, -1):
        if n % b == 0:
            return b
    return n


def newton_schulz_inverse(M: torch.Tensor, block: int = 96,
                          iters: int = 12) -> torch.Tensor:
    """Approximate inverse of a damped SPD matrix: ``iters`` Newton-Schulz
    steps from the scaled exact inverse of its diagonal blocks (one
    batched small inverse, then 2 * iters full-size products)."""
    n = M.shape[0]
    b = _block_size(n, block)
    m = n // b
    diag = M.reshape(m, b, m, b).diagonal(dim1=0, dim2=2)  # [b, b, m]
    Di = _inv(diag.permute(2, 0, 1))
    T = torch.bmm(Di, M.reshape(m, b, n)).reshape(n, n)
    alpha = 1.0 / torch.clamp(T.abs().sum(1).max(), min=1e-20)
    X = torch.zeros((m, b, m, b), dtype=M.dtype, device=M.device)
    X.diagonal(dim1=0, dim2=2).copy_((alpha * Di).permute(1, 2, 0))
    X = X.reshape(n, n)
    for _ in range(iters):
        X = 2.0 * X - X @ (M @ X)
    return X


def newton_schulz_solve(M: torch.Tensor, rhs: torch.Tensor, block: int = 96,
                        iters: int = 12) -> torch.Tensor:
    """x with M x = rhs, through the Newton-Schulz inverse."""
    return newton_schulz_inverse(M, block, iters) @ rhs
