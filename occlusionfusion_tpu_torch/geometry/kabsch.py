"""Weighted rigid alignment (port of ``occlusionfusion_tpu/geometry/kabsch.py``).

The JAX package takes a 3x3 SVD with a determinant correction. On the
card ``torch.linalg.svd`` and ``torch.linalg.det`` check their result on
the host, which a CUDA graph cannot capture, and the fit runs inside
every fused step (the motion runner's rigid factor, Lepard's soft
Procrustes). So the port solves the same problem by Horn's quaternion
form: the best proper rotation is the quaternion of the largest
eigenvalue of a symmetric 4x4 matrix built from the cross-covariance.
That eigenvector is found by a fixed number of squarings of the shifted
matrix, in float64, so the fit is a fixed sequence of device ops with
nothing read back. The proper rotation is what the SVD form returns
after its reflection fix, so the two agree to rounding wherever the fit
is determined.
"""

from __future__ import annotations

import torch


EPS = 1e-8
# squarings of the shifted 4x4 matrix: its largest eigenvalue dominates by
# (lambda_2 / lambda_1)^(2^k). With the shift, 1 - ratio is about the
# cloud's second singular value over four times its first, so 2^32
# resolves clouds down to ~1e-8 of collinear
SQUARINGS = 32


def _horn_matrix(H):
    """Horn's symmetric 4x4 matrix of the cross-covariance H [..., 3, 3]
    (H[i, j] = sum w src_i dst_j): its top eigenvector is the rotation's
    quaternion (w, x, y, z)."""
    sxx, sxy, sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    syx, syy, syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    szx, szy, szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    rows = [
        [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _quat_to_rot(q):
    """Unit quaternion (w, x, y, z) [..., 4] -> rotation [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def best_rotation(H):
    """The rotation R maximizing trace(R H) over SO(3) (the Kabsch
    rotation of a cross-covariance H [..., 3, 3]), in H's dtype. A zero H
    gives the identity, as the SVD form does."""
    N = _horn_matrix(H.double())
    # shift by a bound on the spectral radius: all eigenvalues >= 0 and
    # the largest one is the top of the unshifted spectrum
    shift = torch.linalg.matrix_norm(N)[..., None, None] + 1e-30
    M = N + shift * torch.eye(4, dtype=N.dtype, device=N.device)
    M = M / torch.linalg.matrix_norm(M)[..., None, None]
    for i in range(SQUARINGS):
        M = M @ M
        # the top eigenvalue of a unit-norm M is >= 1/2: two squarings
        # cannot underflow, so normalize every second one
        if i % 2:
            M = M / torch.linalg.matrix_norm(M)[..., None, None]
    # M is now ~ v v^T: its column of largest norm is the eigenvector
    col = torch.argmax(torch.linalg.vector_norm(M, dim=-2), dim=-1)
    q = torch.gather(M, -1, col[..., None, None].expand(*M.shape[:-1], 1))
    q = q[..., 0] / torch.linalg.vector_norm(q[..., 0], dim=-1, keepdim=True)
    return _quat_to_rot(q).to(H.dtype)


def weighted_kabsch(src, dst, weights):
    """(R, t) minimizing sum_i w_i |R src_i + t - dst_i|^2 over [..., N, 3]."""
    w = weights[..., None]
    wsum = torch.sum(w, dim=-2) + EPS
    c_src = torch.sum(w * src, dim=-2) / wsum
    c_dst = torch.sum(w * dst, dim=-2) / wsum
    src_c = src - c_src[..., None, :]
    dst_c = dst - c_dst[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", w * src_c, dst_c)
    R = best_rotation(H)
    t = c_dst - torch.einsum("...ij,...j->...i", R, c_src)
    return R, t


def kabsch(src, dst):
    """Unweighted rigid alignment; see :func:`weighted_kabsch`."""
    return weighted_kabsch(src, dst, torch.ones_like(src[..., 0]))
