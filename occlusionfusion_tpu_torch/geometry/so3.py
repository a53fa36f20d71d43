"""SO(3)/SE(3) maps in PyTorch (port of ``occlusionfusion_tpu/geometry/so3.py``).

Exponential and log maps with the same small-angle branches as the JAX
package, written with ``torch.where`` on safe operands, plus quaternion
conversions. Rodrigues goes
through the outer product w w^T, matmul-free as in the reference.
All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8

def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle vector -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew-symmetric matrix -> [..., 3] vector."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _outer(w: torch.Tensor) -> torch.Tensor:
    return w[..., :, None] * w[..., None, :]


def _sin_over_x(x2: torch.Tensor) -> torch.Tensor:
    small = x2 < 1e-8
    x = torch.sqrt(torch.where(small, torch.ones_like(x2), x2))
    return torch.where(small, 1.0 - x2 / 6.0, torch.sin(x) / x)


def _one_minus_cos_over_x2(x2: torch.Tensor) -> torch.Tensor:
    small = x2 < 1e-8
    x2s = torch.where(small, torch.ones_like(x2), x2)
    return torch.where(
        small, 0.5 - x2 / 24.0, (1.0 - torch.cos(torch.sqrt(x2s))) / x2s
    )


def _x_minus_sin_over_x3(x2: torch.Tensor) -> torch.Tensor:
    small = x2 < 1e-8
    x2s = torch.where(small, torch.ones_like(x2), x2)
    x = torch.sqrt(x2s)
    return torch.where(small, 1.0 / 6.0 - x2 / 120.0,
                       (x - torch.sin(x)) / (x2s * x))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3],
    R = cos(t) I + sin(t)/t W + (1-cos(t))/t^2 w w^T."""
    theta2 = torch.sum(w * w, dim=-1)
    a = _sin_over_x(theta2)[..., None, None]
    b = _one_minus_cos_over_x2(theta2)
    cos_t = (1.0 - b * theta2)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return cos_t * eye + a * hat(w) + b[..., None, None] * _outer(w)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle (angles in [0, pi))."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    small = theta < 1e-4
    denom = torch.where(small, torch.ones_like(theta), 2.0 * torch.sin(theta))
    factor = torch.where(small, 0.5 + theta * theta / 12.0, theta / denom)
    return factor[..., None] * vee(R - R.transpose(-1, -2))


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """SE(3) exp: [..., 6] (omega | v) -> (R [..., 3, 3], t [..., 3]),
    t = V v with V = (1 - c t^2) I + b W + c w w^T."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    b = _one_minus_cos_over_x2(theta2)
    c = _x_minus_sin_over_x3(theta2)
    diag = (1.0 - c * theta2)[..., None] * v
    cross = b[..., None] * torch.cross(w, v, dim=-1)
    outer = c[..., None] * w * torch.sum(w * v, dim=-1, keepdim=True)
    return so3_exp(w), diag + cross + outer


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) quaternion (normalized here) -> [..., 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 4] (w, x, y, z) unit quaternion with
    w >= 0: of the four Shepperd candidates, the one with the largest
    pivot (all four are formed, none read back)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    piv_w = 1 + tr
    piv_x = 1 + m00 - m11 - m22
    piv_y = 1 - m00 + m11 - m22
    piv_z = 1 - m00 - m11 + m22
    # each candidate row carries its raw pivot: after the 0.5/sqrt(pivot)
    # scale the pivot component is sqrt(pivot)/2
    cand = torch.stack([
        torch.stack([piv_w, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, piv_x, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, piv_y, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, piv_z], dim=-1),
    ], dim=-2)
    pivots = torch.stack([piv_w, piv_x, piv_y, piv_z], dim=-1)
    cand = cand * (0.5 / torch.sqrt(torch.clamp(pivots, min=_EPS)))[..., None]
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(
        cand, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
