"""SO(3) maps in PyTorch (port of ``occlusionfusion_tpu/geometry/so3.py``).

Exponential and log maps with the same small-angle branches as the JAX
package, written with ``torch.where`` on safe operands. Rodrigues goes
through the outer product w w^T, matmul-free as in the reference.
All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


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
