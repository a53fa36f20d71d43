"""Optimisers with optax's semantics, for the trainers of the port (the
card's machine has no optax).

``Adam`` is ``optax.adam(lr)``, and with ``weight_decay`` ``optax.adamw``;
``clip_norm`` puts ``optax.clip_by_global_norm`` in front of it (the
chain of ``train_lepard.py``). The formulas are optax's, in f32:

  mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,  count += 1
  u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
  p -= lr(count - 1) * (u + weight_decay p)

The learning rate is a float or a schedule read at optax's count: the
first update reads it at 0 (with ``warmup_cosine_decay_schedule`` from 0
that is a learning rate of 0). Clipping scales the gradients by
max / |g| when |g| >= max, with no epsilon (``clip_grad_norm_`` adds
1e-6).
"""

from __future__ import annotations

import math

import torch


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0, exponent=1.0):
    """optax's: a linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps``; a function of the count."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if not span > 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps")

    def schedule(count):
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * c / span))
        return peak_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def global_norm(grads):
    """sqrt of the sum of every gradient's squares (optax's
    ``global_norm``), a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by max_norm / |g| where |g| >= max_norm, |g|)."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return [g * scale for g in grads], norm


class Adam:
    """optax's adam / adamw over ``params`` (the tensors' ``.grad`` are
    the gradients). ``lr`` is a float or a schedule of optax's count."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 clip_norm: float | None = None):
        self.params = [p for p in params]
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, self.clip_norm)
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
