"""Checkpoint loading (port of ``occlusionfusion_tpu/models/checkpoint.py``).

The repo's ``.npz`` checkpoints are flat ``{"a.b.weight": array}`` maps.
The JAX package nests them into parameter pytrees; ``params_from_jax``
turns such a pytree (numpy leaves) back into the ``state_dict`` of the
port's ``nn.Module``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
MOTION_COMPLETE_NPZ = os.path.join(_REPO_ROOT, "checkpoints", "motion_complete.npz")


def nest_flat_dict(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{'a.b.weight': arr} -> {'a': {'b': {'weight': arr}}}."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def flatten_nested(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_nested(v, name))
        else:
            flat[name] = np.asarray(v)
    return flat


def load_params(npz_path: str) -> Dict[str, Any]:
    """A converted checkpoint (.npz) as a nested numpy tree."""
    data = np.load(npz_path)
    return nest_flat_dict({k: data[k] for k in data.files})


def params_from_jax(np_tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's nested parameter tree (numpy leaves) as a torch
    ``state_dict``: keys joined with dots, leaves as f32 tensors."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in flatten_nested(np_tree).items()
    }


def load_motion_complete_net(npz_path: str | None = None, device=None):
    """The motion-completion net with the repo's pretrained weights
    (``checkpoints/motion_complete.npz`` unless a path is given)."""
    from occlusionfusion_tpu_torch.device import resolve_device
    from occlusionfusion_tpu_torch.models.motion_complete import (
        MotionCompleteNet,
    )

    path = npz_path or MOTION_COMPLETE_NPZ
    if not os.path.exists(path):
        raise FileNotFoundError(f"no motion-completion weights at {path}")
    net = MotionCompleteNet()
    net.load_state_dict(params_from_jax(load_params(path)))
    return net.to(resolve_device(device)).eval()
