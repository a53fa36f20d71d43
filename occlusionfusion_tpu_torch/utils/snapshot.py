"""Checkpoint / resume snapshots (port of
``occlusionfusion_tpu/utils/snapshot.py``, in numpy).

One flat npz per snapshot: every leaf of a nested tree of dicts and
NamedTuples (tensors, numpy arrays or scalars) under its slash-joined
path, dict keys in sorted order and NamedTuple fields by name, with None
leaves left out. These are the keys the JAX package writes through its
pytree flattening, so a snapshot of either package loads in the other.
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch

from occlusionfusion_tpu_torch.models.checkpoint import nest_flat_dict


def _flatten(tree, prefix: str, out: dict) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix] = np.asarray(tree)
        return
    for k, v in items:
        _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)


def save_pytree(path: str, tree: Any) -> None:
    """Save a nested dict / NamedTuple tree of arrays as a flat npz."""
    flat: dict = {}
    _flatten(tree, "", flat)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_flat(path: str) -> dict:
    """A flat npz snapshot as {slash/path: array}."""
    data = np.load(path)
    return {k: data[k] for k in data.files}


def load_params(path: str) -> dict:
    """A snapshot saved by ``save_pytree`` as a nested dict of numpy
    arrays (split at "/" and at ".", as the JAX package splits)."""
    return nest_flat_dict({k.replace("/", "."): v
                           for k, v in load_flat(path).items()})


class SnapshotManager:
    """Time-gated snapshot saver: ``maybe_save`` writes at most once per
    ``min_interval_s`` unless forced."""

    def __init__(self, directory: str, min_interval_s: float = 300.0):
        self.directory = directory
        self.min_interval_s = min_interval_s
        self._last = 0.0
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, name: str, tree: Any, force: bool = False) -> bool:
        now = time.time()
        if not force and now - self._last < self.min_interval_s:
            return False
        save_pytree(os.path.join(self.directory, f"{name}.npz"), tree)
        self._last = now
        return True
