"""Checkpoint loading (port of ``occlusionfusion_tpu/models/checkpoint.py``).

The repo's ``.npz`` checkpoints are flat maps: ``{"a.b.weight": array}``
for the motion-completion net, ``{"pwc/decoders/2/flow/w": array}`` for
the flow nets. The JAX package nests them into parameter pytrees;
``params_from_jax``, ``pwc_params_from_jax`` and
``masknet_params_from_jax`` turn such a pytree (numpy leaves) into the
``state_dict`` of the port's ``nn.Module``.
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
FLOW_NPZ = os.path.join(_REPO_ROOT, "checkpoints", "flow.npz")


def nest_flat_dict(flat: Dict[str, np.ndarray],
                   sep: str = ".") -> Dict[str, Any]:
    """{'a.b.weight': arr} -> {'a': {'b': {'weight': arr}}} (keys split
    at ``sep``)."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(sep)
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


def normalize_indexed(tree):
    """Undo the flat-npz round trip of lists and int-keyed dicts: a dict
    whose keys are all digit strings becomes a list when they run 0..n-1,
    else a dict with int keys (PWC decoders keyed by level 2..6)."""
    if isinstance(tree, dict):
        out = {k: normalize_indexed(v) for k, v in tree.items()}
        if out and all(
            isinstance(k, str) and k.lstrip("-").isdigit() for k in out
        ):
            ik = {int(k): v for k, v in out.items()}
            ks = sorted(ik)
            if ks == list(range(len(ks))):
                return [ik[i] for i in ks]
            return ik
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(normalize_indexed(v) for v in tree)
    return tree


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


def _conv_state(p, prefix: str) -> Dict[str, torch.Tensor]:
    """A JAX conv {"w": HWIO, "b"} -> ``Conv`` weight [O, I, kh, kw]."""
    w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(w)),
        f"{prefix}.bias": torch.from_numpy(np.array(p["b"], np.float32)),
    }


def _deconv_state(p, prefix: str) -> Dict[str, torch.Tensor]:
    """A JAX transposed conv {"w": HWIO, "b"} -> ``Deconv`` weight
    [I, O, kh, kw], spatially flipped: ``conv_transpose2d`` with the
    flipped kernel equals JAX's ``conv_transpose`` with the original."""
    w = np.asarray(p["w"], np.float32).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(w)),
        f"{prefix}.bias": torch.from_numpy(np.array(p["b"], np.float32)),
    }


def pwc_params_from_jax(np_tree) -> Dict[str, torch.Tensor]:
    """The JAX PWC-Net parameter tree (numpy leaves, raw from the npz or
    normalized) as the ``state_dict`` of ``models.pwcnet.PWCNet``."""
    tree = normalize_indexed(np_tree)
    sd: Dict[str, torch.Tensor] = {}
    for lvl, convs in enumerate(tree["extractor"]):
        for c, p in enumerate(convs):
            sd.update(_conv_state(p, f"extractor.{lvl}.{c}"))
    for lvl, dec in tree["decoders"].items():
        for c, p in enumerate(dec["convs"]):
            sd.update(_conv_state(p, f"decoders.{lvl}.convs.{c}"))
        sd.update(_conv_state(dec["flow"], f"decoders.{lvl}.flow"))
        for name in ("upflow", "upfeat"):
            if name in dec:
                sd.update(_deconv_state(dec[name], f"decoders.{lvl}.{name}"))
    for c, p in enumerate(tree["refiner"]):
        sd.update(_conv_state(p, f"refiner.{c}"))
    return sd


def masknet_params_from_jax(np_tree) -> Dict[str, torch.Tensor]:
    """The JAX MaskNet parameter tree as the ``state_dict`` of
    ``models.pwcnet.MaskNet``."""
    tree = normalize_indexed(np_tree)
    sd = {}
    sd.update(_deconv_state(tree["upconv1"], "upconv1"))
    sd.update(_deconv_state(tree["upconv2"], "upconv2"))
    sd.update(_conv_state(tree["conv_in"], "conv_in"))
    for r, pair in enumerate(tree["res"]):
        for c, p in enumerate(pair):
            sd.update(_conv_state(p, f"res.{r}.{c}"))
    sd.update(_conv_state(tree["out"], "out"))
    return sd


def load_flow_nets(path: str | None = None, device=None):
    """(PWCNet, MaskNet) with the repo's weights
    (``checkpoints/flow.npz`` unless a path is given), in eval mode."""
    from occlusionfusion_tpu_torch.device import resolve_device
    from occlusionfusion_tpu_torch.models.pwcnet import MaskNet, PWCNet

    path = path or FLOW_NPZ
    if not os.path.exists(path):
        raise FileNotFoundError(f"no flow weights at {path}")
    data = np.load(path)
    tree = nest_flat_dict({k: data[k] for k in data.files}, sep="/")
    pwc = PWCNet()
    pwc.load_state_dict(pwc_params_from_jax(tree["pwc"]))
    mask = MaskNet()
    mask.load_state_dict(masknet_params_from_jax(tree["mask"]))
    dev = resolve_device(device)
    return pwc.to(dev).eval(), mask.to(dev).eval()
