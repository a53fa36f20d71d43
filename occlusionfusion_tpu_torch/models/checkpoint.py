"""Checkpoint loading (port of ``occlusionfusion_tpu/models/checkpoint.py``).

The repo's ``.npz`` checkpoints are flat maps: ``{"a.b.weight": array}``
for the motion-completion net, ``{"pwc/decoders/2/flow/w": array}`` for
the flow nets and the Lepard matcher (whose ``.json`` side-car holds its
configuration). The JAX package nests them into parameter pytrees;
``params_from_jax``, ``pwc_params_from_jax``, ``masknet_params_from_jax``
and ``lepard_params_from_jax`` turn such a pytree (numpy leaves) into the
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
LEPARD_NPZ = os.path.join(_REPO_ROOT, "checkpoints", "lepard_trained.npz")


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


def convert_torch_checkpoint(tar_path: str, npz_path: str | None = None):
    """The reference's torch checkpoint (a tar holding a state dict, or a
    dict with ``model_state_dict``) -> the nested numpy tree of the JAX
    layout; written as the flat npz the repo's checkpoints use where
    ``npz_path`` is given. The tar is a pickle: load only a trusted
    file."""
    ck = torch.load(tar_path, map_location="cpu", weights_only=False)
    sd = ck["model_state_dict"] if "model_state_dict" in ck else ck
    flat = {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in sd.items()}
    if npz_path:
        np.savez(npz_path, **flat)
    return nest_flat_dict(flat)


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
    (``checkpoints/flow.npz`` unless a path is given), in eval mode; the
    MaskNet is None where the checkpoint has none (``train_flow``
    without ``--with_mask``)."""
    from occlusionfusion_tpu_torch.device import resolve_device
    from occlusionfusion_tpu_torch.models.pwcnet import MaskNet, PWCNet

    path = path or FLOW_NPZ
    if not os.path.exists(path):
        raise FileNotFoundError(f"no flow weights at {path}")
    data = np.load(path)
    tree = nest_flat_dict({k: data[k] for k in data.files}, sep="/")
    pwc = PWCNet()
    pwc.load_state_dict(pwc_params_from_jax(tree["pwc"]))
    dev = resolve_device(device)
    if "mask" not in tree:
        return pwc.to(dev).eval(), None
    mask = MaskNet()
    mask.load_state_dict(masknet_params_from_jax(tree["mask"]))
    return pwc.to(dev).eval(), mask.to(dev).eval()


def _as_blocks(res):
    """A block list as the JAX ``kpconv._as_blocks`` reads it: a list, a
    dict with digit keys (a flat-npz round trip), or one legacy block
    (a dict holding ``down``)."""
    if isinstance(res, dict) and "down" in res:
        return [res]
    if isinstance(res, dict):
        return [res[k] for k in sorted(res, key=int)]
    return list(res)


def _flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> {"a.0.b": leaf}; empty dicts vanish."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    flat = {}
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(_flatten_tree(v, name))
        else:
            flat[name] = np.asarray(v)
    return flat


def lepard_params_from_jax(np_tree) -> Dict[str, torch.Tensor]:
    """The JAX Lepard parameter tree (numpy leaves; fresh, or nested from
    the npz with digit keys and the positioning layers' empty dicts
    dropped) as the ``state_dict`` of ``models.lepard.LepardNet``."""
    kp = dict(np_tree["kpfcn"])
    kp["enc"] = [dict(stage, res=_as_blocks(stage["res"]))
                 for stage in _as_blocks(kp["enc"])]
    if "dec" in kp:
        kp["dec"] = _as_blocks(kp["dec"])
    tree = dict(np_tree, kpfcn=kp)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in _flatten_tree(tree).items()}


def lepard_config_from_json(d: dict):
    """The port's ``LepardConfig`` from a checkpoint's side-car dict (the
    fields the JAX ``load_lepard_checkpoint`` reads, with its defaults
    for the optional ones)."""
    from occlusionfusion_tpu_torch.models import kpconv as K
    from occlusionfusion_tpu_torch.models.lepard import LepardConfig
    from occlusionfusion_tpu_torch.models.transformer3d import (
        RepositionConfig,
    )

    kp, pyr, rp = d["kpfcn"], d["kpfcn"]["pyramid"], d["reposition"]
    return LepardConfig(
        kpfcn=K.KPFCNConfig(
            in_dim=kp["in_dim"], first_dim=kp["first_dim"],
            out_dim=kp["out_dim"],
            num_kernel_points=kp["num_kernel_points"],
            blocks_per_stage=kp["blocks_per_stage"],
            num_stages=kp.get("num_stages", 2),
            coarse_upsamples=kp.get("coarse_upsamples", 0),
            kp_layout=kp.get("kp_layout", "fibonacci"),
            pyramid=K.PyramidConfig(
                level_sizes=tuple(pyr["level_sizes"]),
                first_voxel=pyr["first_voxel"],
                radius_scale=pyr["radius_scale"],
                max_neighbors=tuple(pyr["max_neighbors"]),
            ),
        ),
        reposition=RepositionConfig(
            dim=rp["dim"], heads=rp["heads"],
            layer_types=tuple(rp["layer_types"]),
            rope_voxel=rp["rope_voxel"], temperature=rp["temperature"],
        ),
        match_threshold=d["match_threshold"],
        blend_knn=d["blend_knn"],
        blend_radius=d["blend_radius"],
        coherence_tau=d.get("coherence_tau", 0.0),
        coherence_knn=d.get("coherence_knn", 4),
        coherence_mad=d.get("coherence_mad", 0.0),
    )


def load_lepard_checkpoint(npz_path: str | None = None, device=None,
                           config=None):
    """(LepardNet in eval mode, LepardConfig) from a matcher checkpoint
    (``checkpoints/lepard_trained.npz`` and its ``.json`` side-car unless
    a path is given). ``config`` overrides the side-car's (a smaller
    pyramid over the same weights, as the tests use)."""
    import json

    from occlusionfusion_tpu_torch.device import resolve_device
    from occlusionfusion_tpu_torch.models.lepard import LepardNet

    path = npz_path or LEPARD_NPZ
    if not os.path.exists(path):
        raise FileNotFoundError(f"no Lepard weights at {path}")
    if config is None:
        with open(path + ".json") as fh:
            config = lepard_config_from_json(json.load(fh))
    data = np.load(path)
    tree = nest_flat_dict({k: data[k] for k in data.files}, sep="/")
    net = LepardNet(config)
    net.load_state_dict(lepard_params_from_jax(tree))
    return net.to(resolve_device(device)).eval(), config


# ---------------------------------------------------------------------------
# the other direction: a module's parameters as the JAX package's tree


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32)


def params_to_jax(net) -> Dict[str, Any]:
    """The motion-completion net's parameters as the JAX package's nested
    tree (numpy leaves): the inverse of ``params_from_jax``."""
    return nest_flat_dict({k: _np(v) for k, v in net.state_dict().items()})


def _conv_tree(sd, prefix: str) -> Dict[str, np.ndarray]:
    """A ``Conv``'s weight [O, I, kh, kw] as a JAX conv {"w": HWIO, "b"}."""
    w = _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)
    return {"w": np.ascontiguousarray(w), "b": _np(sd[f"{prefix}.bias"])}


def _deconv_tree(sd, prefix: str) -> Dict[str, np.ndarray]:
    """A ``Deconv``'s flipped weight [I, O, kh, kw] as the JAX transposed
    conv {"w": HWIO, "b"} (the inverse of ``_deconv_state``)."""
    w = _np(sd[f"{prefix}.weight"])[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return {"w": np.ascontiguousarray(w), "b": _np(sd[f"{prefix}.bias"])}


def pwc_params_to_jax(net) -> Dict[str, Any]:
    """A ``PWCNet``'s parameters as the JAX PWC-Net tree (decoders keyed by
    level as ints): the inverse of ``pwc_params_from_jax``."""
    sd = net.state_dict()
    tree: Dict[str, Any] = {
        "extractor": [[_conv_tree(sd, f"extractor.{l}.{c}") for c in range(3)]
                      for l in range(len(net.extractor))],
        "decoders": {},
        "refiner": [_conv_tree(sd, f"refiner.{c}")
                    for c in range(len(net.refiner))],
    }
    for lvl, dec in net.decoders.items():
        d = {"convs": [_conv_tree(sd, f"decoders.{lvl}.convs.{c}")
                       for c in range(len(dec.convs))],
             "flow": _conv_tree(sd, f"decoders.{lvl}.flow")}
        for name in ("upflow", "upfeat"):
            if hasattr(dec, name):
                d[name] = _deconv_tree(sd, f"decoders.{lvl}.{name}")
        tree["decoders"][int(lvl)] = d
    return tree


def masknet_params_to_jax(net) -> Dict[str, Any]:
    """A ``MaskNet``'s parameters as the JAX MaskNet tree."""
    sd = net.state_dict()
    return {
        "upconv1": _deconv_tree(sd, "upconv1"),
        "upconv2": _deconv_tree(sd, "upconv2"),
        "conv_in": _conv_tree(sd, "conv_in"),
        "res": [[_conv_tree(sd, f"res.{r}.{c}") for c in range(2)]
                for r in range(len(net.res))],
        "out": _conv_tree(sd, "out"),
    }


def _listify(tree):
    """Nested dicts whose keys are all digits as lists, a missing index
    (a positioning layer, which holds no parameters) as {}."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out.get(str(i), {}) for i in range(max(map(int, out)) + 1)]
    return out


def lepard_params_to_jax(net) -> Dict[str, Any]:
    """A ``LepardNet``'s parameters as the JAX Lepard tree (lists where the
    JAX init has lists, {} for the positioning layers): the inverse of
    ``lepard_params_from_jax``."""
    return _listify(nest_flat_dict(
        {k: _np(v) for k, v in net.state_dict().items()}))


def _config_dict(nt) -> Dict[str, Any]:
    d = {}
    for k, v in nt._asdict().items():
        if hasattr(v, "_asdict"):
            d[k] = _config_dict(v)
        elif isinstance(v, (tuple, list)):
            d[k] = list(v)
        else:
            d[k] = v
    return d


def save_lepard_checkpoint(npz_path: str, net, config) -> None:
    """Matcher weights (npz, the JAX ``save_pytree`` layout) and the
    ``LepardConfig`` that rebuilds the static pyramid and transformer
    shapes (the ``.json`` side-car), as the JAX
    ``save_lepard_checkpoint`` writes them."""
    import json

    from occlusionfusion_tpu_torch.utils.snapshot import save_pytree

    save_pytree(npz_path, lepard_params_to_jax(net))
    with open(npz_path + ".json", "w") as fh:
        json.dump(_config_dict(config), fh, indent=1)
