"""Every public function and class of the JAX package has a counterpart in
the port. Walks both packages' sources (ASTs only; nothing is imported
or changed) and fails on a public top-level name of a JAX module with no
counterpart: the same name in the same module of the port, or the
renamed counterpart RENAMES names, or an entry of WAITING, which names
the ROADMAP item it waits for."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "occlusionfusion_tpu")
PORT_PKG = os.path.join(ROOT, "occlusionfusion_tpu_torch")

# JAX "module::name" -> the port's "module::name" or "module::Class.attr"
RENAMES = {
    # the TPU kernels and their lax twins: a CUDA kernel's wrapper and
    # the plain-torch twin
    "ops/knn.py::knn_lax": "ops/knn.py::knn_torch",
    "ops/knn.py::knn_pallas": "ops/knn.py::knn_cuda",
    "ops/lbs.py::lbs_warp_lax": "ops/lbs.py::lbs_warp_torch",
    "ops/lbs.py::lbs_warp_pallas": "ops/lbs.py::lbs_warp_cuda",
    # K3 and K4 add straight into the dense system as K3'/K4' (ROADMAP
    # Queue 2)
    "ops/gn_assembly.py::point_term_blocks_pallas":
        "ops/gn_assembly.py::point_term_accumulate_cuda",
    "ops/gn_assembly.py::arap_term_blocks_pallas":
        "ops/gn_assembly.py::arap_term_accumulate_cuda",
    # parameter trees and forward functions -> nn.Modules
    "models/checkpoint.py::load_motion_complete_params":
        "models/checkpoint.py::load_motion_complete_net",
    "models/motion_complete.py::init_params":
        "models/motion_complete.py::init_motion_complete_net",
    "models/lepard.py::init_lepard_params": "models/lepard.py::init_lepard",
    "models/kpconv.py::init_kpfcn_params": "models/kpconv.py::init_kpfcn_",
    "models/kpconv.py::resnetb_params": "models/kpconv.py::ResnetB",
    "models/kpconv.py::resnetb_block": "models/kpconv.py::ResnetB.forward",
    # the first conv -> norm -> leaky relu of the encoder
    "models/kpconv.py::kpconv_block": "models/kpconv.py::kpfcn_encode",
    "models/pwcnet.py::PWCNetParams": "models/pwcnet.py::PWCNet",
    "models/pwcnet.py::init_pwcnet_params": "models/pwcnet.py::init_pwcnet",
    "models/pwcnet.py::init_masknet_params":
        "models/pwcnet.py::init_masknet",
    "models/pwcnet.py::pwcnet_forward": "models/pwcnet.py::PWCNet.forward",
    "models/pwcnet.py::pwcnet_forward_multiscale":
        "models/pwcnet.py::PWCNet.forward_multiscale",
    "models/pwcnet.py::masknet_forward": "models/pwcnet.py::MaskNet.forward",
    "models/pwcnet.py::extract_pyramid": "models/pwcnet.py::PWCNet.pyramid",
    "models/transformer3d.py::init_attention_params":
        "models/transformer3d.py::AttentionLayer",
    "models/transformer3d.py::init_reposition_params":
        "models/transformer3d.py::init_reposition_",
    # the JAX host twin of the device mask for bricked meshes; the port's
    # mesh extraction runs the torch function on the bricks' volume
    "fusion/bricks.py::truncated_region_mask_np":
        "fusion/tsdf.py::truncated_region_mask",
}

# names that wait, with the ROADMAP item that holds them
WAITING = {}


def public_names(pkg):
    """{module path relative to the package: {public top-level name:
    {its methods}}} from the sources."""
    out = {}
    for root, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs
                         if d not in ("csrc", "_build", "__pycache__"))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            names = {}
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)) and (
                        not node.name.startswith("_")):
                    names[node.name] = {
                        n.name for n in getattr(node, "body", [])
                        if isinstance(n, ast.FunctionDef)}
            out[os.path.relpath(path, pkg)] = names
    return out


JAX = public_names(JAX_PKG)
PORT = public_names(PORT_PKG)


def _exists(target: str) -> bool:
    module, name = target.split("::")
    cls, _, attr = name.partition(".")
    names = PORT.get(module, {})
    return cls in names and (not attr or attr in names[cls])


@pytest.mark.parametrize("module", sorted(JAX))
def test_every_public_jax_name_has_a_port_counterpart(module):
    missing = []
    for name in sorted(JAX[module]):
        key = f"{module}::{name}"
        if key in WAITING or name in PORT.get(module, {}):
            continue
        if key in RENAMES and _exists(RENAMES[key]):
            continue
        missing.append(key)
    assert not missing, f"no port counterpart: {missing}"


def test_the_maps_name_real_code():
    """Every rename's source exists in JAX and its target in the port;
    every waiting name exists in JAX and not in the port."""
    for key, target in RENAMES.items():
        module, name = key.split("::")
        assert name in JAX[module], key
        assert _exists(target), target
    for key in WAITING:
        module, name = key.split("::")
        assert name in JAX[module] and name not in PORT.get(module, {}), key
