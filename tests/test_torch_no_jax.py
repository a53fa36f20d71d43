"""The port and chip_smoke.py must run where JAX is not installed: every
module of occlusionfusion_tpu_torch, and chip_smoke, imports with ``jax``
blocked and loads nothing of the JAX package; no kernel source includes
PyTorch's C++ headers (which would make the nvcc build take minutes)."""

import glob
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "occlusionfusion_tpu_torch")


def _port_modules():
    mods = []
    for path in sorted(glob.glob(os.path.join(PKG, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith("__init__") else rel)
    return mods


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "occlusionfusion_tpu_torch.ops.knn" in mods and len(mods) > 20
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {REPO!r})
        for name in ("jax", "jaxlib", "occlusionfusion_tpu"):
            sys.modules[name] = None
        for m in {mods!r} + ["chip_smoke"]:
            importlib.import_module(m)
        leaked = [m for m, v in sys.modules.items() if v is not None and (
                  m == "jax" or m.startswith("jax.")
                  or m.startswith("occlusionfusion_tpu."))]
        assert not leaked, leaked
        print("ok", len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_kernel_source_includes_torch_headers():
    sources = glob.glob(os.path.join(PKG, "**", "*.cu"), recursive=True)
    sources += glob.glob(os.path.join(PKG, "**", "*.cuh"), recursive=True)
    assert len(sources) >= 3
    for src in sources:
        text = open(src).read()
        assert "torch/extension.h" not in text, src
        assert "#include <torch" not in text and "ATen" not in text, src


def test_port_never_names_the_jax_package_in_imports():
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        for line in open(path):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s.split()[1], (path, s)
                assert not s.split()[1].startswith("occlusionfusion_tpu."), (
                    path, s)
