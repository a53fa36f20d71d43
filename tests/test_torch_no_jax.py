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


def test_tools_run_without_jax_pillow_or_matplotlib(tmp_path):
    """The evaluation and export tools run on the CPU with jax, the JAX
    package, Pillow and matplotlib blocked (the card's machine has none of
    them): export_deepdeform at 64x64, evaluate_deepdeform with the flow
    net on one sample (graphs padded to 128 nodes), evaluate_dt4d for 2
    frames at 32^3 / 128 nodes, and visualize_demo on run_demo's
    output."""
    code = textwrap.dedent(f"""
        import dataclasses, functools, os, sys
        sys.path.insert(0, {REPO!r})
        for name in ("jax", "jaxlib", "occlusionfusion_tpu", "PIL",
                     "matplotlib"):
            sys.modules[name] = None
        import chip_smoke as CS
        from occlusionfusion_tpu_torch.data import deepdeform as DD
        from occlusionfusion_tpu_torch.fusion import pipeline as P
        from occlusionfusion_tpu_torch.scripts import (
            evaluate_deepdeform, evaluate_dt4d, export_deepdeform,
            run_demo, visualize_demo)
        DD.DeepDeformConfig = functools.partial(DD.DeepDeformConfig,
                                                max_nodes=128)
        cfg = P.FusionConfig
        P.FusionConfig = lambda *a, **kw: dataclasses.replace(
            cfg(*a, **kw), vol_dim=(32, 32, 32), voxel_size=0.012,
            max_nodes=128, max_points=1024)
        tmp, cpu = {str(tmp_path)!r}, ["--device", "cpu"]
        dd = os.path.join(tmp, "dd")
        export_deepdeform.main(["--out", dd, "--frames", "2", "--height",
                                "64", "--width", "64", "--verts", "2000"]
                               + cpu)
        m, _ = evaluate_deepdeform.main(
            ["--root", dd, "--height", "64", "--width", "64",
             "--flow_weights", CS.EVAL_FLOW, "--max_samples", "1"] + cpu)
        assert m["samples"] == 1 and "epe2d_px" in m, m
        m, _ = evaluate_dt4d.main(["--synthetic", "--frames", "2"] + cpu)
        assert m["frames"] == 2, m
        demo_in, demo_out = (os.path.join(tmp, d) for d in ("in", "out"))
        CS.cli_demo_dir(demo_in)
        run_demo.main(["--input", demo_in, "--output", demo_out,
                       "--frames", "1"] + cpu)
        pngs = visualize_demo.main(["--input", demo_in, "--output",
                                    demo_out, "--frames", "1", "--out_dir",
                                    os.path.join(tmp, "viz")])
        leaked = [m for m, v in sys.modules.items() if v is not None and (
                  m.split(".")[0] in ("jax", "PIL", "matplotlib")
                  or m.startswith("occlusionfusion_tpu."))]
        assert not leaked, leaked
        print("ok", len(pngs))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines()[-1] == "ok 1"
