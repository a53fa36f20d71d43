#!/usr/bin/env python3
"""The JAX package's results on the inputs of the PyTorch port's
chip_smoke.py phases ``distributed`` and ``cli``, on the CPU:

* JAX's ``solve_dense`` on __graft_entry__.py's phase-5 problem
  (chip_smoke.distributed_draws: 8192 points, 512 nodes, 4 iterations);
* the JAX scripts on chip_smoke's CLI files (cli_clip, cli_pair,
  cli_demo_dir) with chip_smoke.cli_argv's arguments: convert_dt4d at
  448x640, run_fusion at its defaults (N-ICP) and with --solver gn_dense
  (median deformed-node z, per-frame correspondences), register_pair
  with both solvers (final loss, warped points), run_demo (its outputs).

Prints CLI_REFERENCE as one JSON line (paste it into chip_smoke.py) and
writes reference/cli_parallel.npz (the phase-5 translations,
register_pair's warped points, run_demo's outputs).

    JAX_PLATFORMS=cpu python scripts/torch_cli_reference.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import runpy
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import chip_smoke as CS  # noqa: E402
from occlusionfusion_tpu.geometry.skinning import skinning_weights  # noqa: E402
from occlusionfusion_tpu.ops.knn import knn_lax  # noqa: E402
from occlusionfusion_tpu.solvers.gauss_newton import (  # noqa: E402
    GNConfig,
    GNProblem,
)
from occlusionfusion_tpu.solvers.gauss_newton_dense import solve_dense  # noqa: E402


def run_script(name, argv) -> str:
    """A JAX script in-process (runpy) -> its standard output."""
    old, out = sys.argv, io.StringIO()
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, "scripts", f"{name}.py"),
                           run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


def phase5_translations() -> np.ndarray:
    pts, nodes, targets = (jnp.asarray(a) for a in CS.distributed_draws())
    anchors, weights, valid = skinning_weights(pts, nodes, None,
                                               CS.DIST_COVERAGE, k=4)
    d2, idx = knn_lax(nodes, nodes, k=9)
    ew = jnp.exp(-d2[:, 1:] / (2 * CS.DIST_COVERAGE**2))
    ew = ew / jnp.sum(ew, axis=1, keepdims=True)
    n = CS.DIST_NODES
    problem = GNProblem(
        source_points=pts, point_anchors=anchors, point_weights=weights,
        target_points=targets, point_valid=valid.astype(jnp.float32),
        nodes=nodes, node_valid=jnp.ones(n, bool), edges=idx[:, 1:],
        edge_weights=ew, motion_targets=jnp.zeros((n, 3)),
        motion_confidence=jnp.zeros(n), solve_node_mask=jnp.ones(n, bool),
    )
    res = solve_dense(problem, GNConfig(**CS.DIST_GN, assembly="blocks"))
    assert bool(res.valid)
    return np.asarray(res.translations)


def main():
    from occlusionfusion_tpu.utils.viz import load_ply

    t_all = time.perf_counter()
    ref, arrays = {}, {"phase5_translations": phase5_translations()}
    with tempfile.TemporaryDirectory() as root:
        verts, faces, offs = CS.cli_clip(os.path.join(root, "clip.anime"))
        CS.cli_pair(root, verts, faces, offs)
        CS.cli_demo_dir(os.path.join(root, "demo_in"))
        run_script("convert_dt4d", CS.cli_argv("convert_dt4d", root))
        for solver in ("nicp", "gn_dense"):
            name = f"run_fusion_{solver}"
            t0 = time.perf_counter()
            run_script("run_fusion", CS.cli_argv(name, root))
            med_z, corr = CS.run_fusion_outcome(os.path.join(root, name))
            ref[name] = dict(median_z=med_z, n_correspondences=corr,
                             seconds=time.perf_counter() - t0)
        for solver in ("nicp", "gn_dense"):
            name = f"register_pair_{solver}"
            t0 = time.perf_counter()
            out = run_script("register_pair", CS.cli_argv(name, root))
            ref[name] = dict(final_loss=CS.final_loss(out),
                             seconds=time.perf_counter() - t0)
            arrays[name] = load_ply(os.path.join(root, f"{name}.ply"))[0]
        weights = os.path.join(REPO, "checkpoints", "motion_complete.npz")
        run_script("run_demo", CS.cli_argv("run_demo", root)
                   + ["--weights", weights])
        arrays["run_demo"] = np.stack([
            np.load(os.path.join(root, "demo_out", "node", f"{f:04d}.npy"))
            for f in range(1, CS.DEMO_FRAMES + 1)])
    np.savez_compressed(CS.CLI_NPZ, **arrays)
    print(json.dumps(ref), flush=True)
    print(f"wrote {CS.CLI_NPZ} ({os.path.getsize(CS.CLI_NPZ)} bytes); "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
