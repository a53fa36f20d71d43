#!/usr/bin/env python3
"""The JAX package's results on the inputs of the PyTorch port's
chip_smoke.py phase ``evaluate``, on the CPU:

* the port's ``export_deepdeform`` at its defaults (arms, 8 frames,
  160x160), run here on the CPU: the sha256 of every file it writes but
  the pixel-anchor weights, after checking that its pixel anchors equal
  JAX's ``pixel_anchors_euclidean`` on each sample's source frame
  (weights within 1e-6); JAX's anchors and weights on frame 0;
* JAX's ``scripts/evaluate_deepdeform.py`` on that tree with --gt_flow
  and with --flow_weights checkpoints/flow.npz: per sample graph_mm,
  epe3d_mm, epe2d_px, the valid solves, and the match candidates (JAX's
  own flow validity);
* JAX's ``scripts/evaluate_dt4d.py --synthetic --shape limbs --rotate_deg
  3`` at its defaults (gn_dense, the fused step) and with the perception
  settings (--flow_weights checkpoints/flow.npz --textured
  --lepard_weights checkpoints/lepard_trained.npz, the stepwise loop):
  per-frame EPE and correspondences, ate_m, pose_ate_m; then on the
  depths scaled by chip_smoke.EVAL_ENSEMBLE (1 + 2e-6 for the default
  run, 1 +- 1e-6 and 1 +- 2e-6 with the perception settings: ROADMAP
  F9's and F17's ensembles);
* its ``--trajectory`` score of JAX's own estimated poses of the gn_dense
  run.

Writes reference/eval_tools.npz (chip_smoke.EVAL_NPZ) and prints the
scalars as one JSON line.

    JAX_PLATFORMS=cpu python scripts/torch_eval_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import chip_smoke as CS  # noqa: E402
from torch_port_impl import run_jax_script  # noqa: E402

def check_anchors(root):
    """JAX's pixel anchors on every sample's source frame against the
    exported ones; returns JAX's (anchors, weights) of sample 0."""
    from occlusionfusion_tpu.graph.pixel_anchors import (
        pixel_anchors_euclidean,
    )
    from occlusionfusion_tpu_torch.data import formats

    first = None
    for s in CS.eval_samples(root):
        pts, nodes = CS.eval_source_frame(root, s)
        a, w = pixel_anchors_euclidean(pts, nodes, None, CS.EVAL_COVERAGE)
        a_t = formats.load_int_image(os.path.join(root, s["pixel_anchors"]))
        w_t = formats.load_float_image(os.path.join(root, s["pixel_weights"]))
        np.testing.assert_array_equal(a_t, a.transpose(2, 0, 1))
        np.testing.assert_allclose(w_t, w.transpose(2, 0, 1), atol=1e-6)
        if first is None:
            first = (a, w)
    return first


def match_candidates(root, flow_weights):
    """Each sample's match candidates as the JAX script forms them."""
    from occlusionfusion_tpu.data.deepdeform import (
        DeepDeformConfig,
        DeepDeformDataset,
    )
    from occlusionfusion_tpu.fusion.flow_correspondence import (
        flow_correspondences,
    )
    from occlusionfusion_tpu.geometry.camera import bilinear_sample
    from occlusionfusion_tpu.models.checkpoint import normalize_indexed
    from occlusionfusion_tpu.utils.snapshot import load_params

    ds = DeepDeformDataset(root, "train", DeepDeformConfig(
        image_height=CS.EVAL_HW, image_width=CS.EVAL_HW))
    ck = normalize_indexed(load_params(flow_weights)) if flow_weights else None
    H = W = CS.EVAL_HW
    out = []
    for s in (ds[i] for i in range(len(ds))):
        oflow = s["optical_flow"].transpose(1, 2, 0)
        gt_valid = np.isfinite(oflow).all(-1) & (s["source"][5] > 0)
        if ck is None:
            flow = np.where(gt_valid[..., None], oflow, 0.0)
            v, u = np.mgrid[0:H, 0:W].astype(np.float32)
            uv = jnp.asarray(np.stack([u + flow[..., 0], v + flow[..., 1]],
                                      -1))
            lifted = bilinear_sample(
                jnp.asarray(s["target"])[3:].transpose(1, 2, 0),
                uv.reshape(-1, 2)).reshape(H, W, 3)
            valid = np.asarray(jnp.asarray(gt_valid) & (lifted[..., 2] > 0))
        else:
            _, _, valid, _ = flow_correspondences(
                ck["pwc"], jnp.asarray(s["source"]),
                jnp.asarray(s["target"]), mask_params=ck.get("mask"))
        ok = ((s["pixel_anchors"][0] >= 0) & (s["source"][5] > 0)
              & np.asarray(valid))
        out.append(int(ok.sum()))
    return out


def deepdeform_reference(root, arrays, ref):
    for name, flag in (("gt", ["--gt_flow"]),
                       ("flow", ["--flow_weights", CS.EVAL_FLOW])):
        t0 = time.perf_counter()
        local, _ = run_jax_script("evaluate_deepdeform",
                                  ["--root", root] + flag)
        m = local["main"]
        arrays[f"dd_{name}_graph_mm"] = np.asarray(m["graph_mm"])
        arrays[f"dd_{name}_epe3d_mm"] = np.asarray(m["epe3d_mm"])
        arrays[f"dd_{name}_epe2d_px"] = np.asarray(m["epe2d"], np.float64)
        arrays[f"dd_{name}_valid"] = np.asarray(m["valid_solves"])
        arrays[f"dd_{name}_candidates"] = np.asarray(match_candidates(
            root, None if name == "gt" else CS.EVAL_FLOW))
        ref[f"deepdeform_{name}_s"] = time.perf_counter() - t0


def dt4d_run(name, scale):
    """JAX's evaluate_dt4d on the depth scaled by 1 + ``scale``: (its main's
    locals, per-frame correspondences, seconds)."""
    from occlusionfusion_tpu.data import deformingthings4d as DT

    step = "register_frame" if name == "perception" else "register_frame_fused"
    t0 = time.perf_counter()
    with CS.scaled_depths(DT, 1.0 + scale):
        local, rets = run_jax_script("evaluate_dt4d", CS.eval_dt4d_argv(name),
                                     returns=(step,))
    corr = [r["n_correspondences"] if step == "register_frame"
            else int(np.asarray(r[1])[1]) for r in rets[step]]
    return local["main"], corr, time.perf_counter() - t0


def dt4d_reference(name, arrays, ref):
    """The unscaled run and the ensemble of CS.EVAL_ENSEMBLE[name]."""
    m, corr, s = dt4d_run(name, 0.0)
    arrays[f"dt4d_{name}_epe"] = np.asarray(m["per_frame_epe"])
    arrays[f"dt4d_{name}_correspondences"] = np.asarray(corr)
    arrays[f"dt4d_{name}_ate"] = np.asarray(float(m["ate"]))
    ref[f"dt4d_{name}"] = dict(
        ate_m=float(m["ate"]), pose_ate_m=m["pose_metrics"]["pose_ate_m"],
        final_epe_m=m["per_frame_epe"][-1], nodes=int(m["fusion"].node_count),
        valid_solves=int(m["n_valid_solves"]), seconds=s)
    ens = [dt4d_run(name, scale) for scale in CS.EVAL_ENSEMBLE[name]]
    arrays[f"dt4d_{name}_ensemble_epe"] = np.asarray(
        [e[0]["per_frame_epe"] for e in ens])
    arrays[f"dt4d_{name}_ensemble_correspondences"] = np.asarray(
        [e[1] for e in ens])
    arrays[f"dt4d_{name}_ensemble_ate"] = np.asarray(
        [float(e[0]["ate"]) for e in ens])
    return m


def main():
    from occlusionfusion_tpu_torch.scripts import export_deepdeform

    t_all = time.perf_counter()
    arrays, ref = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "dd")
        export_deepdeform.main(CS.eval_export_argv(root) + ["--device",
                                                            "cpu"])
        names, digests = CS.tree_digests(root)
        arrays["export_files"] = np.asarray(names)
        arrays["export_sha256"] = np.asarray(digests)
        a0, w0 = check_anchors(root)
        arrays["anchors_frame0"] = a0.astype(np.int16)
        arrays["weights_frame0"] = w0.astype(np.float32)
        deepdeform_reference(root, arrays, ref)

        m = dt4d_reference("gn_dense", arrays, ref)
        traj = dict(frame_ids=np.asarray(m["est_ids"]),
                    rotations=np.stack(m["est_R"]),
                    translations=np.stack(m["est_t"]))
        dt4d_reference("perception", arrays, ref)
        path = os.path.join(tmp, "trajectory.npz")
        np.savez(path, **traj)
        local, _ = run_jax_script("evaluate_dt4d", CS.eval_dt4d_argv(
            "gn_dense") + ["--trajectory", path])
        ref["trajectory"] = local["main"]["metrics"]
        arrays.update({f"trajectory_{k}": v for k, v in traj.items()})
    arrays["scalars"] = np.asarray(json.dumps(ref))
    np.savez_compressed(CS.EVAL_NPZ, **arrays)
    print(json.dumps(ref), flush=True)
    print(f"wrote {CS.EVAL_NPZ} ({os.path.getsize(CS.EVAL_NPZ)} bytes); "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
