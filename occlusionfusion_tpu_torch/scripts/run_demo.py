"""The motion-completion demo over a prepared node/graph sequence: the
port of ``scripts/run_demo.py``, plus ``--device`` (the card unless
``cpu``).

  python -m occlusionfusion_tpu_torch.scripts.run_demo --input data/input \
      --output data/output [--weights checkpoints/motion_complete.npz] \
      [--device cpu]

Reads ``<input>/node/NNNN.npy`` (per node pos3 + motion3 + visible1) and
``<input>/graph/NNNN.npz`` (the 4-level pyramid), frames numbered from
1, and writes ``<output>/node/NNNN.npy`` (motion3 + confidence1) per
frame. ``MotionCompletionRunner.run_chunk`` runs ``DEMO_CHUNK`` (env,
default 32) frames a call, read back once. ``--weights`` is the repo's
npz by default; a path ending in ``.tar`` is the reference's torch
checkpoint, converted on the way in (``convert_checkpoint``).
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", default=os.path.join("data", "input"))
    ap.add_argument("--output", default=os.path.join("data", "output"))
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--weights", default=None,
                    help="motion-completion npz (default: the repo's "
                         "checkpoints/motion_complete.npz) or the "
                         "reference's torch .tar")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def load_net(weights: str | None, dev):
    from occlusionfusion_tpu_torch.models import checkpoint as ck
    from occlusionfusion_tpu_torch.models.motion_complete import (
        MotionCompleteNet,
    )

    if weights is None or not weights.endswith(".tar"):
        return ck.load_motion_complete_net(weights, device=dev)
    net = MotionCompleteNet()
    net.load_state_dict(ck.params_from_jax(ck.convert_torch_checkpoint(weights)))
    return net.to(dev).eval()


def frame_dict(node_dir: str, graph_dir: str, frame_id: int) -> dict:
    nf = np.load(os.path.join(node_dir, f"{frame_id:04d}.npy"))
    pyd = np.load(os.path.join(graph_dir, f"{frame_id:04d}.npz"))
    return dict(
        node_pos=nf[:, :3],
        node_motion=nf[:, 3:6],
        visible=nf[:, -1] > 0.5,
        nn_indexes=[pyd[f"nn_index_l{l}"] for l in range(4)],
        down_idxs=[pyd[f"down_sample_idx{i}"] for i in (1, 2, 3)],
        up_idxs=[pyd[f"up_sample_idx{i}"] for i in (1, 2, 3)],
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    from occlusionfusion_tpu_torch.device import require_device
    from occlusionfusion_tpu_torch.fusion.motion_runner import (
        MotionCompletionRunner,
    )

    dev = require_device(args.device)
    runner = MotionCompletionRunner(load_net(args.weights, dev))
    node_dir = os.path.join(args.input, "node")
    graph_dir = os.path.join(args.input, "graph")
    out_dir = os.path.join(args.output, "node")
    os.makedirs(out_dir, exist_ok=True)
    total = len(glob(os.path.join(node_dir, "*.npy")))
    if args.frames:
        total = min(total, args.frames)
    chunk = int(os.environ.get("DEMO_CHUNK", "32"))

    t_start = time.perf_counter()
    done = 0
    for start in range(1, total + 1, chunk):
        ids = list(range(start, min(start + chunk, total + 1)))
        outs = runner.run_chunk([frame_dict(node_dir, graph_dir, i)
                                 for i in ids])
        for frame_id, (motion, conf) in zip(ids, outs):
            np.save(os.path.join(out_dir, f"{frame_id:04d}.npy"),
                    np.hstack([motion, conf[:, None]]).astype(np.float32))
        done += len(ids)
    dt = time.perf_counter() - t_start
    print(f"{done} frames incl. IO: {done / dt:.1f} frames/s "
          f"({dt / max(done, 1) * 1e3:.1f} ms/frame)")


if __name__ == "__main__":
    main()
