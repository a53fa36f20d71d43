"""Convert a DeformingThings4D ``.anime`` clip into a fusion sequence
directory (``color/``, ``depth/``, ``intrinsics.txt``, ``gt_vertices.npy``)
that ``run_fusion`` reads: the port of ``scripts/convert_dt4d.py``, with
its flags and defaults, plus ``--device`` (the card unless ``cpu``).

  python -m occlusionfusion_tpu_torch.scripts.convert_dt4d \
      --anime clip.anime --out seq [--height 240 --width 320 --fx 300] \
      [--device cpu]

Each frame is rendered to depth by the port's point-splat rasterizer and
written as a 16-bit PNG in millimetres; colour is flat grey 128, written
as ``color/NNNNNN.png`` (the JAX script writes JPEG through Pillow; grey
128 comes back from that JPEG exactly, so both packages' sequence
readers see the same frames, and no Pillow is needed here).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--anime", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--fx", type=float, default=300.0)
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from occlusionfusion_tpu_torch.data.deformingthings4d import (
        anime_to_depth_sequence,
    )
    from occlusionfusion_tpu_torch.device import require_device
    from occlusionfusion_tpu_torch.fusion.frame_loader import write_png
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    dev = require_device(args.device)
    intr = Intrinsics(*(float(np.float32(x)) for x in (
        args.fx, args.fx, args.width / 2, args.height / 2)))
    depths, gt = anime_to_depth_sequence(
        args.anime, intr, image_hw=(args.height, args.width),
        max_frames=args.frames or None, device=dev,
    )
    os.makedirs(os.path.join(args.out, "color"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "depth"), exist_ok=True)
    K = np.array([[args.fx, 0, args.width / 2],
                  [0, args.fx, args.height / 2],
                  [0, 0, 1.0]])
    np.savetxt(os.path.join(args.out, "intrinsics.txt"), K)
    gray = np.full((args.height, args.width, 3), 128, np.uint8)
    for i, d in enumerate(depths):
        mm = np.clip(d * 1000.0, 0, 65535).astype(np.uint16)
        write_png(os.path.join(args.out, "depth", f"{i:06d}.png"), mm)
        write_png(os.path.join(args.out, "color", f"{i:06d}.png"), gray)
    np.save(os.path.join(args.out, "gt_vertices.npy"), gt)
    print(f"wrote {len(depths)} frames to {args.out}")


if __name__ == "__main__":
    main()
