"""Convert the reference's motion-completion torch checkpoint (a tar) to
the repo's flat npz: the port of ``scripts/convert_checkpoint.py``.

  python -m occlusionfusion_tpu_torch.scripts.convert_checkpoint \
      model_noise_all.tar [checkpoints/motion_complete.npz]

The tar is unpickled (``torch.load(weights_only=False)``): convert only a
file you trust.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tar_path")
    ap.add_argument("npz_path", nargs="?",
                    default="checkpoints/motion_complete.npz")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from occlusionfusion_tpu_torch.models.checkpoint import (
        convert_torch_checkpoint,
    )

    convert_torch_checkpoint(args.tar_path, args.npz_path)
    print(f"wrote {args.npz_path}")


if __name__ == "__main__":
    main()
