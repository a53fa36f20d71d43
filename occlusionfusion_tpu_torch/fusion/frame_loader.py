"""In-memory RGB-D sequences (port's own copy of ``Frame`` and
``ArraySequence`` from ``occlusionfusion_tpu/fusion/frame_loader.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from occlusionfusion_tpu_torch.geometry.camera import Intrinsics


@dataclass
class Frame:
    index: int
    color: np.ndarray  # [H, W, 3] float32 0..255
    depth: np.ndarray  # [H, W] float32 meters
    mask: np.ndarray | None  # [H, W] bool


class ArraySequence:
    """In-memory sequence (tests / synthetic data)."""

    def __init__(self, colors, depths, intrinsics: Intrinsics, masks=None):
        self.colors = colors
        self.depths = depths
        self.masks = masks
        self.intrinsics = intrinsics

    def __len__(self):
        return len(self.depths)

    def load(self, index: int) -> Frame:
        return Frame(
            index=index,
            color=np.asarray(self.colors[index], np.float32),
            depth=np.asarray(self.depths[index], np.float32),
            mask=None if self.masks is None else self.masks[index],
        )
