"""4DMatch / 4DLoMatch pairs for training & evaluating the matcher (port
of ``occlusionfusion_tpu/data/fourdmatch.py``; numpy only).

Equivalent of ``lepard/datasets/_4dmatch.py:17`` — each sample is an npz
with source/target point clouds, ground-truth correspondences, the rigid
(rot, trans) component, and the per-source-point scene flow s2t_flow.
Samples are padded to static caps for batching; correspondences
become a dense [S_cap] match vector with a validity mask.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob

import numpy as np


@dataclass
class FourDMatchConfig:
    max_points: int = 8192
    max_correspondences: int = 4096


class FourDMatchDataset:
    def __init__(self, root: str, split: str = "", config: FourDMatchConfig | None = None):
        self.config = config or FourDMatchConfig()
        pattern = os.path.join(root, split, "**", "*.npz")
        self.files = sorted(glob(pattern, recursive=True))
        if not self.files:
            raise FileNotFoundError(f"no npz pairs under {pattern}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        cfg = self.config
        data = np.load(self.files[idx])
        s_pc = data["s_pc"].astype(np.float32)
        t_pc = data["t_pc"].astype(np.float32)
        corr = data["correspondences"].astype(np.int64)
        rot = data["rot"].astype(np.float32)
        trans = data["trans"].astype(np.float32).reshape(3)
        flow = data["s2t_flow"].astype(np.float32)

        def pad_pc(pc, cap):
            out = np.zeros((cap, 3), np.float32)
            n = min(pc.shape[0], cap)
            out[:n] = pc[:n]
            mask = np.zeros(cap, bool)
            mask[:n] = True
            return out, mask, n

        src, src_mask, ns = pad_pc(s_pc, cfg.max_points)
        tgt, tgt_mask, _ = pad_pc(t_pc, cfg.max_points)
        flow_p = np.zeros((cfg.max_points, 3), np.float32)
        flow_p[: min(ns, flow.shape[0])] = flow[: min(ns, flow.shape[0])]

        cc = cfg.max_correspondences
        corr_src = np.zeros(cc, np.int32)
        corr_tgt = np.zeros(cc, np.int32)
        corr_mask = np.zeros(cc, bool)
        n_c = min(corr.shape[0], cc)
        corr_src[:n_c] = corr[:n_c, 0]
        corr_tgt[:n_c] = corr[:n_c, 1]
        corr_mask[:n_c] = True
        return {
            "source": src,
            "source_mask": src_mask,
            "target": tgt,
            "target_mask": tgt_mask,
            "scene_flow": flow_p,
            "corr_src": corr_src,
            "corr_tgt": corr_tgt,
            "corr_mask": corr_mask,
            "rot": rot,
            "trans": trans,
        }
