"""DeformingThings4D clips -> motion-completion training samples (port of
``occlusionfusion_tpu/data/motion_clips.py``).

Animate a clip, build the deformation graph and its 4-level pyramid over
the rest-pose mesh (``graph/edgraph.py``, the mesh route), derive each
frame's ground-truth non-rigid node motion from the vertex trajectories,
and assemble padded ``MotionBatch`` samples whose history chains and
sigma normalisation follow the runner (``fusion/motion_runner.py``).
Host-side numpy with the JAX module's draw order: the same seed gives
the same draws. The rigid factor is the port's Kabsch (Horn's quaternion
form, ``geometry/kabsch.py``) where the JAX module takes a 3x3 SVD, so
the motion fields agree with JAX's to f32 rounding, not bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from occlusionfusion_tpu_torch.data.deformingthings4d import (
    frame_vertices,
    load_anime,
)
from occlusionfusion_tpu_torch.graph.edgraph import (
    GraphConfig,
    build_graph_from_mesh,
)


@dataclass
class MotionClipConfig:
    node_coverage: float = 0.05
    caps: tuple = (256, 64, 32, 16)
    history_len: int = 16
    visibility_dropout: float = 0.3  # extra random occlusion augmentation
    noise_sigma_cm: float = 0.5  # input-motion noise (model_noise_all regime)
    camera_offset: tuple = (0.0, 0.0, 1.5)
    scale: float = 1.0


def _rigid(prev_nodes: np.ndarray, cur_nodes: np.ndarray):
    """(R, t) of the unweighted Kabsch fit prev -> cur, numpy f32."""
    from occlusionfusion_tpu_torch.geometry.kabsch import weighted_kabsch

    src = torch.from_numpy(np.ascontiguousarray(prev_nodes, np.float32))
    dst = torch.from_numpy(np.ascontiguousarray(cur_nodes, np.float32))
    R, t = weighted_kabsch(src, dst, torch.ones(src.shape[0]))
    return R.numpy(), t.numpy()


def clip_to_training_samples(
    anime_path: str,
    config: MotionClipConfig = MotionClipConfig(),
    seed: int = 0,
    max_frames: int | None = None,
):
    """Returns (a list of MotionBatch of numpy arrays, one per frame from
    frame 1 on; the graph)."""
    from occlusionfusion_tpu_torch.fusion.motion_runner import pad_pyramid
    from occlusionfusion_tpu_torch.models.motion_train import MotionBatch

    rng = np.random.RandomState(seed)
    verts, faces, offsets = load_anime(anime_path)
    center = verts.mean(0)
    offset = np.asarray(config.camera_offset, np.float32)

    def frame_pts(f):
        return (frame_vertices(verts, offsets, f) - center) * config.scale + offset

    graph = build_graph_from_mesh(
        frame_pts(0).astype(np.float32),
        faces,
        GraphConfig(node_coverage=config.node_coverage),
    )
    node_vids = graph.node_indices
    n = len(node_vids)
    cap = config.caps[0]
    if n > cap:
        raise ValueError(f"{n} graph nodes exceed the cap {cap}")
    pyd = graph.pyramid
    pyramid = pad_pyramid(
        [pyd[f"nn_index_l{l}"] for l in range(4)],
        [pyd[f"down_sample_idx{i}"] for i in (1, 2, 3)],
        [pyd[f"up_sample_idx{i}"] for i in (1, 2, 3)],
        level_sizes=config.caps,
    )

    n_frames = offsets.shape[0] + 1
    if max_frames:
        n_frames = min(n_frames, max_frames)

    samples = []
    hist = np.zeros((config.history_len, cap, 4), np.float32)
    hist_len = 1
    std_prev = 1.0
    prev_nodes = frame_pts(0)[node_vids]
    for f in range(1, n_frames):
        cur_nodes = frame_pts(f)[node_vids]
        motion = cur_nodes - prev_nodes

        # rigid factor-out (the demo preprocessing, demo.py:49-51)
        R, t = _rigid(prev_nodes, cur_nodes)
        rigid = (prev_nodes @ R.T + t) - prev_nodes
        nonrigid_cm = (motion - rigid) * 100.0

        visible = rng.rand(n) > config.visibility_dropout
        noisy = nonrigid_cm + rng.randn(n, 3) * config.noise_sigma_cm

        curr = np.zeros((cap, 4), np.float32)
        curr[:n, :3] = np.where(visible[:, None], noisy, 0.0)
        std = np.mean(np.std(curr[:n][visible, :3], axis=0)) + 0.1
        curr[:n, :3] = np.where(
            visible[:, None], curr[:n, :3] / std, 0.0
        )
        curr[:n, 3] = visible

        gt = np.zeros((cap, 3), np.float32)
        gt[:n] = nonrigid_cm / std

        mask = np.zeros(cap, np.float32)
        mask[:n] = 1.0

        samples.append(
            MotionBatch(
                pos=np.pad(
                    (cur_nodes - cur_nodes.mean(0)).astype(np.float32),
                    ((0, cap - n), (0, 0)),
                ),
                curr_motion=curr,
                history=hist.copy(),
                history_len=np.int32(hist_len),
                gt_motion=gt,
                node_mask=mask,
                pyramid=pyramid,
            )
        )

        # history chain exactly like the runner (motion_runner.py)
        entry = np.zeros((cap, 4), np.float32)
        entry[:n, :3] = nonrigid_cm
        entry[:n, 3] = 1.0
        scaled = hist * (std_prev / std)
        if hist_len >= config.history_len:
            scaled = np.roll(scaled, -1, axis=0)
            slot = config.history_len - 1
        else:
            slot = hist_len
        scaled[slot] = entry / std
        hist = scaled
        hist_len = min(hist_len + 1, config.history_len)
        std_prev = std
        prev_nodes = cur_nodes
    return samples, graph
