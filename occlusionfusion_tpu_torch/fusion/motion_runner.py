"""Motion-completion step (port of ``occlusionfusion_tpu/fusion/motion_runner.py``).

Per frame: factor out the rigid motion of the visible nodes (Kabsch),
scale to centimetres and sigma-normalize, update the 16-frame history
ring buffer, run the net, and turn (mu, sigma) back into world motion
and a per-node confidence exp(-4 (sigma / (|mu| + 1))^2). Everything
stays on the device at static padded shapes; the JAX package's
``lax.cond`` branches become ``torch.where`` selections, so a frame
never waits on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from occlusionfusion_tpu_torch.geometry.kabsch import weighted_kabsch
from occlusionfusion_tpu_torch.models.motion_complete import (
    PyramidBatch,
    motion_complete_forward,
)

HISTORY_LEN = 16
LEVEL_SIZES = (512, 128, 32, 32)
LEVEL_KS = (8, 6, 4, 3)


def level_sizes_for(n0_cap: int) -> tuple:
    """Pyramid padding buckets for a node cap (512 -> LEVEL_SIZES)."""
    if n0_cap == LEVEL_SIZES[0]:
        return LEVEL_SIZES
    c = max(32, n0_cap // 16)
    return (n0_cap, max(32, n0_cap // 4), c, c)


class MotionRunnerState(NamedTuple):
    history: torch.Tensor  # [HISTORY_LEN, N0, 4], left-aligned
    history_len: torch.Tensor  # 0-d int32
    std_prev: torch.Tensor  # 0-d f32
    prev_pos: torch.Tensor  # [N0, 3]
    prev_visible: torch.Tensor  # [N0] bool
    prev_n: torch.Tensor  # 0-d int32
    frame_idx: torch.Tensor  # 0-d int32 (0 before the first frame)


def init_state(n0: int, device=None) -> MotionRunnerState:
    dev = torch.device(device) if device is not None else None
    return MotionRunnerState(
        history=torch.zeros((HISTORY_LEN, n0, 4), dtype=torch.float32, device=dev),
        history_len=torch.zeros((), dtype=torch.int32, device=dev),
        std_prev=torch.ones((), dtype=torch.float32, device=dev),
        prev_pos=torch.zeros((n0, 3), dtype=torch.float32, device=dev),
        prev_visible=torch.zeros((n0,), dtype=torch.bool, device=dev),
        prev_n=torch.zeros((), dtype=torch.int32, device=dev),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
    )


def pad_pyramid(nn_indexes, down_idxs, up_idxs, level_sizes=LEVEL_SIZES):
    """A frame's graph pyramid padded on the host to the static buckets,
    as the JAX ``pad_pyramid``: a ``PyramidBatch`` of numpy int32 / bool
    arrays (``pyramid_to_torch`` moves it to a device). ``nn_indexes[l]``
    is level l's [n_l, k_l] neighbour table (-1 for a missing
    neighbour); edges run node -> neighbour."""
    edge_src, edge_dst, edge_mask = [], [], []
    for l, nn in enumerate(nn_indexes):
        n_l, k_l = nn.shape
        cap = level_sizes[l]
        dst = np.zeros((cap, k_l), np.int32)
        dst[:n_l] = np.maximum(nn.astype(np.int32), 0)
        mask = np.zeros((cap, k_l), bool)
        mask[:n_l] = nn >= 0
        edge_src.append(np.repeat(np.arange(cap, dtype=np.int32), k_l))
        edge_dst.append(dst.reshape(-1))
        edge_mask.append(mask.reshape(-1))

    def padded(idxs, caps):
        out = []
        for d, cap in zip(idxs, caps):
            arr = np.zeros((cap,), np.int32)
            arr[: d.shape[0]] = d.astype(np.int32)
            out.append(arr)
        return tuple(out)

    node_mask = np.zeros((level_sizes[0],), bool)
    node_mask[: nn_indexes[0].shape[0]] = True
    return PyramidBatch(
        edge_src=tuple(edge_src), edge_dst=tuple(edge_dst),
        edge_mask=tuple(edge_mask),
        down_idx=padded(down_idxs, level_sizes[1:]),
        up_idx=padded(up_idxs, level_sizes[:3]), node_mask=node_mask,
    )


def pyramid_to_torch(pyramid: PyramidBatch, device=None) -> PyramidBatch:
    """A numpy ``PyramidBatch`` (``pad_pyramid``) as tensors on
    ``device``, index arrays as int64."""
    def t(a):
        a = torch.as_tensor(np.asarray(a), device=device)
        return a if a.dtype == torch.bool else a.long()

    return PyramidBatch(*(tuple(t(x) for x in f) if isinstance(f, tuple)
                          else t(f) for f in pyramid))


def _masked_std(x, mask):
    """Mean over columns of the population std over masked rows."""
    count = torch.clamp(torch.sum(mask), min=1).to(x.dtype)
    m = mask[:, None]
    zero = torch.zeros_like(x)
    mean = torch.sum(torch.where(m, x, zero), dim=0) / count
    var = torch.sum(torch.where(m, (x - mean) ** 2, zero), dim=0) / count
    return torch.mean(torch.sqrt(var))


def _rigid_factor(pos, motion, weights):
    """Per-node rigid motion R p + t - p of the weighted Kabsch fit."""
    R, t = weighted_kabsch(pos, pos + motion, weights)
    return torch.einsum("ij,nj->ni", R, pos) + t - pos


def motion_step(net, state: MotionRunnerState, node_pos, node_motion,
                visible, n_valid, pyramid: PyramidBatch,
                n0_cap: int = LEVEL_SIZES[0]):
    """One motion-completion frame -> (new_state, (motion [N0, 3],
    confidence [N0, 1]))."""
    dev = node_pos.device
    rows = torch.arange(n0_cap, device=dev)
    valid = rows < n_valid
    vis = visible & valid
    visf = vis.to(torch.float32)
    zero3 = torch.zeros_like(node_motion)

    rigid_curr = _rigid_factor(node_pos, node_motion, visf)
    nonrigid = node_motion - rigid_curr
    curr3 = torch.where(vis[:, None], nonrigid * 100.0, zero3)
    std_curr = _masked_std(curr3, vis) + 0.1
    curr3 = curr3 / std_curr
    curr_motion = torch.cat([curr3, visf[:, None]], dim=-1)

    prev_rows_valid = rows < state.prev_n
    motion_prev = node_pos - state.prev_pos
    prev_visf = (state.prev_visible & prev_rows_valid).to(torch.float32)
    rigid_prev = _rigid_factor(state.prev_pos, motion_prev, prev_visf)
    prev3 = torch.where(
        prev_rows_valid[:, None], (motion_prev - rigid_prev) * 100.0, zero3
    )
    prev_entry = torch.where(
        prev_rows_valid[:, None],
        torch.cat([prev3, torch.ones_like(prev3[:, :1])], dim=-1),
        torch.zeros((n0_cap, 4), dtype=torch.float32, device=dev),
    )

    # history update: frame 0 starts from one all-zero entry; later
    # frames rescale, roll when full and write the new entry
    scaled = state.history * (state.std_prev / std_curr)
    full = state.history_len >= HISTORY_LEN
    rolled = torch.where(full, torch.roll(scaled, -1, dims=0), scaled)
    slot = torch.clamp(state.history_len, max=HISTORY_LEN - 1)
    at_slot = (torch.arange(HISTORY_LEN, device=dev) == slot)[:, None, None]
    later_hist = torch.where(at_slot, (prev_entry / std_curr)[None], rolled)
    later_len = torch.clamp(state.history_len + 1, max=HISTORY_LEN)
    first = state.frame_idx == 0
    history = torch.where(first, torch.zeros_like(later_hist), later_hist)
    history_len = torch.where(
        first, torch.ones_like(later_len), later_len
    ).to(torch.int32)

    validf = valid[:, None]
    center = torch.sum(torch.where(validf, node_pos, zero3), dim=0) / torch.clamp(
        torch.sum(valid), min=1
    ).to(torch.float32)
    pos_centered = torch.where(validf, node_pos - center, zero3)

    pred = motion_complete_forward(
        net, pos_centered, curr_motion, history, history_len, pyramid
    )
    mu, sigma = pred[:, :3], pred[:, 3]
    motion_scale = torch.linalg.norm(mu, dim=-1)
    confidence = torch.exp(-4.0 * torch.square(sigma / (motion_scale + 1.0)))
    motion_out = torch.where(validf, mu * std_curr / 100.0 + rigid_curr, zero3)
    confidence = torch.where(valid, confidence, torch.zeros_like(confidence))

    new_state = MotionRunnerState(
        history=history,
        history_len=history_len,
        std_prev=std_curr,
        prev_pos=node_pos,
        prev_visible=visible,
        prev_n=torch.as_tensor(n_valid, dtype=torch.int32, device=dev),
        frame_idx=state.frame_idx + 1,
    )
    return new_state, (motion_out, confidence[:, None])


@functools.lru_cache(maxsize=None)
def _packed_layout(level_sizes=LEVEL_SIZES, ks=LEVEL_KS):
    """Static int-vector layout: [n_levels(4) | edge_dst per level |
    down(3) | up(3)], padding encoded as -1."""
    offsets = {}
    off = 4
    for l, (cap, k) in enumerate(zip(level_sizes, ks)):
        offsets[f"nn{l}"] = (off, cap * k)
        off += cap * k
    for i in (1, 2, 3):
        offsets[f"down{i}"] = (off, level_sizes[i])
        off += level_sizes[i]
    for i in (1, 2, 3):
        offsets[f"up{i}"] = (off, level_sizes[i - 1])
        off += level_sizes[i - 1]
    return offsets, off


def pack_frame(node_pos, node_motion, visible, nn_indexes, down_idxs,
               up_idxs, level_sizes=LEVEL_SIZES):
    """Host-side packing -> (ints [L] int32, floats [N0, 7] f32), numpy."""
    offsets, total = _packed_layout(tuple(level_sizes))
    ints = np.full((total,), -1, np.int32)
    ints[0:4] = [nn.shape[0] for nn in nn_indexes]
    for l, nn in enumerate(nn_indexes):
        if nn.shape[0] > level_sizes[l]:
            raise ValueError(
                f"pyramid level {l} has {nn.shape[0]} nodes, exceeds the "
                f"padding bucket {level_sizes[l]} (level_sizes={level_sizes})"
            )
        off, ln = offsets[f"nn{l}"]
        block = np.full((level_sizes[l], nn.shape[1]), -1, np.int32)
        block[: nn.shape[0]] = nn.astype(np.int32)
        ints[off : off + ln] = block.reshape(-1)
    for i, d in zip((1, 2, 3), down_idxs):
        off, _ = offsets[f"down{i}"]
        ints[off : off + d.shape[0]] = d.astype(np.int32)
    for i, u in zip((1, 2, 3), up_idxs):
        off, _ = offsets[f"up{i}"]
        ints[off : off + u.shape[0]] = u.astype(np.int32)
    n = node_pos.shape[0]
    floats = np.zeros((level_sizes[0], 7), np.float32)
    floats[:n, :3] = node_pos
    floats[:n, 3:6] = node_motion
    floats[:n, 6] = visible.astype(np.float32)
    return ints, floats


def _unpack_pyramid(ints: torch.Tensor, level_sizes=LEVEL_SIZES, ks=LEVEL_KS):
    """The PyramidBatch of a packed int vector; index tensors come out as
    int64, ready for indexing."""
    offsets, _ = _packed_layout(tuple(level_sizes), tuple(ks))
    dev = ints.device
    ints = ints.long()
    edge_src, edge_dst, edge_mask = [], [], []
    for l, (cap, k) in enumerate(zip(level_sizes, ks)):
        off, ln = offsets[f"nn{l}"]
        dst = ints[off : off + ln]
        edge_src.append(torch.repeat_interleave(
            torch.arange(cap, device=dev), k
        ))
        edge_dst.append(torch.clamp(dst, min=0))
        edge_mask.append(dst >= 0)
    down = [torch.clamp(ints[slice(o, o + n)], min=0)
            for o, n in (offsets[f"down{i}"] for i in (1, 2, 3))]
    up = [torch.clamp(ints[slice(o, o + n)], min=0)
          for o, n in (offsets[f"up{i}"] for i in (1, 2, 3))]
    node_mask = torch.arange(level_sizes[0], device=dev) < ints[0]
    return PyramidBatch(
        edge_src=tuple(edge_src), edge_dst=tuple(edge_dst),
        edge_mask=tuple(edge_mask), down_idx=tuple(down), up_idx=tuple(up),
        node_mask=node_mask,
    )


def motion_step_packed(net, state: MotionRunnerState, ints: torch.Tensor,
                       floats: torch.Tensor, level_sizes=LEVEL_SIZES):
    """motion_step on one packed frame (``pack_frame``'s ints [L] and
    floats [N0, 7]) -> (new_state, (motion [N0, 3], confidence [N0, 1]))."""
    pyramid = _unpack_pyramid(ints, level_sizes)
    return motion_step(net, state, floats[:, :3], floats[:, 3:6],
                       floats[:, 6] > 0.5, ints[0], pyramid,
                       n0_cap=level_sizes[0])


def motion_scan(net, state: MotionRunnerState, ints: torch.Tensor,
                floats: torch.Tensor, level_sizes=LEVEL_SIZES):
    """K packed frames in order (ints [K, L], floats [K, N0, 7]) ->
    (state, outputs [K, N0, 4]: motion, then confidence)."""
    outs = []
    for k in range(ints.shape[0]):
        state, (motion, conf) = motion_step_packed(net, state, ints[k],
                                                   floats[k], level_sizes)
        outs.append(torch.cat([motion, conf], dim=-1))
    return state, torch.stack(outs)


class MotionCompletionRunner:
    """Host-facing wrapper: packs each frame's numpy inputs, runs the
    step on the net's device and returns numpy outputs."""

    def __init__(self, net, n0_cap: int = LEVEL_SIZES[0]):
        self.net = net
        self.device = next(net.parameters()).device
        self.n0_cap = n0_cap
        # the packed layout, the net's shapes and the carried state must
        # all come from the same node cap
        self.level_sizes = level_sizes_for(n0_cap)
        self.state = init_state(n0_cap, self.device)

    def reset(self):
        self.state = init_state(self.n0_cap, self.device)

    def _packed(self, frames):
        packed = [pack_frame(f["node_pos"], f["node_motion"], f["visible"],
                             f["nn_indexes"], f["down_idxs"], f["up_idxs"],
                             level_sizes=self.level_sizes) for f in frames]
        ints = np.stack([p[0] for p in packed])
        floats = np.stack([p[1] for p in packed])
        return (torch.as_tensor(ints, device=self.device),
                torch.as_tensor(floats, device=self.device))

    @torch.no_grad()
    def run_frame(self, node_pos, node_motion, visible, nn_indexes,
                  down_idxs, up_idxs):
        """One frame -> (motion [n, 3], confidence [n]) numpy, n the
        frame's node count."""
        n = node_pos.shape[0]
        ints, floats = self._packed([dict(
            node_pos=node_pos, node_motion=node_motion, visible=visible,
            nn_indexes=nn_indexes, down_idxs=down_idxs, up_idxs=up_idxs)])
        self.state, (motion, conf) = motion_step_packed(
            self.net, self.state, ints[0], floats[0], self.level_sizes)
        return motion.cpu().numpy()[:n], conf.cpu().numpy()[:n, 0]

    @torch.no_grad()
    def run_chunk(self, frames: list[dict]):
        """A list of frames (each a dict of run_frame's arguments) in
        order, read back once -> a list of (motion [n, 3], confidence
        [n])."""
        ints, floats = self._packed(frames)
        self.state, outs = motion_scan(self.net, self.state, ints, floats,
                                       self.level_sizes)
        outs = outs.cpu().numpy()
        counts = [f["node_pos"].shape[0] for f in frames]
        return [(outs[i, :c, :3], outs[i, :c, 3])
                for i, c in enumerate(counts)]
