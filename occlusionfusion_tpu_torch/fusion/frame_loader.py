"""RGB-D sequences (port's own copy of
``occlusionfusion_tpu/fusion/frame_loader.py``).

``RGBDSequence`` reads a directory with ``color/``, ``depth/`` (16-bit
PNG in millimetres), an optional ``mask/`` and an ``intrinsics.txt`` 3x3
(or 4x4) matrix, with the optional preprocessing of the JAX loader
(depth cut-off, median depth filter, depth-discontinuity mask). PNGs are
decoded here with ``zlib`` and numpy (``read_png``: non-interlaced grey,
grey + alpha, RGB, RGBA and palette images at every bit depth); another
colour format (JPEG) needs Pillow. ``ArraySequence`` holds frames in
memory.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from occlusionfusion_tpu_torch.geometry.camera import Intrinsics


@dataclass
class Frame:
    index: int
    color: np.ndarray  # [H, W, 3] float32 0..255
    depth: np.ndarray  # [H, W] float32 meters
    mask: np.ndarray | None  # [H, W] bool
    # depth-discontinuity pixels left out of the correspondence search;
    # None = none
    boundary: np.ndarray | None = None


# channels per PNG colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters -> [height, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum over each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: byte by byte
            a = bytearray(stride)
            src, up = line.tolist(), prior.tolist()
            for x in range(stride):
                left = a[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    ul = up[x - bpp] if x >= bpp else 0
                    p = left + up[x] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[x]), abs(p - ul)
                    pred = (left if pa <= pb and pa <= pc
                            else up[x] if pb <= pc else ul)
                a[x] = (src[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(a), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} is not valid")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str, expand_palette: bool = True) -> np.ndarray:
    """A non-interlaced PNG -> [H, W] (one channel) or [H, W, C] array,
    uint8 at bit depths up to 8, uint16 at 16. A palette image comes
    back as RGB, or as its [H, W] indices without ``expand_palette``
    (what Pillow's ``np.asarray`` gives)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG is not supported")
    channels = _PNG_CHANNELS[ctype]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    img = _unfilter(zlib.decompress(b"".join(idat)), height, stride,
                    max(1, bits // 8))
    if depth == 16:
        img = img.view(">u2").astype(np.uint16).reshape(height, width,
                                                        channels)
    elif depth == 8:
        img = img.reshape(height, width, channels)
    else:  # 1, 2 or 4 bits per sample, one channel
        bitplane = np.unpackbits(img, axis=1)[:, : width * depth]
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint8)
        img = (bitplane.reshape(height, width, depth) * weights).sum(
            -1, dtype=np.uint8)[..., None]
    if ctype == 3 and expand_palette:
        return palette[img[..., 0]]
    return img[..., 0] if channels == 1 else img


def _read_image(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - depends on the machine
        raise ImportError(
            f"{path}: only PNG is decoded without Pillow") from e
    return np.asarray(Image.open(path))


def _as_rgb(img: np.ndarray) -> np.ndarray:
    """Grey, grey + alpha, RGB or RGBA -> [H, W, 3] float32 0..255."""
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[-1] == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.asarray(img[..., :3], np.float32)


def median_filter_depth_np(depth: np.ndarray, size: int = 5,
                           max_deviation: float = 0.1) -> np.ndarray:
    """Replace pixels deviating from the median of the valid depths in
    their ``size`` x ``size`` window by more than ``max_deviation`` with
    that median; zero (invalid) depths stay zero."""
    H, W = depth.shape
    r = size // 2
    pad = np.pad(depth, r, constant_values=0.0)
    stack = np.stack([pad[dy:dy + H, dx:dx + W] for dy in range(size)
                      for dx in range(size)], axis=-1)
    valid = stack > 0
    srt = np.sort(np.where(valid, stack, np.inf), axis=-1)
    count = valid.sum(axis=-1)
    med = np.take_along_axis(srt, np.maximum(count // 2, 0)[..., None],
                             axis=-1)[..., 0]
    med = np.where(count > 0, med, 0.0)
    return np.where((depth > 0) & (np.abs(depth - med) > max_deviation),
                    med, depth).astype(np.float32)


def boundary_mask_np(depth: np.ndarray, intrinsics: Intrinsics,
                     max_distance: float) -> np.ndarray:
    """Depth-discontinuity mask: pixels whose central-difference 3-D
    point distance, horizontal or vertical, exceeds ``max_distance``."""
    H, W = depth.shape
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    x = (u - float(intrinsics.cx)) / float(intrinsics.fx) * depth
    y = (v - float(intrinsics.cy)) / float(intrinsics.fy) * depth
    pts = np.stack([x, y, depth], axis=-1)
    sr = np.zeros_like(pts)
    sr[:, 1:] = pts[:, :-1]
    sl = np.zeros_like(pts)
    sl[:, :-1] = pts[:, 1:]
    sd = np.zeros_like(pts)
    sd[1:] = pts[:-1]
    su = np.zeros_like(pts)
    su[:-1] = pts[1:]
    horiz = np.linalg.norm(sl - sr, axis=-1)
    vert = np.linalg.norm(su - sd, axis=-1)
    return (horiz > max_distance) | (vert > max_distance)


class RGBDSequence:
    def __init__(self, seq_dir: str, depth_scale: float = 1.0 / 1000.0,
                 max_depth: float = 0.0, depth_filter_size: int = 0,
                 depth_filter_max_deviation: float = 0.1,
                 boundary_dist: float = 0.0):
        """Optional preprocessing, all off by default: ``max_depth`` > 0
        zeroes depth beyond it, ``depth_filter_size`` > 0 runs the median
        depth filter, ``boundary_dist`` > 0 computes the
        depth-discontinuity mask (``Frame.boundary``)."""
        self.seq_dir = seq_dir
        self.depth_scale = depth_scale
        self.max_depth = max_depth
        self.depth_filter_size = depth_filter_size
        self.depth_filter_max_deviation = depth_filter_max_deviation
        self.boundary_dist = boundary_dist
        K = np.loadtxt(os.path.join(seq_dir, "intrinsics.txt"))
        self.intrinsics = Intrinsics(
            *(float(np.float32(K[i, j]))
              for i, j in ((0, 0), (1, 1), (0, 2), (1, 2))))
        self.names = sorted(os.listdir(os.path.join(seq_dir, "color")),
                            key=lambda x: int(x.split(".")[0]))

    def __len__(self):
        return len(self.names)

    def _path(self, sub: str, name: str, ext_png: bool):
        if ext_png:
            name = name.replace("jpg", "png").replace("jpeg", "png")
        return os.path.join(self.seq_dir, sub, name)

    def load(self, index: int) -> Frame:
        name = self.names[index]
        color = _as_rgb(_read_image(self._path("color", name, False)))
        depth = read_png(self._path("depth", name, True)).astype(
            np.float32) * self.depth_scale
        mask = None
        mask_path = self._path("mask", name, True)
        if os.path.exists(mask_path):
            mask = read_png(mask_path, expand_palette=False) > 0
            if mask.ndim == 3:
                mask = mask.any(-1)
            depth = np.where(mask, depth, 0.0)
        if self.max_depth > 0:
            depth = np.where(depth > self.max_depth, 0.0, depth)
        if self.depth_filter_size > 0:
            depth = median_filter_depth_np(depth, self.depth_filter_size,
                                           self.depth_filter_max_deviation)
        boundary = None
        if self.boundary_dist > 0:
            boundary = boundary_mask_np(depth, self.intrinsics,
                                        self.boundary_dist)
        return Frame(index=index, color=color,
                     depth=depth.astype(np.float32), mask=mask,
                     boundary=boundary)


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
