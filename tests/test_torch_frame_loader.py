"""The port's frame loader (occlusionfusion_tpu_torch/fusion/
frame_loader.py) against the JAX package's on the CPU: its own PNG
decoder against Pillow and against rows written with each PNG filter
type, the depth filter and the boundary mask, and whole RGBDSequence
frames read from files written here by Pillow (as scripts/
convert_dt4d.py writes them). Everything must be bit-identical: the
decoder returns the stored integers and the float steps are the same
numpy expressions."""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from occlusionfusion_tpu.fusion import frame_loader as FJ
from occlusionfusion_tpu.geometry.camera import Intrinsics as IntrJ
from occlusionfusion_tpu_torch.fusion import frame_loader as FT
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics


def _filter_row(ftype, line, prior, bpp):
    """Encode one row with PNG filter ``ftype`` (the reference algorithm
    of the PNG specification, byte by byte)."""
    out = bytearray(len(line))
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        out[x] = (line[x] - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


def write_png_filters(path, img, bit_depth, color_type):
    """A PNG whose rows cycle through filter types 0-4."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if bit_depth == 16:
        raw = img.astype(">u2").tobytes()
    else:
        raw = img.astype(np.uint8).tobytes()
    stride = w * ch * bit_depth // 8
    bpp = max(1, ch * bit_depth // 8)
    rows, prior = [], bytes(stride)
    for y in range(h):
        line = raw[y * stride:(y + 1) * stride]
        rows.append(_filter_row(y % 5, line, prior, bpp))
        prior = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth,
                                           color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "grey16", "grey8", "rgba8"])
def test_read_png_every_filter_type(tmp_path, kind):
    rng = np.random.RandomState(0)
    shape, depth, ctype = {
        "rgb8": ((23, 17, 3), 8, 2), "grey16": ((19, 21), 16, 0),
        "grey8": ((10, 13), 8, 0), "rgba8": ((11, 9, 4), 8, 6)}[kind]
    hi = 65535 if depth == 16 else 255
    img = rng.randint(0, hi + 1, size=shape)
    path = str(tmp_path / "x.png")
    write_png_filters(path, img, depth, ctype)
    got = FT.read_png(path)
    assert got.dtype == (np.uint16 if depth == 16 else np.uint8)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["RGB", "I;16", "L", "1", "P", "RGBA"])
def test_read_png_matches_pillow(tmp_path, mode):
    """Files Pillow writes (its encoder picks a filter per row)."""
    rng = np.random.RandomState(1)
    h, w = 37, 45
    smooth = np.add.outer(np.arange(h), np.arange(w))
    if mode == "RGB":
        img = Image.fromarray(((smooth[..., None] * [3, 5, 7]
                                + rng.randint(0, 9, (h, w, 3))) % 256
                               ).astype(np.uint8))
    elif mode == "RGBA":
        img = Image.fromarray(rng.randint(0, 256, (h, w, 4)).astype(np.uint8))
    elif mode == "I;16":
        img = Image.fromarray((smooth * 601 + rng.randint(0, 50, (h, w))
                               ).astype(np.uint16))
    elif mode == "L":
        img = Image.fromarray((smooth * 2 % 256).astype(np.uint8))
    elif mode == "1":
        img = Image.fromarray(rng.rand(h, w) > 0.5)
    else:
        img = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
            np.uint8)).quantize(7)
    path = str(tmp_path / "x.png")
    img.save(path)
    ref = np.asarray(Image.open(path))
    if mode == "P":
        np.testing.assert_array_equal(
            FT.read_png(path), np.asarray(Image.open(path).convert("RGB")))
        np.testing.assert_array_equal(FT.read_png(path, expand_palette=False),
                                      ref)
    else:
        np.testing.assert_array_equal(FT.read_png(path), ref)


def _depth_with_steps(h=40, w=50, seed=2):
    rng = np.random.RandomState(seed)
    depth = np.full((h, w), 1.2, np.float32)
    depth[10:30, 15:35] = 0.8  # a box in front: depth discontinuities
    depth += rng.rand(h, w).astype(np.float32) * 0.01
    depth[rng.rand(h, w) < 0.05] = 0.0  # holes
    depth[5, 5] = 2.5  # an outlier for the median filter
    return depth


def test_median_filter_and_boundary_mask_match_jax():
    depth = _depth_with_steps()
    np.testing.assert_array_equal(FT.median_filter_depth_np(depth, 5, 0.1),
                                  FJ.median_filter_depth_np(depth, 5, 0.1))
    intr = Intrinsics(60.0, 60.0, 25.0, 20.0)
    intr_j = IntrJ(np.float32(60), np.float32(60), np.float32(25),
                   np.float32(20))
    got = FT.boundary_mask_np(depth, intr, 0.05)
    assert got.any()
    np.testing.assert_array_equal(got, FJ.boundary_mask_np(depth, intr_j,
                                                           0.05))


def write_sequence(root, n=3, h=40, w=50, mask_mode=None):
    """color/ (8-bit RGB PNG), depth/ (16-bit PNG, mm), optional mask/,
    intrinsics.txt (3x3)."""
    rng = np.random.RandomState(3)
    for sub in ("color", "depth") + (("mask",) if mask_mode else ()):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        depth = _depth_with_steps(h, w, seed=10 + i)
        Image.fromarray(np.clip(depth * 1000, 0, 65535).astype(np.uint16)
                        ).save(os.path.join(root, "depth", f"{i:06d}.png"))
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(os.path.join(root, "color", f"{i:06d}.png"))
        if mask_mode:
            m = np.zeros((h, w), bool)
            m[3:35, 4:46] = True
            img = Image.fromarray(m if mask_mode == "1"
                                  else m.astype(np.uint8) * 255)
            img.save(os.path.join(root, "mask", f"{i:06d}.png"))
    K = np.array([[61.5, 0, 24.5], [0, 62.25, 19.75], [0, 0, 1.0]])
    np.savetxt(os.path.join(root, "intrinsics.txt"), K)


@pytest.mark.parametrize("mask_mode", [None, "1", "L"])
def test_rgbd_sequence_matches_jax(tmp_path, mask_mode):
    root = str(tmp_path / "seq")
    write_sequence(root, mask_mode=mask_mode)
    kw = dict(max_depth=1.1, depth_filter_size=3, boundary_dist=0.05)
    sj, st = FJ.RGBDSequence(root, **kw), FT.RGBDSequence(root, **kw)
    assert len(st) == len(sj) == 3
    assert tuple(st.intrinsics) == tuple(float(x) for x in sj.intrinsics)
    for i in range(len(st)):
        fj, ft = sj.load(i), st.load(i)
        assert ft.index == fj.index == i
        for name in ("color", "depth", "mask", "boundary"):
            a, b = getattr(ft, name), getattr(fj, name)
            if b is None:
                assert a is None, name
                continue
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert ft.boundary.any()


def test_rgbd_sequence_defaults_leave_depth_alone(tmp_path):
    root = str(tmp_path / "seq")
    write_sequence(root, n=1)
    f = FT.RGBDSequence(root).load(0)
    assert f.boundary is None and f.mask is None
    raw = np.asarray(Image.open(os.path.join(root, "depth", "000000.png")))
    np.testing.assert_array_equal(f.depth,
                                  raw.astype(np.float32) * (1.0 / 1000.0))
