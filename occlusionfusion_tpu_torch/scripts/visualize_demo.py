"""Draw the motion-completion demo's input and output per frame: the port
of ``scripts/visualize_demo.py``, with its flags and defaults but
``--input``, which defaults to ``run_demo``'s (``data/input``).

  python -m occlusionfusion_tpu_torch.scripts.visualize_demo \
      --input data/input --output data/output --frames 1 50 100 \
      --out_dir viz

Each frame becomes one PNG of two panels, as the JAX script draws them:
the input's node motion on the visible nodes (nodes coloured 0.8 where
visible and 0.1 where not), and the completed motion on every node with
the nodes coloured by the net's confidence. The nodes are plotted at
(x, z, -y) with motion arrows 12 times their length, seen as
matplotlib's default 3-D view sees them (elevation 30, azimuth -60
degrees, each axis scaled to the panel). The JAX script draws with
matplotlib; this one draws in numpy (viridis colours, red arrows, no
axes or titles) and writes with ``fusion.frame_loader.write_png``, so it
runs where neither matplotlib nor Pillow is installed. It runs on the
host only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

ARROW_SCALE = 12.0
PANEL_HW = (440, 480)
ELEV, AZIM = 30.0, -60.0
# viridis at nine evenly spaced values
_VIRIDIS = np.asarray([
    [68, 1, 84], [71, 44, 122], [59, 81, 139], [44, 113, 142],
    [33, 144, 141], [39, 173, 129], [92, 200, 99], [170, 220, 50],
    [253, 231, 37]], np.float32)
_ARROW = np.asarray([214, 39, 40], np.uint8)  # matplotlib's tab:red


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", default=os.path.join("data", "input"))
    ap.add_argument("--output", default=os.path.join("data", "output"))
    ap.add_argument("--frames", type=int, nargs="+", default=[1, 200, 500])
    ap.add_argument("--out_dir", default="viz")
    return ap


def panels(node_path: str, out_path: str, frame_id: int):
    """The two panels' data, as the JAX script hands them to matplotlib:
    each a dict of ``points`` [N, 3] (x, z, -y), ``values`` [N] (colour in
    0..1), ``starts`` [M, 3] and ``vectors`` [M, 3] (the arrows, scaled)."""
    nf = np.load(os.path.join(node_path, f"{frame_id:04d}.npy"))
    pos, motion_in, visible = nf[:, :3], nf[:, 3:6], nf[:, -1] > 0.5
    pred = np.load(os.path.join(out_path, f"{frame_id:04d}.npy"))
    motion_out, conf = pred[:, :3], pred[:, 3]
    plot = np.stack([pos[:, 0], pos[:, 2], -pos[:, 1]], -1)
    out = []
    for motion, mask, values in (
            (motion_in, visible, np.where(visible, 0.8, 0.1)),
            (motion_out, np.ones_like(visible), conf)):
        m = mask.astype(bool)
        vec = np.stack([motion[m, 0], motion[m, 2], -motion[m, 1]], -1)
        out.append(dict(points=plot, values=np.asarray(values, np.float32),
                        starts=plot[m], vectors=vec * ARROW_SCALE))
    return out


def viridis(values: np.ndarray) -> np.ndarray:
    """[N] values in 0..1 -> [N, 3] uint8."""
    x = np.clip(np.asarray(values, np.float32), 0.0, 1.0) * 8.0
    i = np.minimum(x.astype(int), 7)
    f = (x - i)[:, None]
    return np.round(_VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f).astype(
        np.uint8)


def _view(points: np.ndarray, lo: np.ndarray, span: np.ndarray):
    """Plot coordinates -> panel pixels (column, row): each axis scaled to
    the unit cube, then matplotlib's default orthographic view."""
    p = (points - lo) / span - 0.5
    az, el = np.deg2rad(AZIM), np.deg2rad(ELEV)
    right = np.asarray([-np.sin(az), np.cos(az), 0.0])
    up = np.asarray([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az),
                     np.cos(el)])
    H, W = PANEL_HW
    s = 0.55 * min(H, W)
    return (W / 2 + s * (p @ right)), (H / 2 - s * (p @ up))


def _plot(img, cols, rows, colors, r: int):
    H, W = img.shape[:2]
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            y = np.round(rows).astype(int) + dy
            x = np.round(cols).astype(int) + dx
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            img[y[ok], x[ok]] = colors[ok]


def draw_panel(panel) -> np.ndarray:
    """One panel as a uint8 [H, W, 3] image on white: nodes as viridis
    squares, then the arrows as red lines over them."""
    pts = panel["points"]
    ends = panel["starts"] + panel["vectors"]
    lo = pts.min(0)
    span = np.maximum(pts.max(0) - lo, 1e-9)
    img = np.full(PANEL_HW + (3,), 255, np.uint8)
    cols, rows = _view(pts, lo, span)
    _plot(img, cols, rows, viridis(panel["values"]), 2)
    if len(ends):
        c0, r0 = _view(panel["starts"], lo, span)
        c1, r1 = _view(ends, lo, span)
        n = int(np.ceil(max(np.abs(c1 - c0).max(), np.abs(r1 - r0).max(),
                            1.0))) + 1
        f = np.linspace(0.0, 1.0, n)[None, :]
        cs = (c0[:, None] + (c1 - c0)[:, None] * f).reshape(-1)
        rs = (r0[:, None] + (r1 - r0)[:, None] * f).reshape(-1)
        _plot(img, cs, rs, np.broadcast_to(_ARROW, (len(cs), 3)), 0)
    return img


def render_frame(node_path, out_path, frame_id, save_to):
    """Write ``<save_to>/NNNN.png`` (the two panels side by side); returns
    its path."""
    from occlusionfusion_tpu_torch.fusion.frame_loader import write_png

    img = np.concatenate([draw_panel(p) for p in panels(node_path, out_path,
                                                        frame_id)], axis=1)
    os.makedirs(save_to, exist_ok=True)
    out_png = os.path.join(save_to, f"{frame_id:04d}.png")
    write_png(out_png, img)
    return out_png


def main(argv=None):
    args = build_parser().parse_args(argv)
    written = []
    for f in args.frames:
        png = render_frame(os.path.join(args.input, "node"),
                           os.path.join(args.output, "node"), f,
                           args.out_dir)
        print(f"wrote {png}")
        written.append(png)
    return written


if __name__ == "__main__":
    main()
