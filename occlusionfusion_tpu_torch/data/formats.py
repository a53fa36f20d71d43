"""DeepDeform / NeuralTracking binary data formats (port of
``occlusionfusion_tpu/data/formats.py``; numpy only, byte for byte the same
files).

Byte-compatible readers/writers for the reference's custom binary formats
(``utils/utils.py:126-383``): .oflow/.sflow flow tensors, graph node /
edge / weight / cluster blobs, and float/int image blobs. These make our
framework interoperable with DeepDeform-style preprocessed datasets.

Layout (little-endian):
  flow:        uint32 width, height, channels; f32[C, H, W] row-major
  graph nodes: uint32 n; f32[n, 3]
  graph edges: uint32 n, k; int32[n, k]
  edge weights:uint32 n, k; f32[n, k]
  clusters:    uint32 n, 1; int32[n, 1]
  float image: uint32 c, h, w; f32[c, h, w]
  int image:   uint32 c, h, w; int32[c, h, w]
"""

from __future__ import annotations

import struct

import numpy as np


def _read_header(fh, n: int):
    return struct.unpack("I" * n, fh.read(4 * n))


def load_flow(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        w, h, c = _read_header(fh, 3)
        data = np.frombuffer(fh.read(4 * c * h * w), np.float32)
    return data.reshape(c, h, w).copy()


def save_flow(path: str, flow: np.ndarray):
    assert flow.ndim == 3  # [C, H, W]
    with open(path, "wb") as fh:
        fh.write(struct.pack("III", flow.shape[2], flow.shape[1], flow.shape[0]))
        fh.write(np.ascontiguousarray(flow, np.float32).tobytes())


def load_graph_nodes(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        (n,) = _read_header(fh, 1)
        data = np.frombuffer(fh.read(4 * n * 3), np.float32)
    return data.reshape(n, 3).copy()


def save_graph_nodes(path: str, nodes: np.ndarray):
    with open(path, "wb") as fh:
        fh.write(struct.pack("I", nodes.shape[0]))
        fh.write(np.ascontiguousarray(nodes, np.float32).tobytes())


def load_graph_edges(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        n, k = _read_header(fh, 2)
        data = np.frombuffer(fh.read(4 * n * k), np.int32)
    return data.reshape(n, k).copy()


def save_graph_edges(path: str, edges: np.ndarray):
    with open(path, "wb") as fh:
        fh.write(struct.pack("II", edges.shape[0], edges.shape[1]))
        fh.write(np.ascontiguousarray(edges, np.int32).tobytes())


def load_graph_edges_weights(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        n, k = _read_header(fh, 2)
        data = np.frombuffer(fh.read(4 * n * k), np.float32)
    return data.reshape(n, k).copy()


def save_graph_edges_weights(path: str, weights: np.ndarray):
    with open(path, "wb") as fh:
        fh.write(struct.pack("II", weights.shape[0], weights.shape[1]))
        fh.write(np.ascontiguousarray(weights, np.float32).tobytes())


def load_graph_clusters(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        n, k = _read_header(fh, 2)
        data = np.frombuffer(fh.read(4 * n * k), np.int32)
    return data.reshape(n, k).copy()


def save_graph_clusters(path: str, clusters: np.ndarray):
    c = np.ascontiguousarray(clusters.reshape(-1, 1), np.int32)
    with open(path, "wb") as fh:
        fh.write(struct.pack("II", c.shape[0], c.shape[1]))
        fh.write(c.tobytes())


def load_float_image(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        c, h, w = _read_header(fh, 3)
        data = np.frombuffer(fh.read(4 * c * h * w), np.float32)
    return data.reshape(c, h, w).copy()


def save_float_image(path: str, image: np.ndarray):
    assert image.ndim == 3
    with open(path, "wb") as fh:
        fh.write(struct.pack("III", *image.shape))
        fh.write(np.ascontiguousarray(image, np.float32).tobytes())


def load_int_image(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        c, h, w = _read_header(fh, 3)
        data = np.frombuffer(fh.read(4 * c * h * w), np.int32)
    return data.reshape(c, h, w).copy()


def save_int_image(path: str, image: np.ndarray):
    assert image.ndim == 3
    with open(path, "wb") as fh:
        fh.write(struct.pack("III", *image.shape))
        fh.write(np.ascontiguousarray(image, np.int32).tobytes())
