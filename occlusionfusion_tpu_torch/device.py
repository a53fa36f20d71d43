"""Device defaults, precision policy and the hand-written kernel library.

* ``DEFAULT_DEVICE`` is ``cuda``: every entry point of the port runs on
  the card unless the caller passes ``device="cpu"`` (the CPU tests do).
* TF32 is switched off for matmuls and cuDNN at import: the geometry and
  the solver stay in full f32, as in the JAX package (which pins
  ``precision="highest"`` on its einsums).
* ``kernel_lib()`` builds ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into
  one plain-C shared library (``_build/libof_kernels.so``) at first use
  and loads it with ``ctypes``. No source includes PyTorch's headers, so
  the build takes seconds, not minutes. One ``nvcc -c`` per source runs
  in parallel, then one link. It rebuilds when a source is newer than
  the library.
* ``launch(fn_name, dev, ...)`` runs a launcher on device ``dev`` and
  its current stream; each wrapper passes the device its tensors sit on
  (``tensors_device``, which refuses inputs on different devices).
* ``launch_counts`` holds one counter per kernel: the launches the card
  ran. A wrapper adds one where it launches its kernel
  (``count_launch``) and nowhere else. While a CUDA graph is captured
  (``capturing``) the wrapper's launch is recorded, not run: it counts
  into the graph's own counter instead, and every replay of the graph
  adds those counts to ``launch_counts`` (``count_replay``). The GN
  kernels keep the keys of the kernels they replaced
  (``point_term_blocks``, ``arap_term_blocks``).
* cuSOLVER is the linear-algebra library on the card: the Cholesky
  factorization and solve of the Gauss-Newton step take it (not MAGMA)
  inside captured graphs too.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time

import torch

DEFAULT_DEVICE = "cuda"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if torch.backends.cuda.is_built():
    torch.backends.cuda.preferred_linalg_library("cusolver")

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
KERNEL_LIB = os.path.join(BUILD_DIR, "libof_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

# the most shared memory one block may take on the H100 (227 KB); the
# wrappers refuse inputs whose tables would not fit before any launch, and
# the launchers check the device's own figure
SMEM_PER_BLOCK = 232448

launch_counts = {
    "knn": 0, "lbs_warp": 0, "point_term_blocks": 0, "arap_term_blocks": 0,
}

# what the last kernel_lib() call did: {"seconds": s, "cached": bool}
last_build: dict = {}

_lib = None
_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the exported launchers (csrc/*.cu); each returns the
# cudaError_t of its launch
_SIGNATURES = {
    # q, r, valid (or null), P, N, k, d2_out, idx_out, stream
    "of_knn": [_VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP],
    # pts, anchors, weights, valid, nodes, R, t, P, K, N, out, stream
    "of_lbs_warp": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP,
                    _VP],
    # pts, tgt, pv, anchors, weights, nodes, R, t, sw, two_d, fx, fy, sf,
    # sd, P, N, M, b, sq, stream
    "of_point_term_accumulate": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _F, _I, _F, _F, _F, _F, _I,
        _I, _VP, _VP, _VP, _VP,
    ],
    # nodes, R, t, edges, wa, wm, motion_targets, N, E, M, b, sq, stream
    "of_arap_term_accumulate": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP,
    ],
}


def resolve_device(device=None) -> torch.device:
    return torch.device(DEFAULT_DEVICE if device is None else device)


def require_device(device=None) -> torch.device:
    """``resolve_device`` for a command line: exits with an error where
    the card is asked for and there is none (no fallback to the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device (pass "
                         "--device cpu)")
    return dev


# the counter of the graph being captured, or None
_capture_counts = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` by its wrapper: into
    ``launch_counts``, or into the counter of the graph being captured."""
    counts = launch_counts if _capture_counts is None else _capture_counts
    counts[name] += 1


@contextlib.contextmanager
def capturing():
    """Within the block the wrappers' launches go into the dict it yields
    (the launches a CUDA graph captured), not into ``launch_counts``."""
    global _capture_counts
    prev = _capture_counts
    _capture_counts = dict.fromkeys(launch_counts, 0)
    try:
        yield _capture_counts
    finally:
        _capture_counts = prev


def count_replay(captured: dict) -> None:
    """One replay of a graph that captured ``captured`` launches."""
    for k, n in captured.items():
        launch_counts[k] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(KERNEL_LIB):
        return True
    built = os.path.getmtime(KERNEL_LIB)
    deps = _sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build_kernels(verbose: bool = False) -> float:
    """Compile every ``csrc/*.cu`` (one ``nvcc -c`` each, all started
    together) and link them into ``KERNEL_LIB``. Returns seconds."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR, prefix="obj_")
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    objs = []
    for src in _sources():
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(out, flush=True)
        if p.returncode != 0:
            failed.append(f"{src}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib_tmp = os.path.join(tmp, "libof_kernels.so")
    subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", lib_tmp], check=True,
    )
    os.replace(lib_tmp, KERNEL_LIB)
    shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0


def kernel_lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    cached = not _stale()
    if not cached:
        build_kernels()
    lib = ctypes.CDLL(KERNEL_LIB)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    last_build.update(seconds=time.perf_counter() - t0, cached=cached)
    _lib = lib
    return lib


def check_cuda_tensor(name: str, x: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of this dtype and
    shape (``None`` in ``shape`` matches any extent)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, x.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_aligned(name: str, x: torch.Tensor, n_bytes: int) -> None:
    """Raise unless ``x``'s first element sits on an ``n_bytes`` boundary
    (a kernel that reads it in vectors of that size needs it)."""
    if x.data_ptr() % n_bytes:
        raise ValueError(f"{name}: expected a {n_bytes}-byte-aligned tensor "
                         f"(the kernel reads it in {n_bytes}-byte vectors), "
                         f"got address {x.data_ptr():#x}")


def tensors_device(**tensors) -> torch.device:
    """The one device all ``tensors`` sit on; raise if they differ."""
    devs = {name: x.device for name, x in tensors.items()}
    first = next(iter(devs.values()))
    odd = [f"{n} on {d}" for n, d in devs.items() if d != first]
    if odd:
        raise ValueError(f"inputs on different devices: expected {first}, "
                         f"got {', '.join(odd)}")
    return first


def launch(fn_name: str, dev: torch.device, *args) -> None:
    """Call one exported launcher on device ``dev`` (the tensors' own)
    and its current stream; raise if the launch returned a CUDA error."""
    lib = kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
