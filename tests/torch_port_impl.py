"""Shared helpers of the tests/test_torch_*.py port tests: the same numpy
inputs go to a JAX function and to its PyTorch port on the CPU."""

import contextlib
import fcntl
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp


def _build_jax_graph_builder():
    """Build the JAX package's native graph builder once, under a file lock.

    Its loader (``occlusionfusion_tpu/graph/native.py::_load``) compiles the
    library in place at first use. Under ``pytest -n 6`` a second worker
    can find the half-written file and fail with "file too short". Every
    worker imports this module while it collects, and xdist hands out no
    test before every worker has collected, so building here under a lock
    leaves a whole library for every test, the JAX package's included."""
    from occlusionfusion_tpu.graph import native as native_j
    from occlusionfusion_tpu_torch.device import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "graph_builder_jax.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            native_j._load()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_build_jax_graph_builder()


def tt(x, dtype=None):
    """numpy / jax array -> CPU torch tensor (same dtype unless given)."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def gn_problem_to_torch(problem):
    """A JAX GNProblem -> the port's GNProblem (CPU tensors)."""
    from occlusionfusion_tpu_torch.solvers.gauss_newton import GNProblem

    f = {}
    for name in GNProblem._fields:
        if getattr(problem, name) is None:
            f[name] = None
            continue
        a = np.array(getattr(problem, name))
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        f[name] = torch.from_numpy(a)
    return GNProblem(**f)


def jax_chamfer_table(iters, samples, n_source, n_target):
    """The chamfer subsamples the JAX N-ICP draws from PRNGKey(0) in every
    solve (one pair a step from ``split(key, iters)``, the final loss's
    from the key itself), as the port's table [iters + 1, 2, max(S, T)]
    (numpy int64)."""
    import jax

    key = jax.random.PRNGKey(0)
    S, T = min(samples, n_source), min(samples, n_target)
    keys = list(jax.random.split(key, iters)) + [key]
    table = np.zeros((iters + 1, 2, max(S, T)), np.int64)
    for i, k in enumerate(keys):
        k1, k2 = jax.random.split(k)
        table[i, 0, :S] = np.asarray(jax.random.randint(k1, (S,), 0,
                                                        n_source))
        table[i, 1, :T] = np.asarray(jax.random.randint(k2, (T,), 0,
                                                        n_target))
    return table


def random_pose_field(n, seed, rot=0.3, trans=0.04):
    """Random (R [n, 3, 3], t [n, 3]) as numpy f32, via the JAX so3_exp."""
    from occlusionfusion_tpu.geometry.so3 import so3_exp

    rng = np.random.RandomState(seed)
    R = np.asarray(so3_exp(jnp.asarray(rng.randn(n, 3).astype(np.float32) * rot)))
    t = (rng.randn(n, 3) * trans).astype(np.float32)
    return R, t


def hat_entry(v, i, j):
    """hat(v)[i][j] by the index rule of the CUDA kernels' hat_entry
    (occlusionfusion_tpu_torch/csrc/accumulate.cuh), over v's last axis."""
    if j == i:
        return np.zeros_like(v[..., 0])
    return -v[..., (i + 2) % 3] if j == (i + 1) % 3 else v[..., (i + 1) % 3]


def assert_knn_equivalent(d2_a, idx_a, d2_b, idx_b, queries, refs, atol):
    """Two k-NN results agree: sorted distances within ``atol``, and every
    row's anchor set equal except where the two differ only among refs at
    (near-)equal distance — the order among ties is free."""
    d2_a, d2_b = np.asarray(d2_a), np.asarray(d2_b)
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    np.testing.assert_allclose(d2_a, d2_b, atol=atol, rtol=0)
    sa = np.sort(idx_a, axis=1)
    sb = np.sort(idx_b, axis=1)
    for row in np.flatnonzero(np.any(sa != sb, axis=1)):
        q = np.asarray(queries)[row]
        for idx, d2 in ((idx_a[row], d2_b[row]), (idx_b[row], d2_a[row])):
            true = np.sum((np.asarray(refs)[idx] - q) ** 2, axis=1)
            np.testing.assert_allclose(np.sort(true), d2, atol=10 * atol)


def textured_sphere_frames(centers, h, w, intr, r):
    """(depths, colors) of a sphere at each centre, ray-cast in closed form
    as in test_fusion_e2e.sphere_depth, with a smooth procedural RGB
    texture fixed to its surface (a function of the surface normal), so
    that optical flow has something to follow. Background depth 0, grey."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([(u - float(intr.cx)) / float(intr.fx),
                  (v - float(intr.cy)) / float(intr.fy), np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depths, colors = [], []
    for c in centers:
        c = np.asarray(c, np.float32)
        b = d @ c
        disc = b * b - (c @ c - r * r)
        t = b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (t > 0)
        depths.append(np.where(hit, t * d[..., 2], 0.0).astype(np.float32))
        n = (t[..., None] * d - c) / r
        tex = np.stack([np.sin(12 * n[..., 0] + 3 * n[..., 1]),
                        np.sin(10 * n[..., 1] - 5 * n[..., 2]),
                        np.sin(9 * n[..., 2] + 7 * n[..., 0])], -1)
        colors.append(np.where(hit[..., None], 128 + 100 * tex, 128.0)
                      .astype(np.float32))
    return depths, colors


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread (imported by the modules that
    want it). Their tensors are small, and the tier-1 run has several
    test workers on the machine's cores: torch's per-process pool of one
    thread per core then only makes the workers wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_lepard_match_counts():
    """Within the block, each call of the JAX Lepard matcher that the JAX
    fused step traces (``models.lepard.scene_flow``, imported when the
    step is traced) reports its match count, the sum of its blend mask,
    through an ordered host callback into the list this yields, in call
    order. JAX's caches are cleared on entry, so that a step traced
    before is traced again with the callback."""
    import jax

    from occlusionfusion_tpu.models import lepard

    orig, counts = lepard.scene_flow, []

    def tapped(*args, **kwargs):
        flow, mask, extra = orig(*args, **kwargs)
        jax.debug.callback(lambda n: counts.append(int(n)), jnp.sum(mask),
                           ordered=True)
        return flow, mask, extra

    jax.clear_caches()
    lepard.scene_flow = tapped
    try:
        yield counts
    finally:
        lepard.scene_flow = orig


# the fields a port FusionConfig copies from a JAX one (the solver
# configs aside)
SHARED_FUSION_FIELDS = (
    "vol_dim", "voxel_size", "trunc_margin_vox", "node_coverage",
    "max_nodes", "max_points", "max_depth_diff", "use_motion_model",
    "solver", "brick_size", "max_bricks", "brick_dilate", "use_flow",
    "flow_mask_threshold", "flow_mode", "flow_advect_min_px",
    "flow_advect_weight", "flow_advect_mask_threshold", "flow_advect_alpha",
    "flow_downscale", "flow_mask_patch", "flow_lift", "flow_bf16",
    "mask_downscale", "use_lepard", "lepard_max_target_points",
    "lepard_every", "lepard_subsample", "growth_interval",
    "keyframe_interval", "max_keyframes", "loop_radius", "loop_align_iters",
    "loop_min_inliers", "loop_min_separation", "loop_max_residual",
    "min_cluster_matches", "relocalize_threshold", "relocalize_min_obs_px",
    "relocalize_recover_inliers", "relocalize_recovery",
    "relocalize_feat_min_points", "min_correction", "lbs_impl",
    "dense_skin_max_bytes",
)


def port_fusion_config(cfg_j, **kw):
    """The port's FusionConfig with every shared field of the JAX one
    ``cfg_j`` (its graph config too), and ``kw`` (nicp, gn) on top."""
    from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig
    from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig

    g = cfg_j.graph
    return FusionConfig(
        **{n: getattr(cfg_j, n) for n in SHARED_FUSION_FIELDS},
        graph=GraphConfig(node_coverage=g.node_coverage,
                          min_neighbors=g.min_neighbors), **kw)


def port_sequence(seq_j):
    """The port's ArraySequence of a JAX ArraySequence's frames."""
    from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
    from occlusionfusion_tpu_torch.geometry.camera import Intrinsics

    return ArraySequence(seq_j.colors, seq_j.depths,
                         Intrinsics(*(float(x) for x in seq_j.intrinsics)))


# XLA's CPU backend at LLVM optimization level 0: a JAX reference that
# runs once compiles in about half the time (the same HLO, so the same
# results on these inputs)
QUICK_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def jax_run_once(fn, *args):
    """``fn(*args)`` compiled whole by ``jax.jit`` with QUICK_COMPILE."""
    import jax

    return jax.jit(fn).lower(*args).compile(QUICK_COMPILE)(*args)


def run_jax_script(name, argv, frames=("main",), returns=()):
    """Run the JAX package's ``scripts/<name>.py`` in this process with
    ``argv`` and return ({function: its locals when it returned},
    {function: [its return values]}) for the functions named in
    ``frames`` and ``returns`` (defined anywhere), read by a profile hook:
    the script's per-sample values before its JSON rounds them."""
    import os
    import runpy
    import sys

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", f"{name}.py")
    local, rets = {}, {f: [] for f in returns}

    def hook(frame, event, arg):
        if event != "return":
            return
        code = frame.f_code
        if code.co_name in frames and code.co_filename == path:
            local[code.co_name] = dict(frame.f_locals)
        if code.co_name in rets:
            rets[code.co_name].append(arg)

    old_argv = sys.argv
    sys.argv = [path] + list(argv)
    sys.setprofile(hook)
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.setprofile(None)
        sys.argv = old_argv
    return local, rets
