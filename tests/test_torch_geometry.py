"""Port of geometry/ (so3, camera projection, edwarp, kabsch) and the
segment softmax against the JAX package, on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp

from occlusionfusion_tpu.geometry import camera as CJ
from occlusionfusion_tpu.geometry import edwarp as EJ
from occlusionfusion_tpu.geometry.kabsch import weighted_kabsch as wk_jax
from occlusionfusion_tpu.geometry import so3 as SJ
from occlusionfusion_tpu.ops import segment_ops as GJ
from occlusionfusion_tpu_torch.geometry import camera as C
from occlusionfusion_tpu_torch.geometry import edwarp as E
from occlusionfusion_tpu_torch.geometry import kabsch as K
from occlusionfusion_tpu_torch.geometry import so3 as S
from occlusionfusion_tpu_torch.ops import segment_ops as G
from torch_port_impl import one_torch_thread, tt  # noqa: F401


@pytest.mark.parametrize("scale", [1e-6, 0.3, 2.0])
def test_so3_exp_log_match_jax(scale):
    w = (np.random.RandomState(0).randn(200, 3) * scale).astype(np.float32)
    R_j = np.asarray(SJ.so3_exp(jnp.asarray(w)))
    R_t = S.so3_exp(tt(w)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)
    np.testing.assert_allclose(S.so3_log(tt(R_j)).numpy(),
                               np.asarray(SJ.so3_log(jnp.asarray(R_j))),
                               atol=2e-5)
    np.testing.assert_array_equal(S.vee(S.hat(tt(w))).numpy(), w)


def test_project_points_matches_jax():
    p = np.random.RandomState(1).randn(300, 3).astype(np.float32)
    uv_j, ok_j = CJ.project_points(
        jnp.asarray(p), CJ.Intrinsics(*(np.float32(x) for x in (500, 510, 320, 240)))
    )
    uv_t, ok_t = C.project_points(tt(p), C.Intrinsics(500.0, 510.0, 320.0, 240.0))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    ok = np.asarray(ok_j)
    np.testing.assert_allclose(uv_t.numpy()[ok], np.asarray(uv_j)[ok],
                               rtol=1e-6, atol=1e-3)


def test_ed_warp_matches_jax():
    rng = np.random.RandomState(2)
    P, N = 400, 30
    pts = rng.rand(P, 3).astype(np.float32)
    nodes = rng.rand(N, 3).astype(np.float32)
    R = np.asarray(SJ.so3_exp(jnp.asarray(rng.randn(N, 3).astype(np.float32) * 0.3)))
    t = (rng.randn(N, 3) * 0.05).astype(np.float32)
    a = rng.randint(0, N, (P, 4)).astype(np.int32)
    w = rng.rand(P, 4).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    ref = EJ.ed_warp(*(jnp.asarray(x) for x in (pts, nodes, R, t, a, w)))
    got = E.ed_warp(*(tt(x) for x in (pts, nodes, R, t, a, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_kabsch_matches_jax(weighted):
    rng = np.random.RandomState(3)
    src = rng.randn(50, 3).astype(np.float32)
    R0 = np.asarray(SJ.so3_exp(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    dst = (src @ R0.T + [0.1, 0.0, -0.2] + rng.randn(50, 3) * 0.01).astype(np.float32)
    w = (rng.rand(50) if weighted else np.ones(50)).astype(np.float32)
    R_j, t_j = wk_jax(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    R_t, t_t = K.weighted_kabsch(tt(src), tt(dst), tt(w))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)


def test_segment_softmax_matches_jax():
    rng = np.random.RandomState(4)
    E_, n = 300, 40
    logits = (rng.randn(E_) * 3).astype(np.float32)
    seg = rng.randint(0, n - 3, E_).astype(np.int32)  # 3 empty segments
    mask = rng.rand(E_) > 0.2
    ref = GJ.segment_softmax(jnp.asarray(logits), jnp.asarray(seg), n,
                             jnp.asarray(mask))
    got = G.segment_softmax(tt(logits), tt(seg), n, tt(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
