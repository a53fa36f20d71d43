"""Port of ops/knn.py: the K1 twin (knn_torch) against the JAX knn_lax,
and skinning_weights against its JAX counterpart, on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from occlusionfusion_tpu.geometry.skinning import (
    skinning_weights as skinning_weights_jax,
)
from occlusionfusion_tpu.ops.knn import knn_lax
from occlusionfusion_tpu_torch.geometry.skinning import skinning_weights
from occlusionfusion_tpu_torch.ops.knn import knn, knn_cuda, knn_torch
from torch_port_impl import assert_knn_equivalent, tt

# d2 of points within ~1 m: f32 rounding of |q|^2 - 2 q.r + |r|^2
ATOL = 1e-5


def _inputs(P, N, seed, invalid_frac):
    rng = np.random.RandomState(seed)
    q = (rng.rand(P, 3) - 0.5).astype(np.float32)
    r = (rng.rand(N, 3) - 0.5).astype(np.float32)
    valid = rng.rand(N) >= invalid_frac
    valid[:8] = True
    return q, r, valid


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("invalid_frac", [0.0, 0.3])
def test_twin_matches_knn_lax(k, invalid_frac):
    # more queries than one chunk of the twin
    q, r, valid = _inputs(17000, 97, seed=k, invalid_frac=invalid_frac)
    d2_j, idx_j = knn_lax(jnp.asarray(q), jnp.asarray(r), k,
                          valid=jnp.asarray(valid))
    d2_t, idx_t = knn_torch(tt(q), tt(r), k, valid=tt(valid))
    assert d2_t.dtype == torch.float32 and idx_t.dtype == torch.int32
    assert np.all(valid[idx_t.numpy()])
    assert_knn_equivalent(d2_t, idx_t, d2_j, idx_j, q, r, ATOL)


def test_front_door_uses_twin_on_cpu():
    q, r, valid = _inputs(50, 20, seed=3, invalid_frac=0.2)
    a = knn(tt(q), tt(r), 4, valid=tt(valid))
    b = knn_torch(tt(q), tt(r), 4, valid=tt(valid))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_k_capped_at_ref_count():
    q, r, _ = _inputs(10, 3, seed=5, invalid_frac=0.0)
    d2, idx = knn_torch(tt(q), tt(r), 4)
    assert d2.shape == (10, 3) and idx.shape == (10, 3)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, r, _ = _inputs(10, 8, seed=6, invalid_frac=0.0)
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda(tt(q), tt(r), 4)


# wide coverage: most points reachable; narrow: most points have an
# anchor beyond the 4-sigma cutoff and come out unreachable
@pytest.mark.parametrize("coverage", [0.1, 0.05])
def test_skinning_weights_match_jax(coverage):
    q, r, valid = _inputs(400, 60, seed=11, invalid_frac=0.1)
    # the settings fusion/warpfield.py skins with
    args = dict(k=4, require_all_anchors=True, norm_eps=1e-6)
    a_j, w_j, ok_j = skinning_weights_jax(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid), coverage, **args
    )
    a_t, w_t, ok_t = skinning_weights(tt(q), tt(r), tt(valid), coverage, k=4)
    assert 0 < int(ok_t.sum()) < q.shape[0]
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    # weights compared per anchor id (tie order among anchors is free)
    for row in range(q.shape[0]):
        wj = dict(zip(np.asarray(a_j)[row], np.asarray(w_j)[row]))
        for a, w in zip(a_t.numpy()[row], w_t.numpy()[row]):
            assert abs(wj.get(a, 0.0) - w) < 1e-5
