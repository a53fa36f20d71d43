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
from occlusionfusion_tpu_torch.ops.knn import (
    MAX_REFS,
    _fma,
    knn,
    knn_cuda,
    knn_torch,
)
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    assert_knn_equivalent,
    one_torch_thread,
    tt,
)

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


def _geometry(P, threads):
    """(threads, queries per thread, blocks) of a K1 launch: the launcher
    takes 2 queries per thread in blocks of 128, 64 or 32 threads."""
    return threads, 2, -(-P // (threads * 2))


def _k1_emulate(q, r, valid, geometry):
    """csrc/knn.cu step by step in f32: the launch's split of the queries
    over (block, query slot, thread), the valid refs compacted in
    ascending order and prescaled by -2, |r|^2 formed from them, the
    branchless sorted update with strict <, and the fill of the last
    slots with the lowest-index invalid refs at 1e30 where fewer than 4
    refs are valid. Fused multiply-adds as the twin forms them."""
    threads, qpt, blocks = geometry
    P = q.shape[0]
    b, j, t = np.meshgrid(np.arange(blocks), np.arange(qpt),
                          np.arange(threads), indexing="ij")
    order = (b * threads * qpt + j * threads + t).ravel()
    order = order[order < P]
    # every query is one thread's, once
    np.testing.assert_array_equal(np.sort(order), np.arange(P))
    qs = tt(q)[torch.from_numpy(order)]
    qx, qy, qz = qs[:, 0], qs[:, 1], qs[:, 2]
    qsq = _fma(qz, qz, _fma(qy, qy, qx * qx))
    ok = np.ones(r.shape[0], bool) if valid is None else valid
    kept = np.flatnonzero(ok)
    rs = tt(r)[torch.from_numpy(kept)]
    m2r = -2.0 * rs
    rsq = rs[:, 0] * rs[:, 0] + rs[:, 1] * rs[:, 1] + rs[:, 2] * rs[:, 2]
    bd = torch.full((P, 4), float("inf"))
    bi = torch.zeros((P, 4), dtype=torch.int32)
    for i, n in enumerate(kept):
        d = (qsq + _fma(qz, m2r[i, 2], _fma(qy, m2r[i, 1], qx * m2r[i, 0]))
             ) + rsq[i]
        c = [d < bd[:, s] for s in range(4)]
        nid = torch.full_like(bi[:, 0], int(n))
        for s in (3, 2, 1):
            bd[:, s] = torch.where(c[s - 1], bd[:, s - 1],
                                   torch.where(c[s], d, bd[:, s]))
            bi[:, s] = torch.where(c[s - 1], bi[:, s - 1],
                                   torch.where(c[s], nid, bi[:, s]))
        bd[:, 0] = torch.where(c[0], d, bd[:, 0])
        bi[:, 0] = torch.where(c[0], nid, bi[:, 0])
    nv = len(kept)
    if nv < 4:
        bd[:, nv:] = torch.tensor(1e30, dtype=torch.float32)
        bi[:, nv:] = torch.from_numpy(
            np.flatnonzero(~ok)[: 4 - nv].astype(np.int32))
    d2 = torch.empty_like(bd)
    idx = torch.empty_like(bi)
    d2[torch.from_numpy(order)] = torch.clamp(bd, min=0.0)
    idx[torch.from_numpy(order)] = bi
    return d2, idx


def _lattice_inputs(P, n_valid, seed):
    """Voxel centres near 1 m and 512 refs on the same 5 mm lattice, so
    that many queries have refs at exactly equal distances; the first
    ``n_valid`` of a random order of the refs are valid."""
    rng = np.random.RandomState(seed)
    v = 0.005
    q = ((rng.randint(0, 24, (P, 3)) + 0.5) * v).astype(np.float32)
    r = (rng.randint(0, 24, (512, 3)) * v).astype(np.float32)
    q[:, 2] += 1.0
    r[:, 2] += 1.0
    valid = np.zeros(512, bool)
    valid[rng.permutation(512)[:n_valid]] = True
    return q, r, valid


# P = 1003 is a multiple of no split; each block size the launcher picks
@pytest.mark.parametrize("threads", [32, 64, 128])
@pytest.mark.parametrize("n_valid", [0, 2, 300])
def test_kernel_order_matches_twin_bit_for_bit(n_valid, threads):
    P = 1003
    q, r, valid = _lattice_inputs(P, n_valid, seed=n_valid)
    d2_e, idx_e = _k1_emulate(q, r, valid, _geometry(P, threads))
    d2_t, idx_t = knn_torch(tt(q), tt(r), 4, valid=tt(valid))
    assert torch.equal(d2_e, d2_t) and torch.equal(idx_e, idx_t)
    if n_valid == 2:
        kept = np.flatnonzero(valid)
        np.testing.assert_array_equal(np.sort(idx_e[:, :2].numpy(), 1),
                                      np.broadcast_to(kept, (P, 2)))
        np.testing.assert_array_equal(
            idx_e[:, 2:].numpy(), np.broadcast_to(np.flatnonzero(~valid)[:2],
                                                  (P, 2)))
        assert bool((d2_e[:, 2:] == torch.tensor(1e30)).all())
    d2_j, idx_j = knn_lax(jnp.asarray(q), jnp.asarray(r), 4,
                          valid=jnp.asarray(valid))
    assert_knn_equivalent(d2_e, idx_e, d2_j, idx_j, q, r, ATOL)


def test_kernel_order_matches_twin_without_valid():
    q, r, _ = _lattice_inputs(300, 0, seed=9)
    d2_e, idx_e = _k1_emulate(q, r[:40], None, _geometry(300, 32))
    d2_t, idx_t = knn_torch(tt(q), tt(r[:40]), 4)
    assert torch.equal(d2_e, d2_t) and torch.equal(idx_e, idx_t)


# the refs must fit in shared memory beside the kernel's static 128
# bytes: one ref more than fits is refused before any launch; at the
# limit the wrapper goes on to its tensor checks
@pytest.mark.parametrize("extra, match", [(0, "CUDA tensor"), (1, "at most")])
def test_kernel_wrapper_refuses_too_many_refs(extra, match):
    assert MAX_REFS * 20 + 128 <= 232448 < (MAX_REFS + 1) * 20 + 128
    with pytest.raises(ValueError, match=match):
        knn_cuda(torch.zeros((4, 3)), torch.zeros((MAX_REFS + extra, 3)), 4)


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
    a_t, w_t, ok_t = skinning_weights(tt(q), tt(r), tt(valid), coverage,
                                      **args)
    assert 0 < int(ok_t.sum()) < q.shape[0]
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    # weights compared per anchor id (tie order among anchors is free)
    for row in range(q.shape[0]):
        wj = dict(zip(np.asarray(a_j)[row], np.asarray(w_j)[row]))
        for a, w in zip(a_t.numpy()[row], w_t.numpy()[row]):
            assert abs(wj.get(a, 0.0) - w) < 1e-5
