"""Port of the GN ARAP edge term (kernel K4, ops/gn_assembly.py) and the
block assembly that runs it against the JAX package.

* The K4 twin against the XLA ARAP branch of the JAX ``_assemble_blocks``
  (5e-5 relative, the JAX suite's tolerance between its twins) and
  against the TPU kernel ``arap_term_blocks_pallas`` itself, run in
  interpret mode as tests/test_gn_assembly.py runs it, at a tolerance
  derived from the kernel's bf16 hi/lo gather (below).
* The port's ``_assemble_blocks`` (the JAX ``blocks_pallas_full``: K3'
  and K4', here their twins) against the JAX
  ``_assemble_blocks(assembly="blocks")`` with fractional point
  weights and invalid edges, 5e-5 relative (the JAX side runs "blocks",
  not the TPU point-term kernel, because of ROADMAP fault F1).
* The accumulating twin of K4' against the per-edge blocks and the
  scatter the caller did before K4', and K4''s own arithmetic
  (csrc/arap_term.cu), emulated in numpy, against the twin."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from occlusionfusion_tpu.ops import gn_assembly as GAJ
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.gauss_newton_dense import (
    _assemble_blocks as assemble_blocks_jax,
)
from occlusionfusion_tpu_torch.ops.gn_assembly import (
    arap_term_accumulate,
    arap_term_accumulate_cuda,
    arap_term_accumulate_torch,
    arap_term_blocks_torch,
)
from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
    _assemble_blocks,
)
from test_gauss_newton import build_problem
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    gn_problem_to_torch,
    hat_entry,
    one_torch_thread,
    random_pose_field,
    tt,
)

REL = 5e-5
NAMES = ("ii", "ij", "ji", "jj", "b_i", "b_j", "rsq")


@pytest.fixture()
def interp(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def wrapped(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(GAJ.pl, "pallas_call", wrapped)


def _arap_inputs(seed, n=200, e_k=8):
    """Nodes in a 0.3 m cube at 1 m, random rotations and translations,
    about a fifth of the edge slots invalid (-1, weight 0), random edge
    weights; returns numpy (nodes, R, t, edges clamped >= 0, wa)."""
    rng = np.random.RandomState(seed)
    nodes = (rng.rand(n, 3) * 0.3 + [0.0, 0.0, 1.0]).astype(np.float32)
    R, t = random_pose_field(n, seed)
    edges = rng.randint(-1, n, (n, e_k)).astype(np.int32)
    edges[rng.rand(n, e_k) < 0.2] = -1
    ew = rng.rand(n, e_k).astype(np.float32)
    wa = np.sqrt(2.0 * np.where(edges >= 0, ew, 0.0)).astype(np.float32)
    return nodes, R, t, np.maximum(edges, 0), wa


def _xla_arap(nodes, R, t, e, wa):
    """The XLA ARAP branch of the JAX _assemble_blocks, in K4's layout."""
    from occlusionfusion_tpu.geometry.so3 import hat

    n, e_k = e.shape
    nodes, R, t, wa = (jnp.asarray(x) for x in (nodes, R, t, wa))
    g_i = nodes[:, None]
    g_j = nodes[e]
    rot = jnp.einsum("nij,nkj->nki", R, g_j - g_i, precision="highest")
    r = wa[..., None] * (rot + g_i + t[:, None] - g_j - t[e])
    eye = jnp.broadcast_to(jnp.eye(3), (n, e_k, 3, 3))
    Ji = jnp.concatenate([-hat(rot), eye], -1) * wa[..., None, None]
    Jj = jnp.concatenate([jnp.zeros_like(eye), -eye], -1) * wa[..., None, None]
    hp = "highest"
    ij = jnp.einsum("neai,neaj->neij", Ji, Jj, precision=hp)
    return (
        jnp.sum(jnp.einsum("neai,neaj->neij", Ji, Ji, precision=hp), 1),
        ij, ij.transpose(0, 1, 3, 2),
        jnp.einsum("neai,neaj->neij", Jj, Jj, precision=hp),
        jnp.sum(jnp.einsum("neai,nea->nei", Ji, r, precision=hp), 1),
        jnp.einsum("neai,nea->nei", Jj, r, precision=hp),
        jnp.sum(r * r, axis=(1, 2)),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_matches_xla_branch(seed):
    inputs = _arap_inputs(seed)
    ref = _xla_arap(*inputs)
    got = arap_term_blocks_torch(*(tt(x) for x in inputs))
    for name, a, b in zip(NAMES, got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=REL * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_interpreted_tpu_kernel(interp, seed):
    """The TPU kernel gathers the neighbour rows (g_j, t_j) through a
    one-hot matmul over a bf16 hi/lo split of the node table: each
    gathered value carries an error of at most 2^-18 of the table's
    largest entry; delta = 2^-17 of it keeps a factor 2 in hand. To first
    order, with w = max wa, m = w * max(1, |rot|) the largest jacobian
    entry and rmax the largest residual component:
      rot error <= sqrt(3) delta, r error e_r <= w (sqrt(3) + 2) delta,
      J_i error e_J <= w sqrt(3) delta, J_j and jj exact;
      ij, ji <= w e_J; b_j <= w e_r; ii <= E 3 2 m e_J;
      b_i <= E 3 (m e_r + rmax e_J); rsq <= E 3 2 rmax e_r.
    Those are the per-output tolerances."""
    nodes, R, t, e, wa = _arap_inputs(seed, n=120)
    ref = GAJ.arap_term_blocks_pallas(*(jnp.asarray(x) for x in
                                        (nodes, R, t, e, wa)))
    got = arap_term_blocks_torch(*(tt(x) for x in (nodes, R, t, e, wa)))
    table = np.concatenate([R.reshape(-1, 9), nodes, t], axis=1)
    delta = 2.0**-17 * np.abs(table).max()
    E = e.shape[1]
    w = float(wa.max())
    rot = np.einsum("nij,nkj->nki", R, nodes[e] - nodes[:, None])
    m = w * max(1.0, np.abs(rot).max())
    rmax = float(np.sqrt(np.asarray(ref[6]).max()))
    e_r = w * (np.sqrt(3) + 2) * delta
    e_J = w * np.sqrt(3) * delta
    tol = {"ii": E * 6 * m * e_J, "ij": w * e_J, "ji": w * e_J, "jj": 0.0,
           "b_i": E * 3 * (m * e_r + rmax * e_J), "b_j": w * e_r,
           "rsq": E * 6 * rmax * e_r}
    for name, a, b in zip(NAMES, got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        # the kernel's own f32 arithmetic adds a few ulps of the output
        atol = tol[name] + 4e-7 * np.abs(b).max()
        np.testing.assert_allclose(a.numpy(), b, atol=atol, rtol=0,
                                   err_msg=name)


def _problem_with_invalid_edges(seed):
    """tests/test_gauss_newton.build_problem with fractional point
    weights (the case that separates the K3 semantics) and a quarter of
    the edge slots invalid (-1)."""
    problem, _, _ = build_problem(n_pts=300, n_nodes=30)
    rng = np.random.RandomState(seed)
    pv = np.asarray(problem.point_valid) * rng.uniform(0.3, 1.0, 300)
    edges = np.array(problem.edges)
    edges[rng.rand(*edges.shape) < 0.25] = -1
    n = problem.nodes.shape[0]
    return problem._replace(
        point_valid=jnp.asarray(pv.astype(np.float32)),
        edges=jnp.asarray(edges),
        motion_targets=problem.nodes + 0.01,
        motion_confidence=jnp.asarray(rng.rand(n).astype(np.float32)),
    )


@pytest.mark.parametrize("w_motion", [0.0, 1.5])
@pytest.mark.parametrize("seed", [4, 9])
def test_assembly_matches_jax_blocks(w_motion, seed):
    problem = _problem_with_invalid_edges(seed)
    R, t = random_pose_field(problem.nodes.shape[0], seed)
    kw = dict(iters=1, w_point=1.7, w_arap=2.1, w_motion=w_motion)
    M1, b1, sq1 = assemble_blocks_jax(
        problem, GNConfigJ(assembly="blocks", **kw), jnp.asarray(R),
        jnp.asarray(t),
    )
    M2, b2, sq2 = _assemble_blocks(
        gn_problem_to_torch(problem),
        GNConfig(**kw), tt(R), tt(t),
    )
    M1, b1 = np.asarray(M1), np.asarray(b1)
    np.testing.assert_allclose(M2.numpy(), M1, atol=REL * np.abs(M1).max())
    np.testing.assert_allclose(b2.numpy(), b1, atol=REL * np.abs(b1).max())
    np.testing.assert_allclose(float(sq2), float(sq1), rtol=REL)


def _motion_inputs(seed, n):
    """Motion-prior weight wm [n] (a third of the nodes without a prior)
    and targets [n, 3]."""
    rng = np.random.RandomState(seed + 100)
    wm = (rng.rand(n) * (rng.rand(n) > 0.33)).astype(np.float32)
    mt = (rng.rand(n, 3) * 0.3 + [0.0, 0.0, 1.0]).astype(np.float32)
    return wm, mt


def _accumulate_inputs(seed, n=40, e_k=8):
    return [tt(x) for x in _arap_inputs(seed, n, e_k)
            + _motion_inputs(seed, n)]


def _system(n):
    return (torch.zeros((6 * n, 6 * n)), torch.zeros(6 * n),
            torch.zeros(()))


def emulate_arap_kernel(nodes, R, t, e, wa, wm, mt):
    """K4' in numpy, step by step as csrc/arap_term.cu adds: each node's
    lane sums expanded into M[i, i] by its group's first lane with the
    kernel's 8-byte adds, b_i and the motion prior; each valid edge's
    lane adds the non-zero entries of M[i, j], M[j, i], M[j, j] and b[j]."""
    n, E = e.shape
    M = np.zeros((6 * n, 6 * n), np.float64)
    b = np.zeros(6 * n, np.float64)
    sq = 0.0
    for i in range(n):
        acc = np.zeros(16)
        for k in range(E):
            j, w = e[i, k], wa[i, k]
            rho = R[i] @ (nodes[j] - nodes[i])
            r = w * (rho + nodes[i] + t[i] - nodes[j] - t[j])
            w2 = w * w
            acc += [w2 * (rho[1] ** 2 + rho[2] ** 2),
                    w2 * (rho[0] ** 2 + rho[2] ** 2),
                    w2 * (rho[0] ** 2 + rho[1] ** 2),
                    -w2 * rho[0] * rho[1], -w2 * rho[0] * rho[2],
                    -w2 * rho[1] * rho[2], *(w2 * rho), w2,
                    *(w * np.cross(rho, r)), *(w * r)]
            sq += r @ r
            if w == 0:
                continue
            for a in range(3):
                for c in range(3):
                    if c == a:
                        continue
                    v = -w2 * hat_entry(rho, a, c)
                    M[6 * i + a, 6 * j + 3 + c] += v
                    M[6 * j + 3 + c, 6 * i + a] += v
            for c in range(3):
                M[6 * i + 3 + c, 6 * j + 3 + c] -= w2
                M[6 * j + 3 + c, 6 * i + 3 + c] -= w2
                M[6 * j + 3 + c, 6 * j + 3 + c] += w2
                b[6 * j + 3 + c] -= w * r[c]
        bt = acc[13:16].copy()
        if wm[i] != 0:
            rm = wm[i] * (nodes[i] + t[i] - mt[i])
            sq += rm @ rm
            bt += wm[i] * rm
        if acc[9] == 0 and wm[i] == 0:
            continue
        S = np.array([[acc[0], acc[3], acc[4]], [acc[3], acc[1], acc[5]],
                      [acc[4], acc[5], acc[2]]])
        P, W = acc[6:9], acc[9] + wm[i] ** 2

        def h(a, c):
            return hat_entry(P, a, c)

        rows = [[*S[row], h(row, 0), h(row, 1), h(row, 2)] for row in range(3)]
        rows += [[0.0, -h(0, 1), -h(0, 2), W, None, None],
                 [-h(1, 0), 0.0, -h(1, 2), 0.0, W, 0.0],
                 [-h(2, 0), -h(2, 1), None, None, 0.0, W]]
        for row, vals in enumerate(rows):
            for c, v in enumerate(vals):
                if v is not None:  # a pair the kernel does not add
                    M[6 * i + row, 6 * i + c] += v
        b[6 * i: 6 * i + 6] += [*acc[10:13], *bt]
    return M, b, sq


@pytest.mark.parametrize("e_k", [8, 6])
def test_kernel_arithmetic_matches_twin(e_k):
    """csrc/arap_term.cu: the lane sums of M[i, i]'s edge part
    (|rho|^2 I - rho rho^T, hat(rho), I, each times wa^2), b_i =
    wa [rho x r; r], the non-zero entries of M[i, j], M[j, i], M[j, j]
    and b[j], and the motion prior, emulated in numpy, against the
    accumulating twin; invalid edges and nodes without a prior included,
    at E = 8 and at E = 6 (where the kernel's groups of 8 lanes hold
    spare lanes)."""
    inputs = _accumulate_inputs(3, n=30, e_k=e_k)
    M1, b1, sq1 = emulate_arap_kernel(
        *(x.numpy().astype(np.float64) if x.is_floating_point() else
          x.numpy() for x in inputs))
    M2, b2, sq2 = _system(30)
    arap_term_accumulate_torch(*inputs, M2, b2, sq2)
    np.testing.assert_allclose(M2.numpy(), M1, atol=1e-6 * np.abs(M1).max())
    np.testing.assert_allclose(b2.numpy(), b1, atol=1e-6 * np.abs(b1).max())
    np.testing.assert_allclose(float(sq2), sq1, rtol=1e-5)


def test_accumulate_twin_matches_blocks_and_old_scatter():
    """arap_term_accumulate_torch equals arap_term_blocks_torch followed
    by the scatter _assemble_blocks did before K4' (segment ids of ij,
    ji, jj, one index_add_ into [N*N, 36], ii and the motion prior on
    the diagonal, the permute to [6N, 6N]), within 1e-6 of scale, adding
    onto a system that already holds values."""
    nodes, R, t, e, wa, wm, mt = _accumulate_inputs(7)
    n, E = e.shape
    ii, ij, ji, jj, b_i, b_j, rsq = arap_term_blocks_torch(nodes, R, t, e, wa)
    el = e.long()
    idx_i = torch.arange(n)[:, None].expand(n, E)
    segs = torch.cat([(idx_i * n + el).reshape(-1),
                      (el * n + idx_i).reshape(-1), (el * n + el).reshape(-1)])
    table = torch.zeros((n * n, 36)).index_add_(
        0, segs, torch.cat([x.reshape(-1, 36) for x in (ij, ji, jj)]))
    diag = torch.arange(n) * (n + 1)
    table.index_add_(0, diag, ii.reshape(-1, 36))
    r_m = wm[:, None] * (nodes + t - mt)
    mot = torch.zeros((n, 6, 6))
    mot[:, 3:, 3:] = torch.eye(3) * (wm**2)[:, None, None]
    table.index_add_(0, diag, mot.reshape(-1, 36))
    rng = np.random.RandomState(2)
    M0 = torch.from_numpy(rng.rand(6 * n, 6 * n).astype(np.float32))
    b0 = torch.from_numpy(rng.rand(6 * n).astype(np.float32))
    M_ref = M0 + table.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(
        6 * n, 6 * n)
    b_nodes = torch.zeros((n, 6)).index_add_(
        0, el.reshape(-1), b_j.reshape(-1, 6)) + b_i
    b_nodes[:, 3:] += wm[:, None] * r_m
    b_ref = b0 + b_nodes.reshape(-1)
    M, b, sq = M0.clone(), b0.clone(), torch.tensor(0.5)
    arap_term_accumulate_torch(nodes, R, t, e, wa, wm, mt, M, b, sq)
    np.testing.assert_allclose(M.numpy(), M_ref.numpy(),
                               atol=1e-6 * float(M_ref.abs().max()))
    np.testing.assert_allclose(b.numpy(), b_ref.numpy(),
                               atol=1e-6 * float(b_ref.abs().max()))
    np.testing.assert_allclose(
        float(sq), 0.5 + float(rsq.sum() + (r_m * r_m).sum()), rtol=1e-6)


def test_front_door_uses_twin_on_cpu():
    args = _accumulate_inputs(5)
    (M1, b1, s1), (M2, b2, s2) = _system(40), _system(40)
    arap_term_accumulate(*args, M1, b1, s1)
    arap_term_accumulate_torch(*args, M2, b2, s2)
    assert all(np.array_equal(u.numpy(), v.numpy())
               for u, v in zip((M1, b1, s1), (M2, b2, s2)))


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        arap_term_accumulate_cuda(*_accumulate_inputs(5), *_system(40))


def test_solver_sends_arap_term_through_the_dispatcher(monkeypatch):
    """Every GN iteration adds the point term through
    ``point_term_accumulate`` and the ARAP term through
    ``arap_term_accumulate``, the functions that launch K3' and K4' on
    CUDA tensors, never through the twins directly."""
    calls = []

    def counted(name, fn):
        def call(*args):
            calls.append((name, args[0].device.type))
            return fn(*args)
        return call

    monkeypatch.setattr(GND, "point_term_accumulate",
                        counted("point", GND.point_term_accumulate))
    monkeypatch.setattr(GND, "arap_term_accumulate",
                        counted("arap", GND.arap_term_accumulate))
    problem = gn_problem_to_torch(_problem_with_invalid_edges(4))
    R, t = random_pose_field(problem.nodes.shape[0], 4)
    res = GND.solve_dense(problem, GNConfig(iters=3), tt(R), tt(t))
    assert calls == [("point", "cpu"), ("arap", "cpu")] * 3
    assert bool(res.valid)
