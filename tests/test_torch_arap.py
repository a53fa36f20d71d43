"""Port of the GN ARAP edge term (kernel K4, ops/gn_assembly.py) and the
block assembly that runs it against the JAX package.

* The K4 twin against the XLA ARAP branch of the JAX ``_assemble_blocks``
  (5e-5 relative, the JAX suite's tolerance between its twins) and
  against the TPU kernel ``arap_term_blocks_pallas`` itself, run in
  interpret mode as tests/test_gn_assembly.py runs it, at a tolerance
  derived from the kernel's bf16 hi/lo gather (below).
* The port's ``_assemble_blocks`` (the JAX ``blocks_pallas_full``: K3
  and K4, here their twins) against the JAX
  ``_assemble_blocks(assembly="blocks")`` with fractional point
  weights and invalid edges, 5e-5 relative (the JAX side runs "blocks",
  not the TPU point-term kernel, because of ROADMAP fault F1)."""

import numpy as np
import pytest
import jax.numpy as jnp

from occlusionfusion_tpu.ops import gn_assembly as GAJ
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.gauss_newton_dense import (
    _assemble_blocks as assemble_blocks_jax,
)
from occlusionfusion_tpu_torch.ops.gn_assembly import (
    arap_term_blocks,
    arap_term_blocks_cuda,
    arap_term_blocks_torch,
)
from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.gauss_newton_dense import (
    _assemble_blocks,
)
from test_gauss_newton import build_problem
from torch_port_impl import gn_problem_to_torch, random_pose_field, tt

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


def test_front_door_uses_twin_on_cpu():
    args = [tt(x) for x in _arap_inputs(5, n=40)]
    for a, b in zip(arap_term_blocks(*args), arap_term_blocks_torch(*args)):
        assert np.array_equal(a.numpy(), b.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        arap_term_blocks_cuda(*(tt(x) for x in _arap_inputs(5, n=40)))


def test_solver_sends_arap_term_through_the_dispatcher(monkeypatch):
    """Every GN iteration assembles the ARAP term through
    ``arap_term_blocks``, the function that launches K4 on CUDA tensors,
    never through the twin directly."""
    calls = []

    def counted(*args):
        calls.append(args[0].device.type)
        return arap_term_blocks(*args)

    monkeypatch.setattr(GND, "arap_term_blocks", counted)
    problem = gn_problem_to_torch(_problem_with_invalid_edges(4))
    R, t = random_pose_field(problem.nodes.shape[0], 4)
    res = GND.solve_dense(problem, GNConfig(iters=3), tt(R), tt(t))
    assert calls == ["cpu"] * 3 and bool(res.valid)
