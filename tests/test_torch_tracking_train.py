"""The through-solver tracking trainer of the port against the JAX
package's on the CPU (one synthetic sample, checkpoints/flow.npz, GN 3
iterations): the sample's arrays, the loss and its terms, the gradient
for both nets (each leaf within 1e-4 of JAX's relative to its norm; the
JAX suite's own check is a finite difference within 3e-2), the warp
term's gradient on MaskNet (it reaches MaskNet only through M and b of
the solve: it is zero where M carries no gradient), and the autograd
Functions against plain twin autograd. One compiled JAX program."""

import jax
import numpy as np
import pytest
import torch

from occlusionfusion_tpu.models import tracking_train as JT
from occlusionfusion_tpu.models.checkpoint import normalize_indexed
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as JGN
from occlusionfusion_tpu.utils.snapshot import load_params

from occlusionfusion_tpu_torch.models import checkpoint as C
from occlusionfusion_tpu_torch.models import tracking_train as PT
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig

from torch_port_impl import jax_run_once, one_torch_thread  # noqa: F401

GRAD_TOL = 1e-4  # per leaf, relative to the leaf's norm
KW = dict(H=64, W=64, n_nodes=32, n_matches=256)


@pytest.fixture(scope="module")
def setup():
    js = JT.synthetic_tracking_sample(np.random.RandomState(0), **KW)
    tree = normalize_indexed(load_params(C.FLOW_NPZ))
    params = {"pwc": tree["pwc"], "mask": tree["mask"]}
    gn = JGN(iters=3, w_arap=1.0)

    def jax_side(p, s):
        (total, terms), g = jax.value_and_grad(
            lambda q: JT.tracking_loss(q["pwc"], q["mask"], s, gn),
            has_aux=True)(p)
        g_warp = jax.grad(lambda m: JT.tracking_loss(
            p["pwc"], m, s, gn)[1]["warp"])(p["mask"])
        return total, terms, g, g_warp

    ref = jax.tree.map(np.asarray, jax_run_once(jax_side, params, js))
    ps = PT.synthetic_tracking_sample(np.random.RandomState(0),
                                      device="cpu", **KW)
    return js, ps, ref


def test_sample_matches_jax(setup):
    js, ps, _ = setup
    for f in JT.TrackingSample._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ps, f).numpy()
        if f == "skin_weights":  # K1's twin and knn_lax: f32 rounding
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def _worst_leaf_gap(net, grads_sd):
    return max(float((p.grad - grads_sd[k]).norm() / grads_sd[k].norm())
               for k, p in net.named_parameters())


def test_loss_terms_and_gradients_match_jax(setup):
    _, ps, (total, terms, g, _) = setup
    pwc, mask = C.load_flow_nets(device="cpu")
    got, got_terms = PT.tracking_loss(pwc, mask, ps,
                                      GNConfig(iters=3, w_arap=1.0))
    got.backward()
    np.testing.assert_allclose(got.item(), total, rtol=1e-5)
    for k, v in terms.items():
        np.testing.assert_allclose(got_terms[k].item(), v, rtol=1e-5,
                                   err_msg=k)
    assert _worst_leaf_gap(pwc, C.pwc_params_from_jax(g["pwc"])) <= GRAD_TOL
    assert _worst_leaf_gap(mask, C.masknet_params_from_jax(g["mask"])) \
        <= GRAD_TOL


def test_warp_gradient_reaches_masknet_through_the_solve(setup):
    """The warp term depends on MaskNet only through the solve's point
    weights in M and b: its gradient is non-zero and JAX's."""
    _, ps, (*_, g_warp) = setup
    pwc, mask = C.load_flow_nets(device="cpu")
    warp = PT.tracking_loss(pwc, mask, ps, GNConfig(iters=3, w_arap=1.0))[1][
        "warp"]
    warp.backward()
    ref = C.masknet_params_from_jax(g_warp)
    norm = float(torch.sqrt(sum(torch.sum(p.grad**2)
                                for p in mask.parameters())))
    assert norm > 0.0
    assert _worst_leaf_gap(mask, ref) <= GRAD_TOL


def test_functions_equal_plain_twin_autograd(setup):
    """The same gradient through the autograd Functions (on the CPU their
    forward is the twin) and through the twins' own autograd."""
    import chip_smoke as CS

    _, ps, _ = setup
    pwc, mask = C.load_flow_nets(device="cpu")
    with CS.SolveTap(1, module=PT) as tap, torch.no_grad():
        PT.tracking_loss(pwc, mask, ps, GNConfig(iters=3, w_arap=1.0))
    got = CS.solve_gradients(tap.call, twin=False)
    ref = CS.solve_gradients(tap.call, twin=True)
    for a, b in zip(got, ref):
        assert float((a - b).norm() / b.norm()) <= 1e-5


def test_no_grad_solve_takes_the_in_place_branch(setup, monkeypatch):
    """Without gradients ``solve_dense`` never builds the Functions, and
    both branches give the same solve."""
    from occlusionfusion_tpu_torch.solvers import gauss_newton_dense as GND
    import chip_smoke as CS

    _, ps, _ = setup
    pwc, mask = C.load_flow_nets(device="cpu")
    with CS.SolveTap(1, module=PT) as tap, torch.no_grad():
        PT.tracking_loss(pwc, mask, ps, GNConfig(iters=3, w_arap=1.0))
    problem, config, R, t = tap.call
    calls = []
    orig = GND._assemble_differentiable
    monkeypatch.setattr(GND, "_assemble_differentiable",
                        lambda *a: calls.append(1) or orig(*a))
    with torch.no_grad():
        plain = GND.solve_dense(problem, config, R, t)
    assert not calls
    tg = problem.target_points.clone().requires_grad_()
    diff = GND.solve_dense(problem._replace(target_points=tg), config, R, t)
    assert len(calls) == config.iters
    np.testing.assert_allclose(diff.translations.detach().numpy(),
                               plain.translations.numpy(), atol=1e-6)
    np.testing.assert_allclose(diff.residual_history.detach().numpy(),
                               plain.residual_history.numpy(), rtol=1e-5)
