"""Port of the motion-completion net and its runner step against the JAX
package, with the repo's pretrained checkpoint (checkpoints/
motion_complete.npz) loaded through params_from_jax. Tolerance: the
GNN's documented cross-backend drift, <= 0.35 mm motion and <= 0.015
confidence; single layers are held tighter."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from occlusionfusion_tpu.fusion import motion_runner as MRJ
from occlusionfusion_tpu.models import motion_complete as MCJ
from occlusionfusion_tpu.models.checkpoint import load_motion_complete_params
from occlusionfusion_tpu_torch.fusion import motion_runner as MR
from occlusionfusion_tpu_torch.models import motion_complete as MC
from occlusionfusion_tpu_torch.models.checkpoint import (
    load_motion_complete_net,
    params_from_jax,
)
from torch_port_impl import one_torch_thread, tt  # noqa: F401

N0 = 128
LEVELS = MR.level_sizes_for(N0)
MOTION_TOL = 3.5e-4  # metres
CONF_TOL = 0.015


@pytest.fixture(scope="module")
def nets():
    params = load_motion_complete_params()
    net = MC.MotionCompleteNet()
    net.load_state_dict(params_from_jax(params))
    return jnp_tree(params), net.eval()


def jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: jnp_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _pyramid_lists(n, seed):
    """A synthetic 4-level pyramid with n real level-0 nodes."""
    rng = np.random.RandomState(seed)
    sizes = [n, max(n // 4, 2), max(n // 12, 2), max(n // 20, 2)]
    nn = [rng.randint(0, s, size=(s, k)).astype(np.int16)
          for s, k in zip(sizes, MR.LEVEL_KS)]
    nn[0][0, -1] = -1  # one missing neighbour
    down = [rng.choice(sizes[i], sizes[i + 1], replace=False).astype(np.int16)
            for i in range(3)]
    up = [rng.randint(0, sizes[i + 1], size=sizes[i]).astype(np.int16)
          for i in range(3)]
    return nn, down, up


def _packed(n, seed):
    nn, down, up = _pyramid_lists(n, seed)
    dummy = np.zeros((n, 3), np.float32)
    ints_t, _ = MR.pack_frame(dummy, dummy, np.zeros(n, bool), nn, down, up,
                              level_sizes=LEVELS)
    ints_j, _ = MRJ.pack_frame(dummy, dummy, np.zeros(n, bool), nn, down, up,
                               level_sizes=LEVELS)
    np.testing.assert_array_equal(ints_t, ints_j)
    return (MRJ._unpack_pyramid(jnp.asarray(ints_j), LEVELS),
            MR._unpack_pyramid(tt(ints_t), LEVELS))


def test_params_from_jax_covers_the_checkpoint(nets):
    params, net = nets
    sd = net.state_dict()
    flat = params_from_jax(load_motion_complete_params())
    assert set(sd) == set(flat) and len(sd) == 164
    for k, v in flat.items():
        assert torch.equal(sd[k], v)


def test_transformer_conv_matches_jax(nets):
    params, net = nets
    _, pyr = _packed(100, seed=1)
    pyr_j, _ = _packed(100, seed=1)
    x = np.random.RandomState(2).randn(N0, 32).astype(np.float32)
    ref = MCJ.transformer_conv(params["conv0"], jnp.asarray(x),
                               pyr_j.edge_src[0], pyr_j.edge_dst[0],
                               pyr_j.edge_mask[0], N0)
    with torch.no_grad():
        got = MC.transformer_conv(net.conv0, tt(x), pyr.edge_src[0],
                                  pyr.edge_dst[0], pyr.edge_mask[0], N0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_lstm_matches_jax(nets):
    params, net = nets
    seq = np.random.RandomState(3).randn(16, 50, 4).astype(np.float32)
    ref = MCJ.lstm_forward(params["seq_encoder"], jnp.asarray(seq))
    with torch.no_grad():
        got = MC.lstm_forward(net.seq_encoder, tt(seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("history_len", [1, 9, 16])
def test_forward_matches_jax(nets, history_len):
    params, net = nets
    pyr_j, pyr = _packed(110, seed=4)
    rng = np.random.RandomState(history_len)
    pos = (rng.randn(N0, 3) * 0.2).astype(np.float32)
    mot = np.concatenate([rng.randn(N0, 3), rng.rand(N0, 1) > 0.3],
                         -1).astype(np.float32)
    hist = (rng.randn(16, N0, 4) * 0.5).astype(np.float32)
    ref = MCJ.motion_complete_forward(
        params, jnp.asarray(pos), jnp.asarray(mot), jnp.asarray(hist),
        jnp.int32(history_len), pyr_j,
    )
    with torch.no_grad():
        got = MC.motion_complete_forward(
            net, tt(pos), tt(mot), tt(hist),
            torch.tensor(history_len, dtype=torch.int32), pyr,
        )
    assert got.shape == (N0, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_motion_step_sequence_matches_jax(nets):
    """Four frames through motion_step, state carried: world motion within
    0.35 mm, confidence within 0.015, every frame."""
    params, net = nets
    n = 100
    pyr_j, pyr = _packed(n, seed=5)
    st_j = MRJ.init_state(N0)
    st_t = MR.init_state(N0, "cpu")
    rng = np.random.RandomState(6)
    pos = np.zeros((N0, 3), np.float32)
    pos[:n] = rng.randn(n, 3) * 0.1
    for _ in range(4):
        motion = np.zeros((N0, 3), np.float32)
        motion[:n] = rng.randn(n, 3) * 0.004 + np.array([0, 0, 0.004])
        vis = np.zeros(N0, bool)
        vis[:n] = rng.rand(n) > 0.3
        st_j, (m_j, c_j) = MRJ.motion_step(
            params, st_j, jnp.asarray(pos), jnp.asarray(motion),
            jnp.asarray(vis), jnp.int32(n), pyr_j, n0_cap=N0,
        )
        with torch.no_grad():
            st_t, (m_t, c_t) = MR.motion_step(
                net, st_t, tt(pos), tt(motion), tt(vis),
                torch.tensor(n, dtype=torch.int32), pyr, n0_cap=N0,
            )
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j),
                                   atol=MOTION_TOL)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j),
                                   atol=CONF_TOL)
        assert int(st_t.history_len) == int(st_j.history_len)
        pos = pos + motion


def test_load_motion_complete_net_on_cpu():
    net = load_motion_complete_net(device="cpu")
    assert next(net.parameters()).device.type == "cpu"
