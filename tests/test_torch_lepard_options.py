"""The matcher's options in the port against the JAX package on the CPU:
models/lepard.py's ``motion_coherence_filter`` on the six cases of
tests/test_lepard.py's TestMotionCoherenceFilter (the refined masks
equal; the sixth through ``scene_flow`` with the filter on and the
repo's checkpoints/lepard_trained.npz at the JAX suite's small pyramid)
and one more at the quorum's boundary,
``batched_encode`` (one pyramid and encoder pass over both clouds)
against the unbatched path, transformer3d.py's ``sinkhorn_confidence``,
a ``LepardNet`` built from the side-car of each of the seven matcher
checkpoints in checkpoints/ (the .json only, not the weights), and
chip_smoke.py's perception matcher at its full pyramid on the JAX
matcher's own inputs and results in JAX's perception runs
(chip_smoke.MATCHER_CASES: the anchors before and after the filter and
the blend mask exactly).

Tolerances: the masks and the matches exactly; the batched features to
1e-5 of their scale, as tests/test_torch_lepard.py:186 holds the
encoder to JAX (the same sums in another order), the batched pyramid
exactly; the flows to 1e-5 m; Sinkhorn to 1e-6."""

import glob
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke as CS
from occlusionfusion_tpu.models import lepard as LJ
from occlusionfusion_tpu.models import transformer3d as TJ
from occlusionfusion_tpu.models.checkpoint import (
    load_lepard_checkpoint as load_lepard_checkpoint_jax,
)
from occlusionfusion_tpu_torch.models import kpconv as K
from occlusionfusion_tpu_torch.models import lepard as L
from occlusionfusion_tpu_torch.models import transformer3d as TR
from occlusionfusion_tpu_torch.models.checkpoint import (
    LEPARD_NPZ,
    lepard_config_from_json,
    load_lepard_checkpoint,
)
from test_torch_lepard import clouds, small
from torch_port_impl import one_torch_thread, tt  # noqa: F401


def grid(n=6, spacing=0.05):
    xs = np.arange(n) * spacing
    g = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    return np.concatenate([g, np.zeros((g.shape[0], 1))], -1).astype(
        np.float32)


def coherence_case(name):
    """(points, flows, valid, filter kwargs) of each JAX test case."""
    pts = grid()
    flows = np.tile([0.02, 0.0, 0.0], (pts.shape[0], 1)).astype(np.float32)
    valid = np.ones(pts.shape[0], bool)
    kw = dict(knn=4, tau=0.08)
    if name == "outlier":
        flows[7] = [0.0, 0.0, 0.3]
    elif name == "articulated":
        flows = np.where(pts[:, :1] < 0.14, [0.02, 0.0, 0.0],
                         [0.0, 0.03, 0.0]).astype(np.float32)
    elif name.startswith("rotation"):
        pts = grid(n=8, spacing=0.06)
        r = pts - pts.mean(0)
        flows = (0.09 * np.stack([-r[:, 1], r[:, 0], np.zeros(len(r))], -1)
                 ).astype(np.float32)
        valid = np.ones(pts.shape[0], bool)
        kw = dict(knn=4, tau=0.001,
                  mad_mult=3.0 if name == "rotation_mad" else 0.0)
    elif name == "no_quorum":
        valid = np.zeros(pts.shape[0], bool)
        valid[0] = valid[1] = True
        kw = dict(knn=4, tau=1e-6)
    elif name == "sparse_outlier":
        flows[7] = [0.0, 0.0, 0.3]
        valid = np.zeros(pts.shape[0], bool)
        valid[[7, 6, 8, 12]] = True
    elif name == "quorum_boundary":
        # two valid anchors that disagree: (knn + 1) // 2 = 2 valid slots
        # is no quorum, so both keep their validity
        flows[1] = [0.0, 0.0, 0.3]
        valid = np.zeros(pts.shape[0], bool)
        valid[[0, 1]] = True
    return pts, flows, valid, kw


# the JAX cases' own verdicts, so that a mask equal to JAX's is also right
EXPECTED = {
    "outlier": lambda out, v: not out[7] and out[np.arange(36) != 7].all(),
    "articulated": lambda out, v: out.all(),
    "rotation_mad": lambda out, v: out.all(),
    "rotation_abs": lambda out, v: not out.all(),
    "no_quorum": lambda out, v: np.array_equal(out, v),
    "sparse_outlier": lambda out, v: (not out[7]) and out[[6, 8, 12]].all(),
    "quorum_boundary": lambda out, v: np.array_equal(out, v),
}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_coherence_filter_matches_jax(name):
    pts, flows, valid, kw = coherence_case(name)
    ref = np.asarray(LJ.motion_coherence_filter(
        jnp.asarray(pts), jnp.asarray(flows), jnp.asarray(valid), **kw))
    got = L.motion_coherence_filter(tt(pts), tt(flows), tt(valid),
                                    **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert EXPECTED[name](got, valid)


def test_masked_median_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(50, 7).astype(np.float32)
    mask = rng.rand(50, 7) > 0.4
    mask[0] = False  # no valid slot: 0
    ref = np.asarray(LJ._masked_median(jnp.asarray(x), jnp.asarray(mask), 1))
    got = L._masked_median(tt(x), tt(mask), 1).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def nets():
    """(JAX params, JAX small config with the filter on, the port's small
    LepardNet with it on)."""
    params, cfg_j = load_lepard_checkpoint_jax(LEPARD_NPZ)
    _, cfg = load_lepard_checkpoint(device="cpu")
    on = dict(coherence_tau=0.06)
    net, _ = load_lepard_checkpoint(device="cpu",
                                    config=small(cfg)._replace(**on))
    return params, small(cfg_j)._replace(**on), net


def test_scene_flow_with_coherence_filter_matches_jax(nets):
    """The sixth case: the filter wired into scene_flow, which returns the
    refined match_valid, and the flow blended from what it keeps equals
    JAX's."""
    params, cfg_j, net = nets
    src, sv, tgt, tv = clouds(4)
    flow_j, mask_j, m_j = jax.jit(
        lambda *a: LJ.scene_flow(params, cfg_j, *a)
    )(*(jnp.asarray(x) for x in (src, sv, tgt, tv)))
    with torch.no_grad():
        flow, mask, m = L.scene_flow(net, *(tt(x) for x in (src, sv, tgt,
                                                             tv)))
    np.testing.assert_array_equal(m.match_valid.numpy(),
                                  np.asarray(m_j.match_valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(flow.numpy(), np.asarray(flow_j), atol=1e-5)
    assert m.match_valid.sum() > 5 and mask.sum() > 500


def test_coherence_filter_drops_matches_in_scene_flow(nets):
    """Against the same net with the filter off, scene_flow's refined
    match_valid is a strict subset on these clouds."""
    _, _, net = nets
    src, sv, tgt, tv = (tt(x) for x in clouds(4))
    off = L.LepardNet(net.config._replace(coherence_tau=0.0))
    off.load_state_dict(net.state_dict())
    with torch.no_grad():
        _, _, m_on = L.scene_flow(net.eval(), src, sv, tgt, tv)
        _, _, m_off = L.scene_flow(off.eval(), src, sv, tgt, tv)
    on, all_ = m_on.match_valid.numpy(), m_off.match_valid.numpy()
    assert (on <= all_).all() and on.sum() < all_.sum()


def test_batched_pyramid_equals_one_per_cloud(nets):
    _, _, net = nets
    pyr = net.config.kpfcn.pyramid
    src, sv, tgt, tv = clouds(5)
    s0 = K.grid_subsample(tt(src), tt(sv), pyr.first_voxel,
                          pyr.level_sizes[0])
    t0 = K.grid_subsample(tt(tgt), tt(tv), pyr.first_voxel,
                          pyr.level_sizes[0])
    both = K.build_pyramid_from_level0(torch.stack([s0[0], t0[0]]),
                                       torch.stack([s0[1], t0[1]]), pyr)
    for b, (p, v) in enumerate((s0, t0)):
        alone = K.build_pyramid_from_level0(p, v, pyr)
        for lb, la in zip(both, alone):
            for x, y in zip(lb, la):
                if y is not None:
                    np.testing.assert_array_equal(x[b].numpy(), y.numpy())


def test_batched_encode_matches_unbatched(nets):
    _, _, net = nets
    batched = L.LepardNet(net.config._replace(batched_encode=True))
    batched.load_state_dict(net.state_dict())
    batched.eval()
    src, sv, tgt, tv = (tt(x) for x in clouds(5))
    with torch.no_grad():
        one = L._encode_pair(net, src, sv, tgt, tv)
        two = L._encode_pair(batched, src, sv, tgt, tv)
        flow_a, mask_a, m_a = L.scene_flow(net, src, sv, tgt, tv)
        flow_b, mask_b, m_b = L.scene_flow(batched, src, sv, tgt, tv)
    for (fa, pa, va), (fb, pb, vb) in zip(one, two):
        assert fb.shape == fa.shape
        np.testing.assert_array_equal(pb.numpy(), pa.numpy())
        np.testing.assert_array_equal(vb.numpy(), va.numpy())
        np.testing.assert_allclose(fb.numpy(), fa.numpy(),
                                   atol=1e-5 * float(fa.abs().max()))
    np.testing.assert_array_equal(m_b.match_valid.numpy(),
                                  m_a.match_valid.numpy())
    np.testing.assert_array_equal(mask_b.numpy(), mask_a.numpy())
    np.testing.assert_allclose(flow_b.numpy(), flow_a.numpy(), atol=1e-5)
    assert m_a.match_valid.sum() > 5


@pytest.mark.parametrize("dustbin", [None, 0.0, -1.5])
def test_sinkhorn_confidence_matches_jax(dustbin):
    rng = np.random.RandomState(11)
    fs = rng.randn(24, 32).astype(np.float32)
    ft = rng.randn(20, 32).astype(np.float32)
    vs, vt = np.arange(24) < 21, np.arange(20) < 17
    ref = np.asarray(TJ.sinkhorn_confidence(
        *(jnp.asarray(x) for x in (fs, ft, vs, vt)), iters=5,
        dustbin_score=dustbin))
    got = TR.sinkhorn_confidence(*(tt(x) for x in (fs, ft, vs, vt)), iters=5,
                                 dustbin_score=dustbin).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got[~vs].max() == 0.0 and got[:, ~vt].max() == 0.0


def test_sinkhorn_dustbin_absorbs_unmatched():
    """tests/test_lepard.py's TestSinkhornDustbin case on the port."""
    P = TR.sinkhorn_confidence(torch.eye(3, 8) * 10, torch.eye(2, 8) * 10,
                               torch.ones(3, dtype=torch.bool),
                               torch.ones(2, dtype=torch.bool), iters=20,
                               dustbin_score=0.0).numpy()
    assert P[0, 0] > 0.5 and P[1, 1] > 0.5 and P[2].sum() < 0.5


SIDE_CARS = sorted(glob.glob(os.path.join(os.path.dirname(LEPARD_NPZ),
                                          "lepard*.npz.json")))


def test_seven_matcher_side_cars():
    assert len(SIDE_CARS) == 7
    assert sum(json.load(open(p)).get("coherence_tau", 0.0) > 0
               for p in SIDE_CARS) == 4


@pytest.mark.parametrize("path", SIDE_CARS, ids=os.path.basename)
def test_lepard_net_builds_from_side_car(path):
    with open(path) as fh:
        side = json.load(fh)
    cfg = lepard_config_from_json(side)
    net = L.LepardNet(cfg)
    assert cfg.coherence_tau == side.get("coherence_tau", 0.0)
    assert cfg.batched_encode == side.get("batched_encode", False)
    assert tuple(cfg.kpfcn.pyramid.level_sizes) == tuple(
        side["kpfcn"]["pyramid"]["level_sizes"])
    # every side-car describes the weights of lepard_trained.npz's layout
    assert sum(p.numel() for p in net.parameters()) == 18_952_144


MATCHER_CASES = CS.load_matcher_cases()


@pytest.fixture(scope="module")
def perception_matchers():
    """chip_smoke's perception matcher (lepard_bridge_r5e, the coherence
    filter on) per phase (batched_encode in the stepwise phase's), each
    with the same net with the filter off."""
    out = {}
    for stepwise in (False, True):
        net = CS.perception_lepard("cpu", stepwise)
        off = L.LepardNet(net.config._replace(coherence_tau=0.0))
        off.load_state_dict(net.state_dict())
        out["perception_stepwise" if stepwise else "perception"] = (
            net, off.eval())
    return out


@pytest.mark.parametrize(
    "case", MATCHER_CASES,
    ids=[f"{c['phase']}-frame{c['frame']}" for c in MATCHER_CASES])
def test_perception_matcher_on_jax_inputs(case, perception_matchers):
    """The perception phases' matcher at its full pyramid on the JAX
    matcher's own inputs in JAX's perception runs (chip_smoke's
    MATCHER_CASES, written by scripts/torch_perception_reference.py):
    the anchors before and after the coherence filter and the blend mask
    equal to JAX's, the blended flow within 1e-5 m."""
    net, off = perception_matchers[case["phase"]]
    src, tgt = tt(case["src"]), tt(case["tgt"])
    ones = (torch.ones(len(src), dtype=torch.bool),
            torch.ones(len(tgt), dtype=torch.bool))
    with torch.no_grad():
        flow, blend, m = L.scene_flow(net, src, ones[0], tgt, ones[1])
        pre = L.scene_flow(off, src, ones[0], tgt, ones[1])[2]
    np.testing.assert_array_equal(pre.match_valid.numpy(),
                                  case["anchors_pre"])
    np.testing.assert_array_equal(m.match_valid.numpy(), case["anchors"])
    np.testing.assert_array_equal(blend.numpy(), case["blend"])
    stride = CS.MATCHER_FLOW_STRIDE
    both = case["blend"][::stride]
    np.testing.assert_allclose(flow.numpy()[::stride][both],
                               case["flow"][both], atol=1e-5)


def test_perception_matcher_cases_give_the_filter_work():
    """In JAX the coherence filter drops anchors in some of the cases,
    and the blend leaves points out in some."""
    assert len(MATCHER_CASES) == 16
    assert any(c["anchors"].sum() < c["anchors_pre"].sum()
               for c in MATCHER_CASES)
    assert all(c["anchors"].sum() > 0 for c in MATCHER_CASES)
